// K5a: the conv -> conv stack on the CHWN engine, in one kernel.
//
// Replaces repro/kernels/conv/stack.py::conv_stack_chwn_pallas (body
// _stack_chwn_kernel): conv1 [+bias1] [+ReLU] -> conv2 with the full
// bias/residual/ReLU/max-avg-pool epilogue, the mid activation kept in
// shared memory and never written to device memory.  x is [Ci,H,W,N] or
// [N,Ci,H,W]; w1 is [Ci,F1,F1,Cm], w2 [Cm,F2,F2,Co]; y is [Co,Ho',Wo',N] or
// [N,Co,Ho',Wo'] (Ho', Wo' after the pool); the residual is read in its own
// layout, before the ReLU.  fp32 FMA on the CUDA cores (no TF32).
//
// Storage dtypes (csrc/storage.cuh): x, w1, w2, the biases, the residual
// and y all float32 or all bf16.  A bf16 operand is widened to float32 on
// its way into shared memory (a register load instead of cp.async); the
// mid activation stays float32 (it never leaves the SM, so it is never
// rounded to the storage type, as in the reference's kernel), and y is
// rounded once where it is stored.
//
// What bounds it on an H100: operations.  At AlexNet's conv3 -> conv4
// (N = 128, 256 -> 384 -> 384, 13x13) both convs are far above the fp32
// ridge, so the bound is the CUDA cores' fp32 FMA rate, 67 TFLOP/s.  What
// the kernel can lose is work executed beyond the two convs' own FLOPs:
// conv1 recomputed on each tile's halo, and once per slice of Co.
//
// Design: a thread-block cluster shares one conv1.  The blocks of a
// cluster (CL of them along gridDim.y, CL <= 8, CL * bm >= Co where one
// cluster covers Co) own the same spatial tile (nb images x uth x utw units,
// make_tile in conv_stack_common.cuh) and each a bm-wide slice of Co.  The
// reduction over conv2's K2 = Cm*F2*F2 runs in chunks of kCM mid channels:
//
//   phase A: the chunk's mid slab over the tile's mid box (tile plus halo,
//     clipped to the real mid extent) is split by box positions into CL
//     ranges of whole 64-position passes (the last rank takes the rest);
//     each rank computes its range, an implicit GEMM over K1 = Ci*F1*F1 in
//     passes of [kCM x 128] positions (4 x 8 outputs a thread) and one of
//     [kCM x 64] (4 x 4) where no more than 64 remain, applies bias1 and
//     ReLU, and stores it into its own shared memory;
//   cluster barrier; each rank copies the other ranks' ranges into its own
//     slab through distributed shared memory (map_shared_rank), once per
//     chunk, then arrives on the cluster barrier;
//   phase B: the chunk's (cm, dy, dx) terms of conv2 are gathered from the
//     local slab into shared-memory GEMM tiles and accumulated into the
//     block's bm x bn register tile (8 x 8 a thread);
//   the cluster wait that matches that arrival comes before the next
//     chunk's phase A writes the slab, so phase B overlaps the other ranks'
//     copies and each chunk costs one blocking cluster barrier.
//
// Conv1 so runs once per spatial tile instead of once per Co slice, and a
// block's bn columns (bm * bn = 16384) cover a wider tile than a block that
// also had to hold all of Co.  Weight slices (w1, w2) and, where n is
// contiguous (CHWN input, N and nb multiples of 4), the x gather are staged
// by 16-byte cp.async (4-byte elsewhere, zero-filled off the edges) into a
// double-buffered ring of kBK-deep slices: one __syncthreads a slice.  A
// block whose Co slice is empty still computes its phase-A share and meets
// every cluster barrier.  The wrapper picks the tile (bm, nb, uth, utw)
// that minimises the executed work per wave of resident clusters
// (ops.py::stack_tiling, which counts the FLOPs this kernel executes; with
// ``stats`` the kernel counts them itself).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/nan_max.cuh"
#include "../../csrc/storage.cuh"
#include "conv_stack_common.cuh"  // StackArgs, Tile, make_tile

namespace repro {
namespace stack_cluster {

namespace cg = cooperative_groups;
using stack::StackArgs;
using stack::Tile;
using storage::copy1;
using storage::copy4;
using storage::ld;
using storage::put;

constexpr int kThreads = 256;
constexpr int kBK = 16;     // reduction slice of both phases
constexpr int kCM = 64;     // mid channels per chunk
constexpr int kTile = 16384;  // bm * bn
constexpr int kPassMax = 128;  // mid positions of the widest conv1 pass
constexpr int kMaxSmem = 232448;  // 227 KB, what an H100 block may use

template <typename E>
struct ClusterArgs {
  StackArgs<E> s;
  int CL;                      // blocks per cluster, along gridDim.y
  int vec_x, vec_w1, vec_w2;   // 16-byte copies: rows 4-aligned
  unsigned long long* stats;   // [executed FLOPs, cluster size] or null
};

// (c, dy, dx) of a reduction index k = (c, dy, dx) over c*F*F
// GEMM column c of the block's conv2 tile: its unit and the conv2 output
// its tap is (columns run n fastest, then the unit column, the unit row,
// the pool tap)
struct SCol {
  int n, nl, uh, uw, oh, ow;
  bool ok;
};

template <typename A>
__device__ __forceinline__ SCol scol(const A& a, const Tile& t, int c) {
  SCol s;
  const int tap = c / a.BU, ul = c - tap * a.BU;
  s.nl = ul % a.NB;
  const int q = ul / a.NB;
  const int uwl = q % a.UTW, uhl = q / a.UTW;
  s.ok = tap < a.T && s.nl < t.NBc && uhl < t.UTHc && uwl < t.UTWc;
  s.n = t.n0 + s.nl;
  s.uh = t.uh0 + uhl;
  s.uw = t.uw0 + uwl;
  if (a.pF > 0) {
    const int tt = s.ok ? tap : 0;
    s.oh = s.uh * a.pS + tt / a.pF;
    s.ow = s.uw * a.pS + tt % a.pF;
  } else {
    s.oh = s.uh;
    s.ow = s.uw;
  }
  return s;
}

struct KIdx {
  int c, dy, dx;
};

__device__ __forceinline__ KIdx kidx(int k, int F) {
  KIdx r;
  const int FF = F * F;
  r.c = k / FF;
  const int q = k - r.c * FF;
  r.dy = q / F;
  r.dx = q - r.dy * F;
  return r;
}

// s += d, both as (c, dy, dx) with dy, dx < F
__device__ __forceinline__ void kadvance(KIdx& s, const KIdx& d, int F) {
  s.dx += d.dx;
  if (s.dx >= F) {
    s.dx -= F;
    ++s.dy;
  }
  s.dy += d.dy;
  if (s.dy >= F) {
    s.dy -= F;
    ++s.c;
  }
  s.c += d.c;
}

__device__ __forceinline__ void kstep(KIdx& s, int F) {
  if (++s.dx == F) {
    s.dx = 0;
    if (++s.dy == F) {
      s.dy = 0;
      ++s.c;
    }
  }
}

// copy4 / copy1 (storage.cuh): 16- or 4-byte cp.async for float32, a
// widening register load for bf16; ok == false zero-fills dst
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int GM>
struct CShape {
  static constexpr int GN = 4 / GM;
  static constexpr int TBM = 64 * GM, TBN = 64 * GN;
  static constexpr int ASTR1 = kCM + 4;   // phase-A weight row stride
  static constexpr int ASTR = TBM + 4;    // phase-B weight row stride
  static constexpr int RING_A = 2 * kBK * (ASTR1 + kPassMax);
  static constexpr int RING_B = 2 * kBK * (ASTR + TBN);
  static constexpr int RING = RING_A > RING_B ? RING_A : RING_B;
};

// One conv1 pass of K5a's phase A: the [kCM x KRA] implicit GEMM of mid
// positions [p0, p0 + KRA) (clipped to this rank's range [p_lo, p_hi))
// over K1, 4 x PW outputs a thread (PW 4 or 8: positions tx * 4 + j of
// each 64-wide group), bias1 and ReLU, into the slab.
template <int PW, typename E>
__device__ __forceinline__ void conv1_pass(
    const ClusterArgs<E>& p, const Tile& t, float* As1, float* Bs1,
    float* mid, int p0, int p_lo, int p_hi, int cm0, int cmn,
    const KIdx& dk1, int tid, int tx, int ty) {
  constexpr int KRA = 16 * PW;
  constexpr int ASTR1 = kCM + 4;
  const StackArgs<E>& a = p.s;
  const int nsl1 = (a.K1 + kBK - 1) / kBK;
  // x: vec, 4-position quads (rows kx0 + i * XR of the slice, quad qx,
  // one position a thread); else the scalar elements (kk, tid % KRA),
  // kk = tid / KRA + i * (kThreads / KRA)
  constexpr int XQ = KRA / 4, XR = kThreads / XQ;
  constexpr int XI = (kBK + XR - 1) / XR;  // quads a thread
  const int kx0 = tid / XQ, qx = tid % XQ;
  const int pp = p.vec_x ? p0 + 4 * qx : p0 + tid % KRA;
  int nl, mhl, mwl;
  {
    const int rr = pp < p_hi ? pp : p_lo;
    nl = rr % t.NBc;
    const int q = rr / t.NBc;
    mwl = q % t.MWc;
    mhl = q / t.MWc;
  }
  const bool pok = pp < p_hi;
  const E* xcol = a.x + (long long)(t.n0 + nl) * a.xs.n;
  const int ih0 = (t.mh_lo + mhl) * a.S1 - a.P1;
  const int iw0 = (t.mw_lo + mwl) * a.S1 - a.P1;
  KIdx xk[XI];  // vec path: k = s * kBK + kx0 + i * XR
#pragma unroll
  for (int i = 0; i < XI; ++i) xk[i] = kidx(kx0 + i * XR, a.F1);
  auto issue = [&](int s, int buf) {
    const int k0 = s * kBK;
    float* as = As1 + buf * kBK * ASTR1;
    float* bs = Bs1 + buf * kBK * KRA;
    if (p.vec_w1) {  // kBK x kCM / 4 quads
#pragma unroll
      for (int i = 0; i < kBK * kCM / 4 / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int kk = e / (kCM / 4), m4 = (e % (kCM / 4)) * 4;
        const int k = k0 + kk;
        const bool ok = k < a.K1 && m4 < cmn;
        copy4(as + kk * ASTR1 + m4,
              ok ? a.w1 + (long long)k * a.w1K + cm0 + m4 : a.w1, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK * kCM / kThreads; ++i) {
        const int e = tid + i * kThreads, kk = e / kCM, m = e % kCM;
        const int k = k0 + kk;
        const bool ok = k < a.K1 && m < cmn;
        copy1(as + kk * ASTR1 + m,
              ok ? a.w1 + (long long)k * a.w1K + cm0 + m : a.w1, ok);
      }
    }
    if (p.vec_x) {
#pragma unroll
      for (int i = 0; i < XI; ++i) {
        const int kx = kx0 + i * XR;
        if (kx < kBK) {
          const int h = ih0 + xk[i].dy, w = iw0 + xk[i].dx;
          const bool ok = pok && k0 + kx < a.K1 && h >= 0 && h < a.H &&
                          w >= 0 && w < a.W;
          copy4(bs + kx * KRA + 4 * qx,
                ok ? xcol + xk[i].c * a.xs.c + h * a.xs.h + w * a.xs.w
                   : a.x,
                ok);
          kadvance(xk[i], dk1, a.F1);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK * KRA / kThreads; ++i) {
        const int kk = tid / KRA + i * (kThreads / KRA);
        const int k = k0 + kk;
        const KIdx q = kidx(k, a.F1);
        const int h = ih0 + q.dy, w = iw0 + q.dx;
        const bool ok = pok && k < a.K1 && h >= 0 && h < a.H && w >= 0 &&
                        w < a.W;
        copy1(bs + kk * KRA + tid % KRA,
              ok ? xcol + q.c * a.xs.c + h * a.xs.h + w * a.xs.w : a.x,
              ok);
      }
    }
  };

  float acc1[4][PW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PW; ++j) acc1[i][j] = 0.f;
  issue(0, 0);
  cp_commit();
  for (int s = 0; s < nsl1; ++s) {
    const int buf = s & 1;
    cp_wait_all();
    __syncthreads();  // slice s has landed; slice s-1 is consumed
    if (s + 1 < nsl1) {
      issue(s + 1, buf ^ 1);
      cp_commit();
    }
    const float* as = As1 + buf * kBK * ASTR1;
    const float* bs = Bs1 + buf * kBK * KRA;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av =
          *reinterpret_cast<const float4*>(as + kk * ASTR1 + ty * 4);
      float bv[PW];
#pragma unroll
      for (int g = 0; g < PW / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + kk * KRA + g * 64 + tx * 4);
        bv[4 * g] = v.x;
        bv[4 * g + 1] = v.y;
        bv[4 * g + 2] = v.z;
        bv[4 * g + 3] = v.w;
      }
      const float avv[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PW; ++j)
          acc1[i][j] = fmaf(avv[i], bv[j], acc1[i][j]);
    }
  }
    // conv1's epilogue: bias, ReLU, into my range of the slab
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cml = ty * 4 + i;
    if (cml >= cmn) continue;
    const float b = a.b1 ? ld(a.b1 + cm0 + cml) : 0.f;
#pragma unroll
    for (int j = 0; j < PW; ++j) {
      const int r = p0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (r >= p_hi) continue;
      float v = acc1[i][j] + b;
      if (a.relu1) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
      mid[cml * a.RSTR + r] = v;
    }
  }
  __syncthreads();  // the next pass refills the ring
}

template <typename E, bool POOL, int GM>
__global__ void __launch_bounds__(kThreads, 1)
cluster_stack_kernel(const ClusterArgs<E> p) {
  using S = CShape<GM>;
  constexpr int GN = S::GN, TBM = S::TBM, TBN = S::TBN;
  constexpr int ASTR1 = S::ASTR1, ASTR = S::ASTR;
  constexpr int RPT_B = kBK * TBN / kThreads;  // slab values a thread, B
  const StackArgs<E>& a = p.s;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;            // phase A: As1[2][kBK][ASTR1], Bs1[2][kBK][<=128]
                                 // phase B: As[2][kBK][ASTR], Bs[2][kBK][TBN]
  float* mid = smem + S::RING;   // [kCM][RSTR] slab; later the pool tile
  float* As1 = ring;
  float* Bs1 = ring + 2 * kBK * ASTR1;
  float* As = ring;
  float* Bs = ring + 2 * kBK * ASTR;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = p.CL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp is 4 rows x 8 columns of threads: its float4 operand loads
  // touch 4 and 8 distinct 16-byte words
  const int ty = (warp & 3) * 4 + (lane >> 3);
  const int tx = (warp >> 2) * 8 + (lane & 7);
  const Tile t = stack::make_tile(a);
  // the mid slab's positions run n fastest: r = nl + NBc * (mwl + MWc * mhl)
  const int rs_w = t.NBc, rs_h = t.NBc * t.MWc;
  const int co0 = blockIdx.y * TBM;

  // phase A: this rank's range [p_lo, p_hi) of the tile's mid positions,
  // whole 64-position passes but the last rank's
  const int RR = (((t.RA + CL - 1) / CL) + 63) & ~63;
  const int p_lo = min(t.RA, rank * RR), p_hi = min(t.RA, p_lo + RR);
  // phase B: the conv2 column this thread gathers, and its slab base
  const int cB = tid % TBN, kkB0 = (tid / TBN) * RPT_B;
  const SCol gb = scol(a, t, cB);
  const int ohb = gb.oh * a.S2 - a.P2, owb = gb.ow * a.S2 - a.P2;
  const int rbase = gb.nl + (ohb - t.mh_lo) * rs_h + (owb - t.mw_lo) * rs_w;

  const KIdx dk1 = kidx(kBK, a.F1), dk2 = kidx(kBK, a.F2);
  const int F2sq = a.F2 * a.F2;
  const int nsl1 = (a.K1 + kBK - 1) / kBK;
  unsigned long long fma_count = 0;

  float acc[4 * GM][4 * GN];
#pragma unroll
  for (int i = 0; i < 4 * GM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * GN; ++j) acc[i][j] = 0.f;

  for (int cm0 = 0; cm0 < a.Cm; cm0 += kCM) {
    const int cmn = min(kCM, a.Cm - cm0);
    __syncthreads();  // local phase B is done with the ring and the slab
    if (cm0 > 0) cluster_wait();  // and the other ranks with my share

    // ---- phase A: my share of conv1 -> mid slab (cm0 .. cm0+cmn) --------
    // passes of 128 positions, and one of 64 where no more than 64 remain
    for (int p0 = p_lo; p0 < p_hi;) {
      if (p_hi - p0 > 64) {
        conv1_pass<8>(p, t, As1, Bs1, mid, p0, p_lo, p_hi, cm0, cmn, dk1, tid,
                      tx, ty);
        fma_count += (unsigned long long)kCM * 128 * nsl1 * kBK;
        p0 += 128;
      } else {
        conv1_pass<4>(p, t, As1, Bs1, mid, p0, p_lo, p_hi, cm0, cmn, dk1, tid,
                      tx, ty);
        fma_count += (unsigned long long)kCM * 64 * nsl1 * kBK;
        p0 += 64;
      }
    }

    // ---- the other ranks' shares, through distributed shared memory -----
    cluster.sync();  // every rank's share of this chunk is in its slab
    for (int q = 0; q < CL; ++q) {
      if (q == rank) continue;
      const int lo = min(t.RA, q * RR), hi = min(t.RA, lo + RR);
      const float* rem = cluster.map_shared_rank(mid, q);
      if (((lo | hi) & 3) == 0) {
        const int nq = (hi - lo) / 4;
        for (int e = tid; e < cmn * nq; e += kThreads) {
          const int c = e / nq, j = lo + 4 * (e - c * nq);
          *reinterpret_cast<float4*>(mid + c * a.RSTR + j) =
              *reinterpret_cast<const float4*>(rem + c * a.RSTR + j);
        }
      } else {
        const int n = hi - lo;
        for (int e = tid; e < cmn * n; e += kThreads) {
          const int c = e / n, j = lo + (e - c * n);
          mid[c * a.RSTR + j] = rem[c * a.RSTR + j];
        }
      }
    }
    cluster_arrive();  // done reading the other ranks' slabs
    __syncthreads();   // the whole slab is here

    // ---- phase B: conv2's (cm, dy, dx) terms of this chunk --------------
    const int K2c = cmn * F2sq;
    const long long k2base = (long long)cm0 * F2sq;
    const int nsl2 = (K2c + kBK - 1) / kBK;
    KIdx gk = kidx(kkB0, a.F2);  // (cm, dy, dx) of this thread's first row
    float rb[RPT_B];
    auto gather = [&](int s) {
      const int k0 = s * kBK;
      KIdx st = gk;
#pragma unroll
      for (int kk = 0; kk < RPT_B; ++kk) {
        const int mh = ohb + st.dy, mw = owb + st.dx;
        // outside [0, Ho1) x [0, Wo1) is conv2's zero padding
        const bool ok = gb.ok && k0 + kkB0 + kk < K2c && mh >= 0 &&
                        mh < a.Ho1 && mw >= 0 && mw < a.Wo1;
        rb[kk] = ok ? mid[st.c * a.RSTR + rbase + st.dy * rs_h +
                          st.dx * rs_w]
                    : 0.f;
        kstep(st, a.F2);
      }
      kadvance(gk, dk2, a.F2);
    };
    auto stage = [&](int buf) {
      float* bs = Bs + buf * kBK * TBN;
#pragma unroll
      for (int kk = 0; kk < RPT_B; ++kk) bs[(kkB0 + kk) * TBN + cB] = rb[kk];
    };
    auto issue_w2 = [&](int s, int buf) {
      const int k0 = s * kBK;
      float* as = As + buf * kBK * ASTR;
      if (p.vec_w2) {
#pragma unroll
        for (int i = 0; i < kBK * TBM / 4 / kThreads; ++i) {  // quads
          const int e = tid + i * kThreads;
          const int kk = e / (TBM / 4), m4 = (e % (TBM / 4)) * 4;
          const int k = k0 + kk, co = co0 + m4;
          const bool ok = k < K2c && co < a.Co;
          copy4(as + kk * ASTR + m4,
                ok ? a.w2 + (k2base + k) * a.w2K + co : a.w2, ok);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBK * TBM / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int kk = e / TBM, m = e % TBM;
          const int k = k0 + kk, co = co0 + m;
          const bool ok = k < K2c && co < a.Co;
          copy1(as + kk * ASTR + m,
                ok ? a.w2 + (k2base + k) * a.w2K + co : a.w2, ok);
        }
      }
    };
    issue_w2(0, 0);
    cp_commit();
    gather(0);
    stage(0);
    for (int s = 0; s < nsl2; ++s) {
      const int buf = s & 1;
      const bool more = s + 1 < nsl2;
      cp_wait_all();
      __syncthreads();  // slice s is staged; slice s-1 is consumed
      if (more) {
        issue_w2(s + 1, buf ^ 1);
        cp_commit();
        gather(s + 1);
      }
      const float* as = As + buf * kBK * ASTR;
      const float* bs = Bs + buf * kBK * TBN;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4 * GM], bv[4 * GN];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              as + kk * ASTR + g * 64 + ty * 4);
          av[4 * g] = v.x;
          av[4 * g + 1] = v.y;
          av[4 * g + 2] = v.z;
          av[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int g = 0; g < GN; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + kk * TBN + g * 64 + tx * 4);
          bv[4 * g] = v.x;
          bv[4 * g + 1] = v.y;
          bv[4 * g + 2] = v.z;
          bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4 * GM; ++i)
#pragma unroll
          for (int j = 0; j < 4 * GN; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) stage(buf ^ 1);
    }
    fma_count += (unsigned long long)TBM * TBN * nsl2 * kBK;
  }
  cluster_wait();   // no rank reads my slab any more
  __syncthreads();  // the pool tile overlays the slab

  if (p.stats && tid == 0) {
    atomicAdd(p.stats, 2ull * fma_count);
    atomicMax(p.stats + 1, (unsigned long long)cluster.num_blocks());
  }

  // conv2's epilogue on the registers: bias, residual, ReLU; then store,
  // or stage the tile (over the slab) for the pool reduction
  constexpr int TSTR = TBN + 1;
  float* Ts = mid;
#pragma unroll
  for (int j = 0; j < 4 * GN; ++j) {
    const int c = (j / 4) * 64 + tx * 4 + (j % 4);
    const SCol col = scol(a, t, c);
#pragma unroll
    for (int i = 0; i < 4 * GM; ++i) {
      const int m = (i / 4) * 64 + ty * 4 + (i % 4);
      const int co = co0 + m;
      if (!col.ok || co >= a.Co) continue;
      float v = acc[i][j];
      if (a.b2) v += ld(a.b2 + co);
      if (a.res)
        v += ld(a.res + (long long)col.n * a.rs.n + (long long)co * a.rs.c +
                col.oh * a.rs.h + col.ow * a.rs.w);
      if (a.relu2) v = v < 0.f ? 0.f : v;
      if (POOL)
        Ts[m * TSTR + c] = v;
      else
        put(a.y + (long long)col.n * a.ys.n + (long long)co * a.ys.c +
                col.oh * a.ys.h + col.ow * a.ys.w,
            v);
    }
  }
  if (POOL) {
    __syncthreads();
    const float area = (float)(a.pF * a.pF);
    for (int e = tid; e < TBM * a.BU; e += kThreads) {
      const int m = e / a.BU, ul = e - m * a.BU;
      const SCol col = scol(a, t, ul);  // tap 0 of unit ul
      const int co = co0 + m;
      if (!col.ok || co >= a.Co) continue;
      float r = a.pool_avg ? 0.f : -INFINITY;
      for (int tp = 0; tp < a.T; ++tp) {
        const float v = Ts[m * TSTR + tp * a.BU + ul];
        r = a.pool_avg ? r + v : nan_max(r, v);
      }
      put(a.y + (long long)col.n * a.ys.n + (long long)co * a.ys.c +
              col.uh * a.ys.h + col.uw * a.ys.w,
          a.pool_avg ? r / area : r);
    }
  }
}

// dynamic shared memory of one block, in bytes (ops.py::stack_tiling
// computes the same number)
template <int GM>
inline long long smem_bytes(int rstr, bool pool) {
  using S = CShape<GM>;
  long long slab = (long long)kCM * rstr;
  const long long ts = pool ? (long long)S::TBM * (S::TBN + 1) : 0;
  if (ts > slab) slab = ts;
  return 4 * (S::RING + slab);
}

template <bool POOL, int GM, typename E>
int launch(const ClusterArgs<E>& p, dim3 grid, cudaStream_t st,
           int* clusters) {
  const long long bytes = smem_bytes<GM>(p.s.RSTR, POOL);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = cluster_stack_kernel<E, POOL, GM>;
  // a refused call leaves its error behind: clear it, so the next launch
  // does not report it
  auto fail = [](cudaError_t e) {
    cudaGetLastError();
    return static_cast<int>(e);
  };
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return fail(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.CL;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) {  // occupancy query only
    e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    return e != cudaSuccess ? fail(e) : 0;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return fail(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool POOL, typename E>
int dispatch(const ClusterArgs<E>& p, int gm, dim3 grid, cudaStream_t st,
             int* clusters) {
  switch (gm) {
    case 1: return launch<POOL, 1>(p, grid, st, clusters);
    case 2: return launch<POOL, 2>(p, grid, st, clusters);
    case 4: return launch<POOL, 4>(p, grid, st, clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the largest mid rows a tile of UT units reads along a dim of U units
// (mid_span of each tile, clipped to [0, M1))
inline int max_span(int U, int UT, int pF, int pS, int S2, int P2, int F2,
                    int M1) {
  int best = 0;
  for (int u0 = 0; u0 < U; u0 += UT) {
    const int n = U - u0 < UT ? U - u0 : UT;
    const int o0 = pF ? u0 * pS : u0, on = pF ? (n - 1) * pS + pF : n;
    int m0 = o0 * S2 - P2, m1 = (o0 + on - 1) * S2 - P2 + F2;
    if (m0 < 0) m0 = 0;
    if (m1 > M1) m1 = M1;
    if (m1 - m0 > best) best = m1 - m0;
  }
  return best;
}

template <typename E>
int forward(const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, const void* res, void* y, int N, int Ci, int H,
            int W, int Cm, int F1, int S1, int P1, int Co, int F2, int S2,
            int P2, int pool_F, int pool_S, int pool_avg, int relu1,
            int relu2, int src_nchw, int dst_nchw, int res_nchw, int bm,
            int nb, int uth, int utw, int cl, void* stats, void* stream,
            int* clusters) {
  ClusterArgs<E> p;
  StackArgs<E>& a = p.s;
  a.x = static_cast<const E*>(x);
  a.w1 = static_cast<const E*>(w1);
  a.b1 = static_cast<const E*>(b1);
  a.w2 = static_cast<const E*>(w2);
  a.b2 = static_cast<const E*>(b2);
  a.res = static_cast<const E*>(res);
  a.y = static_cast<E*>(y);
  a.N = N; a.Ci = Ci; a.H = H; a.W = W; a.Cm = Cm;
  a.F1 = F1; a.S1 = S1; a.P1 = P1; a.K1 = Ci * F1 * F1;
  a.Ho1 = (H + 2 * P1 - F1) / S1 + 1;
  a.Wo1 = (W + 2 * P1 - F1) / S1 + 1;
  a.Co = Co; a.F2 = F2; a.S2 = S2; a.P2 = P2;
  a.Ho2 = (a.Ho1 + 2 * P2 - F2) / S2 + 1;
  a.Wo2 = (a.Wo1 + 2 * P2 - F2) / S2 + 1;
  a.pF = pool_F; a.pS = pool_S; a.pool_avg = pool_avg;
  a.relu1 = relu1; a.relu2 = relu2;
  const bool pool = pool_F > 0;
  if (pool) {
    a.UH = (a.Ho2 - pool_F) / pool_S + 1;
    a.UW = (a.Wo2 - pool_F) / pool_S + 1;
    a.T = pool_F * pool_F;
  } else {
    a.UH = a.Ho2;
    a.UW = a.Wo2;
    a.T = 1;
  }
  const int gm = bm / 64;
  if ((gm != 1 && gm != 2 && gm != 4) || bm % 64 || nb < 1 || uth < 1 ||
      utw < 1 || cl < 1 ||
      (long long)nb * uth * utw * a.T > kTile / bm)
    return static_cast<int>(cudaErrorInvalidValue);
  a.NB = nb; a.UTH = uth; a.UTW = utw; a.BU = nb * uth * utw;
  a.nTH = (a.UH + uth - 1) / uth;
  a.nTW = (a.UW + utw - 1) / utw;
  const int pF = pool ? pool_F : 0, pS = pool ? pool_S : 0;
  const int nbmax = nb < N ? nb : N;
  a.RSTR = nbmax * max_span(a.UH, uth, pF, pS, S2, P2, F2, a.Ho1) *
           max_span(a.UW, utw, pF, pS, S2, P2, F2, a.Wo1);
  a.RSTR = (a.RSTR + 3) & ~3;
  // w1 [Ci, F1, F1, Cm] is [K1, Cm]; w2 [Cm, F2, F2, Co] is [K2, Co]
  a.w1O = 1; a.w1K = Cm; a.w2O = 1; a.w2K = Co;
  a.xs = layout_strides(src_nchw, N, Ci, H, W);
  a.rs = layout_strides(res_nchw, N, Co, a.Ho2, a.Wo2);
  a.ys = layout_strides(dst_nchw, N, Co, a.UH, a.UW);
  p.CL = cl;
  auto al16 = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  p.vec_x = !src_nchw && N % 4 == 0 && nb % 4 == 0 && al16(x);
  p.vec_w1 = Cm % 4 == 0 && al16(w1);
  p.vec_w2 = Co % 4 == 0 && al16(w2);
  p.stats = static_cast<unsigned long long*>(stats);
  if (!clusters && (N <= 0 || Co <= 0 || a.UH <= 0 || a.UW <= 0))
    return static_cast<int>(cudaGetLastError());
  const int co_tiles = (Co + bm - 1) / bm;
  const int groups = (co_tiles + cl - 1) / cl;
  const dim3 grid(((N + nb - 1) / nb) * a.nTH * a.nTW, cl * groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pool ? dispatch<true>(p, gm, grid, st, clusters)
              : dispatch<false>(p, gm, grid, st, clusters);
}

}  // namespace stack_cluster
}  // namespace repro

// bm output channels a block; cl blocks a cluster along Co; nb x uth x utw
// units a tile.  stats, if not
// null, is two uint64 on the device: the FLOPs the kernel executes are
// added to [0], the cluster size it ran with goes to [1].  Every tensor is
// REPRO_WT (storage.cuh: conv_stack_chwn_forward is float32,
// conv_stack_chwn_forward_bf16 the bf16 variant).  Returns a cudaError_t
// code.
extern "C" int REPRO_ENTRY(conv_stack_chwn_forward)(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* res, void* y, int N, int Ci, int H, int W,
    int Cm, int F1, int S1, int P1, int Co, int F2, int S2, int P2,
    int pool_F, int pool_S, int pool_avg, int relu1, int relu2, int src_nchw,
    int dst_nchw, int res_nchw, int bm, int nb, int uth, int utw, int cl,
    void* stats, void* stream) {
  return repro::stack_cluster::forward<REPRO_WT>(
      x, w1, b1, w2, b2, res, y, N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2,
      pool_F, pool_S, pool_avg, relu1, relu2, src_nchw, dst_nchw, res_nchw,
      bm, nb, uth, utw, cl, stats, stream, nullptr);
}

#ifndef REPRO_VARIANT  // the tile's occupancy is the same in every variant

// How many clusters of the tile above can be resident on the device at once
// (cudaOccupancyMaxActiveClusters), into *clusters.  Returns a cudaError_t.
extern "C" int conv_stack_chwn_max_clusters(
    int N, int Ci, int H, int W, int Cm, int F1, int S1, int P1, int Co,
    int F2, int S2, int P2, int pool_F, int pool_S, int bm, int nb, int uth,
    int utw, int cl, int* clusters) {
  *clusters = 0;
  return repro::stack_cluster::forward<float>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, N, Ci,
      H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool_F, pool_S, 0, 1, 1, 0, 0, 0,
      bm, nb, uth, utw, cl, nullptr, nullptr, clusters);
}
#endif
