// K5a: the conv -> conv stack on the CHWN engine, in one kernel.
//
// Replaces repro/kernels/conv/stack.py::conv_stack_chwn_pallas (body
// _stack_chwn_kernel): conv1 [+bias1] [+ReLU] -> conv2 with the full
// bias/residual/ReLU/max-avg-pool epilogue, the mid activation kept in
// shared memory and never written to device memory.  x is [Ci,H,W,N] or
// [N,Ci,H,W]; w1 is [Ci,F1,F1,Cm], w2 [Cm,F2,F2,Co]; y is [Co,Ho',Wo',N] or
// [N,Co,Ho',Wo'] (Ho', Wo' after the pool); the residual is read in its own
// layout, before the ReLU.  The float32 build runs fp32 FMA on the CUDA
// cores (no TF32); the int8->fp32 build does not (below).
//
// Storage dtypes (csrc/storage.cuh): w1, w2, the biases, the residual and
// y all float32 or all bf16, and x of their dtype or int8 (quantized per
// channel, its scale folded into w1, as the reference's stack takes it).
// The bf16 build runs its own kernel on the bf16 tensor cores
// (cluster_stack_bf16_kernel below, whose note says how); in both the mid
// activation stays float32 (it never leaves the SM, so it is never rounded
// to the storage type, as in the reference's kernel), and y is rounded
// once where it is stored.  The int8 builds keep their float twin's tiles
// and run warp-specialised kernels of their own (whose notes say how): the
// bytes by cp.async, widened to bf16 in shared memory, exact, as |q| <= 127
// fits bf16's 8-bit significand; int8->bf16 (cluster_stack_i8bf16_kernel)
// on the bf16 tensor cores as its twin, int8->fp32
// (cluster_stack_i8f32_kernel) on the tensor cores at fp32 accuracy
// (conv1 three bf16 products a term, conv2 3xTF32).
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
#include "conv_ring.cuh"          // the ring barriers (int8->bf16 build)
#include "conv_stack_common.cuh"  // StackArgs, Tile, make_tile

namespace repro {
namespace stack_cluster {

namespace cg = cooperative_groups;
using stack::StackArgs;
using stack::Tile;
using storage::chunk8;
using storage::copy1;
using storage::copy4;
using storage::ld;
using storage::put;
using storage::split3;

constexpr int kThreads = 256;
constexpr int kBK = 16;     // reduction slice of both phases
constexpr int kCM = 64;     // mid channels per chunk
constexpr int kTile = 16384;  // bm * bn
constexpr int kPassMax = 128;  // mid positions of the widest conv1 pass
constexpr int kMaxSmem = 232448;  // 227 KB, what an H100 block may use

template <typename E, typename X = E>
struct ClusterArgs {
  StackArgs<E, X> s;
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
// widening register load for bf16 or int8; ok == false zero-fills dst
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

// The other ranks' shares of a chunk's mid slab, copied into this block's
// slab through distributed shared memory (after the cluster barrier that
// follows phase A), by threads tid of nthreads
template <typename E, typename X>
__device__ __forceinline__ void exchange_mid(const StackArgs<E, X>& a,
                                             const Tile& t,
                                             cg::cluster_group& cluster,
                                             float* mid, int RR, int CL,
                                             int rank, int cmn, int tid,
                                             int nthreads) {
  for (int q = 0; q < CL; ++q) {
    if (q == rank) continue;
    const int lo = min(t.RA, q * RR), hi = min(t.RA, lo + RR);
    const float* rem = cluster.map_shared_rank(mid, q);
    if (((lo | hi) & 3) == 0) {
      const int nq = (hi - lo) / 4;
      for (int e = tid; e < cmn * nq; e += nthreads) {
        const int c = e / nq, j = lo + 4 * (e - c * nq);
        *reinterpret_cast<float4*>(mid + c * a.RSTR + j) =
            *reinterpret_cast<const float4*>(rem + c * a.RSTR + j);
      }
    } else {
      const int n = hi - lo;
      for (int e = tid; e < cmn * n; e += nthreads) {
        const int c = e / n, j = lo + (e - c * n);
        mid[c * a.RSTR + j] = rem[c * a.RSTR + j];
      }
    }
  }
}

// conv2's epilogue of one sum v, tile row m (channel co), tile column c
// (col = scol(c)): bias, residual, ReLU; then store, or stage it in the
// pool tile Ts (over the slab)
template <bool POOL, typename E, typename X>
__device__ __forceinline__ void epilogue_one(const StackArgs<E, X>& a,
                                             const SCol& col, int co, int m,
                                             int c, float v, float* Ts,
                                             int TSTR) {
  if (!col.ok || co >= a.Co) return;
  if (a.b2) v += ld(a.b2 + co);
  if (a.res)
    v += ld(a.res + (long long)col.n * a.rs.n + (long long)co * a.rs.c +
            col.oh * a.rs.h + col.ow * a.rs.w);
  if (a.relu2) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
  if (POOL)
    Ts[m * TSTR + c] = v;
  else
    put(a.y + (long long)col.n * a.ys.n + (long long)co * a.ys.c +
            col.oh * a.ys.h + col.ow * a.ys.w,
        v);
}

// the pool over the staged tile Ts (TBM rows, once every thread that staged
// it has passed a barrier): each unit's T taps, max (nan_max) or avg, by
// threads tid of nthreads
template <typename E, typename X>
__device__ __forceinline__ void pool_tile(const StackArgs<E, X>& a,
                                          const Tile& t, const float* Ts,
                                          int TSTR, int TBM, int co0,
                                          int tid, int nthreads) {
  const float area = (float)(a.pF * a.pF);
  for (int e = tid; e < TBM * a.BU; e += nthreads) {
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

// One conv1 pass of K5a's phase A: the [kCM x KRA] implicit GEMM of mid
// positions [p0, p0 + KRA) (clipped to this rank's range [p_lo, p_hi))
// over K1, 4 x PW outputs a thread (PW 4 or 8: positions tx * 4 + j of
// each 64-wide group), bias1 and ReLU, into the slab.
template <int PW, typename E, typename X>
__device__ __forceinline__ void conv1_pass(
    const ClusterArgs<E, X>& p, const Tile& t, float* As1, float* Bs1,
    float* mid, int p0, int p_lo, int p_hi, int cm0, int cmn,
    const KIdx& dk1, int tid, int tx, int ty) {
  constexpr int KRA = 16 * PW;
  constexpr int ASTR1 = kCM + 4;
  const StackArgs<E, X>& a = p.s;
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
  const X* xcol = a.x + (long long)(t.n0 + nl) * a.xs.n;
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

template <typename E, typename X, bool POOL, int GM>
__global__ void __launch_bounds__(kThreads, 1)
cluster_stack_kernel(const ClusterArgs<E, X> p) {
  using S = CShape<GM>;
  constexpr int GN = S::GN, TBM = S::TBM, TBN = S::TBN;
  constexpr int ASTR1 = S::ASTR1, ASTR = S::ASTR;
  constexpr int RPT_B = kBK * TBN / kThreads;  // slab values a thread, B
  const StackArgs<E, X>& a = p.s;
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
    exchange_mid(a, t, cluster, mid, RR, CL, rank, cmn, tid, kThreads);
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
      epilogue_one<POOL>(a, col, co0 + m, m, c, acc[i][j], Ts, TSTR);
    }
  }
  if (POOL) {
    __syncthreads();
    pool_tile(a, t, Ts, TSTR, TBM, co0, tid, kThreads);
  }
}

// ---- the bf16 build: both convs on the bf16 tensor cores -------------------
//
// Instantiated only by the bf16 build (launch below).  The cluster, the
// chunks of kCM mid channels, the float32 mid slab and its exchange through
// distributed shared memory, the tiles and every count are the float32
// kernel's, and so is the epilogue; the products and the rings differ.  The
// rings lie inside the float32 kernel's ring (smem_bytes is the same).
//
//   phase A (conv1): bf16 x and w1 in a 4-stage ring of k16 slices (three
//     slices of loads in flight), each row of 16-byte chunks XOR-swizzled
//     by the row (mma.cuh::swz); w1 [k][cm] and the x gather [k][position]
//     are both MN-major, so ldmatrix.trans forms the m16n8k16 fragments.  A
//     pass is a [64 x 128] (or [64 x 64]) GEMM, eight warps of 32 x 32 (32
//     x 16), the bf16 products (exact in fp32) summed in fp32 on the tensor
//     cores in one chain over K1 (K1 <= 2304 on the networks: at most 144
//     k16 steps, inside what K1's narrow build was measured to hold
//     unflushed; its source note).  Bias1 and ReLU in fp32; the mid slab
//     stays float32.  x runs of 8 positions (a
//     run of n: CHWN x, N and nb multiples of 8) arrive by 16-byte
//     cp.async, w1 rows of 8 mid channels too; anything else element by
//     element, stored as bf16 halfwords.
//   phase B (conv2): the reference reads the mid at float32, so each mid
//     value m enters as three bf16 parts, hi = bf16(m), md = bf16(m - hi),
//     lo = bf16(m - hi - md), whose sum is m exactly (24 significand bits),
//     and a term is three bf16 products (lo, md, hi) with the exact bf16 w2.
//     w2 [k][co] arrives in a 3-stage bf16 ring of k16 slices (16-byte
//     cp.async where Co % 8 == 0); the mid tile, gathered from the slab one
//     slice ahead, stays float32 ([k][column], rows 4 mod 32 floats apart),
//     and each lane splits its B values into the three bf16 fragments after
//     two float2 loads a k pair.  A warp owns 64 x 32 of the bm x bn tile (4
//     x 4 m16n8 tiles); its chain runs over one chunk (64 x F2 x F2 terms,
//     three products each: 108 k16 products for a 3 x 3 conv2) and is then
//     added to fp32 registers.  GEMM column g of a pair of n tiles is shared
//     column 2g (first tile) and 2g + 1 (second), so one float2 holds both
//     tiles' values.
//
// What bounds it: operations, at the bf16 tensor cores' 989 TFLOP/s, three
// products a conv2 term and one a conv1 term (mma.sync m16n8k16, 256
// threads that both copy and multiply); conv2 dominates wherever Cm*F2*F2
// is long (VGG16's pairs: 576 against conv1's 27 or 576).
// Both phases step k16 a slice.  Their global loads run ahead of the
// products: phase A's w1 and x slices in a ring of kNS1 (three slices
// ahead), phase B's w2 in a ring of kNS2 (two ahead); phase B's mid tile,
// gathered from shared memory, one ahead.
constexpr int kNBK = 16;   // a slice: one k16 step
constexpr int kNS1 = 4;    // phase A's ring
constexpr int kNS2 = 3;    // phase B's w2 ring

template <int GM>
struct NShape {
  static constexpr int TBM = 64 * GM, TBN = kTile / TBM;
  static constexpr int SB2 = TBN + 4;  // float row stride of the mid tile
  // byte offsets in the ring: phase A's w1 and x slices, phase B's w2
  // slices and two mid tiles
  static constexpr int B1 = kNS1 * kNBK * kCM * 2;
  static constexpr int RING_A = B1 + kNS1 * kNBK * kPassMax * 2;
  static constexpr int B2 = kNS2 * kNBK * TBM * 2;
  static constexpr int RING_B = B2 + 2 * kNBK * SB2 * 4;
  static_assert(RING_A <= 4 * CShape<GM>::RING &&
                    RING_B <= 4 * CShape<GM>::RING,
                "the bf16 rings fit the float32 kernel's");
};

// conv2's epilogue of the bf16 builds' sums, as their products lay them
// out: accumulator e of (mt, nt) of warp (wm, wn) is row wm*64 + mt*16 + g
// + 8 (e >= 2) and, where PAIRED (the twin: a pair of n tiles shares one
// float2 of its mid tile), column wn*32 + 16 (nt / 2) + 4 tq + 2 (e & 1) +
// (nt & 1), else column wn*32 + 8 nt + 2 tq + (e & 1)
template <bool POOL, int GM, bool PAIRED = true, typename E, typename X>
__device__ __forceinline__ void tile_epilogue(const StackArgs<E, X>& a,
                                              const Tile& t,
                                              const float (&tot)[4][4][4],
                                              float* Ts, int TSTR, int co0,
                                              int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % GM, wn = warp / GM;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int ce = 0; ce < 2; ++ce) {
      const int c = PAIRED
                        ? wn * 32 + 16 * (nt / 2) + 4 * tq + 2 * ce + (nt & 1)
                        : wn * 32 + 8 * nt + 2 * tq + ce;
      const SCol col = scol(a, t, c);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wm * 64 + mt * 16 + g + 8 * h;
          epilogue_one<POOL>(a, col, co0 + m, m, c, tot[mt][nt][2 * h + ce],
                             Ts, TSTR);
        }
    }
}

// One conv1 pass of the bf16 build's phase A: the [kCM x KRA] GEMM of mid
// positions [p0, p0 + KRA) (clipped to this rank's range [p_lo, p_hi))
// over K1, bias1 and ReLU, into the slab.
template <int KRA, typename X>
__device__ __forceinline__ void conv1_pass_bf16(
    const ClusterArgs<storage::bf16, X>& p, const Tile& t, unsigned char* ring,
    float* mid, int p0, int p_lo, int p_hi, int cm0, int cmn, int tid) {
  using storage::bf16;
  constexpr int NTA = KRA / 32;    // n8 tiles of a warp (2 x 4 warps)
  constexpr int XCH = KRA / 8;     // 16-byte chunks of an x row
  constexpr int SPT = kNBK * KRA / kThreads;   // x elements a thread
  const StackArgs<bf16, X>& a = p.s;
  bf16* As1 = reinterpret_cast<bf16*>(ring);
  bf16* Bs1 = reinterpret_cast<bf16*>(ring + NShape<1>::B1);
  const int nsl = (a.K1 + kNBK - 1) / kNBK;
  // x: runs, chunk xq of row xr (positions p0 + 8 xq ..), threads below
  // kNBK * XCH; else the elements of position tid % KRA, rows tid / KRA +
  // (kThreads / KRA) i
  const int xq = tid % XCH, xr = tid / XCH;
  const int pp = p.vec_x ? p0 + 8 * xq : p0 + tid % KRA;
  int nl, mhl, mwl;
  {
    const int rr = pp < p_hi ? pp : p_lo;
    nl = rr % t.NBc;
    const int q = rr / t.NBc;
    mwl = q % t.MWc;
    mhl = q / t.MWc;
  }
  const bool pok = pp < p_hi;
  const X* xcol = a.x + (long long)(t.n0 + nl) * a.xs.n;
  const int ih0 = (t.mh_lo + mhl) * a.S1 - a.P1;
  const int iw0 = (t.mw_lo + mwl) * a.S1 - a.P1;
  const KIdx dk1 = kidx(kNBK, a.F1);
  KIdx xk = kidx(xr, a.F1);  // runs: (c, dy, dx) of this thread's row
  auto issue = [&](int s) {
    const int k0 = s * kNBK, buf = s % kNS1;
    bf16* as = As1 + buf * kNBK * kCM;
    bf16* bs = Bs1 + buf * kNBK * KRA;
    if (tid < kNBK * (kCM / 8)) {  // w1: kNBK rows of 8 chunks
      const int r = tid >> 3, cq = tid & 7, k = k0 + r, m = 8 * cq;
      chunk8(as + mma::swz<kCM>(r, cq),
             k < a.K1 && m < cmn ? a.w1 + (long long)k * a.w1K + cm0 + m
                                 : a.w1,
             k < a.K1 ? cmn - m : 0, p.vec_w1 && m + 8 <= cmn);
    }
    if (p.vec_x) {
      if (tid < kNBK * XCH) {
        const int h = ih0 + xk.dy, w = iw0 + xk.dx;
        const bool ok = pok && k0 + xr < a.K1 && h >= 0 && h < a.H &&
                        w >= 0 && w < a.W;
        const X* src =
            ok ? xcol + xk.c * a.xs.c + h * a.xs.h + w * a.xs.w : a.x;
        mma::cp16(bs + mma::swz<KRA>(xr, xq), src, ok);
        kadvance(xk, dk1, a.F1);
      }
    } else {
      const int pc = tid % KRA;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int kk = tid / KRA + (kThreads / KRA) * i;
        const int k = k0 + kk;
        const KIdx q = kidx(k, a.F1);
        const int h = ih0 + q.dy, w = iw0 + q.dx;
        const bool ok = pok && k < a.K1 && h >= 0 && h < a.H && w >= 0 &&
                        w < a.W;
        reinterpret_cast<unsigned short*>(
            bs)[mma::swz<KRA>(kk, pc >> 3) + (pc & 7)] =
            static_cast<unsigned short>(storage::bf16_bits(
                ok ? xcol + q.c * a.xs.c + h * a.xs.h + w * a.xs.w : a.x,
                ok));
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 32 mid channels, KRA/4 positions
  const int ar = (lane & 7) + ((lane >> 4) << 3), ac = (lane >> 3) & 1;
  const int br = (lane & 7) + (((lane >> 3) & 1) << 3), bc = lane >> 4;
  int aoff[2], boff[NTA / 2];  // this lane's swizzled ldmatrix offsets
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    aoff[mt] = mma::swz<kCM>(ar, (wm * 32 + mt * 16) / 8 + ac);
#pragma unroll
  for (int np = 0; np < NTA / 2; ++np)
    boff[np] = mma::swz<KRA>(br, (wn * (KRA / 4) + np * 16) / 8 + bc);
  float acc[2][NTA][4];  // the pass's sums: one chain over K1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kNS1 - 1; ++s) {
    if (s < nsl) issue(s);
    cp_commit();
  }
  for (int s = 0; s < nsl; ++s) {
    mma::cp_wait<kNS1 - 2>();
    __syncthreads();  // slice s has landed; slice s-1 is consumed
    if (s + kNS1 - 1 < nsl) issue(s + kNS1 - 1);
    cp_commit();
    const bf16* as = As1 + (s % kNS1) * kNBK * kCM;
    const bf16* bs = Bs1 + (s % kNS1) * kNBK * KRA;
    unsigned af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma::ldsm_x4_t(af[mt], as + aoff[mt]);
#pragma unroll
    for (int nt = 0; nt < NTA; nt += 2) {
      unsigned bq[4];
      mma::ldsm_x4_t(bq, bs + boff[nt / 2]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma::mma_bf16(acc[mt][nt], af[mt], bq[0], bq[1]);
        mma::mma_bf16(acc[mt][nt + 1], af[mt], bq[2], bq[3]);
      }
    }
  }
  // conv1's epilogue: bias, ReLU, into my range of the slab; accumulator e
  // of (mt, nt) is mid channel wm*32 + mt*16 + g + 8 (e >= 2), position
  // wn*KRA/4 + nt*8 + 2 tq + (e & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cml = wm * 32 + mt * 16 + g + 8 * h;
      if (cml >= cmn) continue;
      const float b = a.b1 ? storage::ld(a.b1 + cm0 + cml) : 0.f;
#pragma unroll
      for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = p0 + wn * (KRA / 4) + nt * 8 + 2 * tq + e;
          if (r >= p_hi) continue;
          float v = acc[mt][nt][2 * h + e] + b;
          if (a.relu1) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
          mid[cml * a.RSTR + r] = v;
        }
    }
  __syncthreads();  // the next pass refills the ring
}

template <typename X, bool POOL, int GM>
__global__ void __launch_bounds__(kThreads, 1)
cluster_stack_bf16_kernel(const ClusterArgs<storage::bf16, X> p) {
  using storage::bf16;
  using S = NShape<GM>;
  constexpr int TBM = S::TBM, TBN = S::TBN, SB2 = S::SB2;
  constexpr int RPT_B = kNBK * TBN / kThreads;  // slab values a thread, B
  constexpr int WCH2 = TBM / 8;                 // 16-byte chunks of a w2 row
  constexpr int W2PT = (kNBK * WCH2 + kThreads - 1) / kThreads;
  const StackArgs<bf16, X>& a = p.s;
  extern __shared__ __align__(128) unsigned char smem_b[];
  unsigned char* ring = smem_b;
  // [kCM][RSTR] slab; later the pool tile: where the float32 kernel has it
  float* mid = reinterpret_cast<float*>(smem_b) + CShape<GM>::RING;
  bf16* As = reinterpret_cast<bf16*>(ring);              // [kNS2][16][TBM]
  float* Bs = reinterpret_cast<float*>(ring + S::B2);    // [2][16][SB2]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = p.CL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % GM, wn = warp / GM;  // 64 rows x 32 columns a warp
  const int ar = (lane & 7) + ((lane >> 4) << 3), ac = (lane >> 3) & 1;
  int aoff[4];  // this lane's swizzled ldmatrix offsets in a w2 slice
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    aoff[mt] = mma::swz<TBM>(ar, (wm * 64 + mt * 16) / 8 + ac);
  const Tile t = stack::make_tile(a);
  const int rs_w = t.NBc, rs_h = t.NBc * t.MWc;
  const int co0 = blockIdx.y * TBM;

  const int RR = (((t.RA + CL - 1) / CL) + 63) & ~63;
  const int p_lo = min(t.RA, rank * RR), p_hi = min(t.RA, p_lo + RR);
  const int cB = tid % TBN, kkB0 = (tid / TBN) * RPT_B;
  const SCol gb = scol(a, t, cB);
  const int ohb = gb.oh * a.S2 - a.P2, owb = gb.ow * a.S2 - a.P2;
  const int rbase = gb.nl + (ohb - t.mh_lo) * rs_h + (owb - t.mw_lo) * rs_w;

  const KIdx dk2 = kidx(kNBK, a.F2);
  const int F2sq = a.F2 * a.F2;
  const int k16 = (a.K1 + kNBK - 1) / kNBK;  // conv1's slices
  unsigned long long fma_count = 0;

  float tot[4][4][4], chain[4][4][4];  // conv2 sums; this chunk's chain
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] = chain[mt][nt][e] = 0.f;

  for (int cm0 = 0; cm0 < a.Cm; cm0 += kCM) {
    const int cmn = min(kCM, a.Cm - cm0);
    __syncthreads();  // local phase B is done with the ring and the slab
    if (cm0 > 0) cluster_wait();  // and the other ranks with my share

    // ---- phase A: my share of conv1 -> mid slab (cm0 .. cm0+cmn) --------
    for (int p0 = p_lo; p0 < p_hi;) {
      if (p_hi - p0 > 64) {
        conv1_pass_bf16<128>(p, t, ring, mid, p0, p_lo, p_hi, cm0, cmn, tid);
        fma_count += (unsigned long long)kCM * 128 * k16 * kNBK;
        p0 += 128;
      } else {
        conv1_pass_bf16<64>(p, t, ring, mid, p0, p_lo, p_hi, cm0, cmn, tid);
        fma_count += (unsigned long long)kCM * 64 * k16 * kNBK;
        p0 += 64;
      }
    }

    // ---- the other ranks' shares, through distributed shared memory -----
    cluster.sync();  // every rank's share of this chunk is in its slab
    exchange_mid(a, t, cluster, mid, RR, CL, rank, cmn, tid, kThreads);
    cluster_arrive();  // done reading the other ranks' slabs
    __syncthreads();   // the whole slab is here

    // ---- phase B: conv2's (cm, dy, dx) terms of this chunk --------------
    const int K2c = cmn * F2sq;
    const long long k2base = (long long)cm0 * F2sq;
    const int nsl2 = (K2c + kNBK - 1) / kNBK;
    KIdx gk = kidx(kkB0, a.F2);  // (cm, dy, dx) of this thread's first row
    // slice s of the mid tile, gathered from the slab straight into buffer
    // buf (no registers held across the products)
    auto gather = [&](int s) {
      const int k0 = s * kNBK;
      float* bs = Bs + (s & 1) * kNBK * SB2;
      KIdx st = gk;
      float rb[RPT_B];
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
#pragma unroll
      for (int kk = 0; kk < RPT_B; ++kk) bs[(kkB0 + kk) * SB2 + cB] = rb[kk];
      kadvance(gk, dk2, a.F2);
    };
    auto issue_w2 = [&](int s) {
      const int k0 = s * kNBK;
      bf16* as = As + (s % kNS2) * kNBK * TBM;
#pragma unroll
      for (int i = 0; i < W2PT; ++i) {
        const int e = tid + i * kThreads;
        if (kNBK * WCH2 % kThreads != 0 && e >= kNBK * WCH2) break;
        const int r = e / WCH2, cq = e - r * WCH2;
        const int k = k0 + r, co = co0 + 8 * cq;
        chunk8(as + mma::swz<TBM>(r, cq),
               k < K2c && co < a.Co ? a.w2 + (k2base + k) * a.w2K + co : a.w2,
               k < K2c ? a.Co - co : 0, p.vec_w2 && co + 8 <= a.Co);
      }
    };
#pragma unroll
    for (int s = 0; s < kNS2 - 1; ++s) {
      if (s < nsl2) issue_w2(s);
      cp_commit();
    }
    gather(0);
    for (int s = 0; s < nsl2; ++s) {
      const bool more = s + 1 < nsl2;
      mma::cp_wait<kNS2 - 2>();
      __syncthreads();  // slice s is staged; slice s-1 is consumed
      if (s + kNS2 - 1 < nsl2) issue_w2(s + kNS2 - 1);
      cp_commit();
      if (more) gather(s + 1);
      const bf16* as = As + (s % kNS2) * kNBK * TBM;
      const float* bs = Bs + (s & 1) * kNBK * SB2;
      unsigned af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma::ldsm_x4_t(af[mt], as + aoff[mt]);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        // k rows 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of shared columns 2g, 2g + 1
        // of the pair: .x the first n tile's column g, .y the second's
        const float* b = bs + (2 * tq) * SB2 + wn * 32 + 16 * pr + 2 * g;
        const float2 r0 = *reinterpret_cast<const float2*>(b);
        const float2 r1 = *reinterpret_cast<const float2*>(b + SB2);
        const float2 r2 = *reinterpret_cast<const float2*>(b + 8 * SB2);
        const float2 r3 = *reinterpret_cast<const float2*>(b + 9 * SB2);
        unsigned hi[2][2], md[2][2], lo[2][2];  // [n tile][b0, b1]
        split3(r0.x, r1.x, hi[0][0], md[0][0], lo[0][0]);
        split3(r2.x, r3.x, hi[0][1], md[0][1], lo[0][1]);
        split3(r0.y, r1.y, hi[1][0], md[1][0], lo[1][0]);
        split3(r2.y, r3.y, hi[1][1], md[1][1], lo[1][1]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float (&c)[4] = chain[mt][2 * pr + h];
            mma::mma_bf16(c, af[mt], lo[h][0], lo[h][1]);
            mma::mma_bf16(c, af[mt], md[h][0], md[h][1]);
            mma::mma_bf16(c, af[mt], hi[h][0], hi[h][1]);
          }
      }
      if (!more) {  // flush the chain: once a chunk
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[mt][nt][e] += chain[mt][nt][e];
              chain[mt][nt][e] = 0.f;
            }
      }
    }
    fma_count += (unsigned long long)TBM * TBN * nsl2 * kNBK;
  }
  cluster_wait();   // no rank reads my slab any more
  __syncthreads();  // the pool tile overlays the slab

  if (p.stats && tid == 0) {
    atomicAdd(p.stats, 2ull * fma_count);
    atomicMax(p.stats + 1, (unsigned long long)cluster.num_blocks());
  }

  // conv2's epilogue on the registers, as the float32 kernel's: bias,
  // residual, ReLU; then store, or stage the tile (over the slab) for the
  // pool.  Accumulator e of (mt, nt) is row wm*64 + mt*16 + g + 8 (e >= 2),
  // column wn*32 + 16 (nt / 2) + 4 tq + 2 (e & 1) + (nt & 1).
  constexpr int TSTR = TBN + 1;
  float* Ts = mid;
  tile_epilogue<POOL, GM>(a, t, tot, Ts, TSTR, co0, tid);
  if (POOL) {
    __syncthreads();
    pool_tile(a, t, Ts, TSTR, TBM, co0, tid, kThreads);
  }
}

// ---- the int8->bf16 build: warp-specialised, x in flight as bytes ----------
//
// Instantiated only by the int8->bf16 build (launch below).  The twin's
// kernel above on int8 x: 256 threads that both copy and multiply, each x
// run a blocking 8-byte load widened in registers, a __syncthreads a k16
// slice, and phase B's mid tile gathered from the slab into shared memory
// by the same threads that run mma.sync.  On VGG16 b32's conv1 pair
// (PERF.md, timed apart on the card) its products took 1.1 of its 3.5 ms,
// its x copies 0.33 and its w copies 0.22: the rest, the non-product work
// of the threads that multiply, set its pace.
//
// Design.  The cluster, its DSMEM exchange of the mid slab (exchange_mid),
// the tiles, the cluster size, the passes and the counted FLOPs are the
// twin's, and so is the epilogue (tile_epilogue, pool_tile).  384 threads:
//
//   one producer warpgroup keeps every global copy in flight on the ring
//   barriers of conv_ring.cuh (FULL when a stage landed, EMPTY when it was
//   used), NS - 1 stages ahead across passes, phases and chunks.  A stage
//   is phase A's k16 slice, w1 [16][64] and x [16][KRA] bf16 (swizzled as
//   the twin's, mma::swz) with the x bytes [16][KRA] beside them, or
//   phase B's KB = 4 / GM k16 slices of w2 [16][TBM] (one FULL / EMPTY
//   hand-off for KB slices); NS of them fill the twin's ring (IShape).
//   w1 and w2 rows come by 16-byte cp.async (storage::chunk8); each x run
//   of 8 positions (CHWN x, N and nb multiples of 8) by one 8-byte
//   cp.async into the bytes, zero-filled off the map by its source size
//   (its 16-byte window straight into its bf16 chunk timed the same);
//   once its group has landed, the thread that copied a run widens it into
//   the bf16 slice (storage::bf16x8, exact) and arrives on FULL.  Without
//   runs (an NCHW source, N or nb not multiples of 8) a thread loads its
//   elements 8 at a time, every load issued before any is used, and stores
//   their bf16 bits.
//
//   two consumer warpgroups (setmaxnreg gives them the producer's spare
//   registers) run conv1 (the twin's warp tiles, ldmatrix.trans, one bf16
//   product a term, a chain a pass, bias1 and ReLU into the slab), the
//   exchange, and conv2: the w2 fragments by ldmatrix.trans from the ring;
//   the B fragments read straight from the slab, no gathered mid tile and
//   no block barrier a slice: 8 lanes on 8 neighbouring columns, each lane
//   its 4 columns' slab bases and its 4 k rows' offsets, every load made
//   (word 0 where it reads nothing) and its value selected, so the 16
//   loads issue back to back (written as conditional loads they compiled
//   to a branch and a reconvergence apiece, and the kernel ran 1.5x
//   slower), the next k16 slice's in flight while this one's products run;
//   three bf16 products a term from split3, in one chain over all of K2
//   (as K1's narrow build runs one over K1), which leaves the registers
//   for that prefetch.
//
//   The producers take part in every cluster barrier phase (after phase A,
//   after the exchange), each one NS - 1 stages after the chunk's first
//   phase-B stage, where the EMPTY wait they meet there has already held
//   them until the consumers finished the chunk's phase A.
//
// What bounds it: as the twin, operations by design (one bf16 product a
// conv1 term, three a conv2 term, mma.sync).  On the card (VGG16 b32's
// conv1 pair, timed apart with tools/timing_variants.py, PERF.md) the
// consumers alone take ~2.3 of its ~3.0 ms and the products ~1.5, and
// without its x copies it takes ~2.6: conv1 on 3 channels makes phase-A
// stages that the consumers finish faster than one producer warp a
// sub-partition issues and widens them, so phase A runs at the producers'
// pace (the copies' latency, size and values were each ruled out:
// near-address copies, 16-byte windows and zeroed x all timed within 4 %).
constexpr int kI8Consumers = 256;  // two warpgroups: the mma
constexpr int kI8Producers = 128;  // one warpgroup: the copies
constexpr int kI8Threads = kI8Consumers + kI8Producers;
// registers of a thread of each role (setmaxnreg): 384 x 168 at launch,
// then 256 x 216 + 128 x 72, the same 64512 (ptxas fits the producers'
// code to their share: at 40 they spilled and the kernel ran 6 % slower,
// at 56 3 %)
constexpr int kI8ConsumerRegs = 216;
constexpr int kI8ProducerRegs = 72;

template <int GM>
struct IShape {
  static constexpr int TBM = 64 * GM, TBN = kTile / TBM;
  // byte offsets in a stage: phase A's x bf16 slice and x bytes (after
  // the w1 slice at 0); phase B's KB k16 w2 slices from 0, KB = 4 / GM
  // (a phase-B stage takes a phase-A one's bytes, and one FULL / EMPTY
  // hand-off serves KB slices of conv2)
  static constexpr int XB = kNBK * kCM * 2;
  static constexpr int X8 = XB + kNBK * kPassMax * 2;
  static constexpr int A_BYTES = X8 + kNBK * kPassMax;
  static constexpr int KB = 4 / GM;
  static constexpr int B_BYTES = KB * kNBK * TBM * 2;
  static constexpr int SLOT = A_BYTES > B_BYTES ? A_BYTES : B_BYTES;
  // as many stages as the twin's ring holds (the slab stays where it is)
  static constexpr int NS = 4 * CShape<GM>::RING / SLOT;
  static_assert(NS >= 3 && NS * SLOT <= 4 * CShape<GM>::RING,
                "the stages fit the twin's ring");
};

// a stage of a block's walk (ops.py::k5a_i8bf16_stage gives stage sl in
// closed form): chunk, then phase A (pass, k16 slice s) or phase B (stage q
// >= 0 of KB k16 slices)
struct IStage {
  int chunk, pass, s, q;
};
struct IWalk {
  int nsl1, nA, nB;  // conv1's slices; a chunk's A and B stages
  __device__ __forceinline__ IStage first() const {
    return IStage{0, 0, 0, nA ? -1 : 0};
  }
  // id becomes the stage after it (the producers walk in order, with no
  // division)
  __device__ __forceinline__ void step(IStage& id) const {
    if (id.q < 0) {
      if (++id.s == nsl1) {
        id.s = 0;
        if (++id.pass * nsl1 == nA) {
          id.pass = 0;
          id.q = 0;
        }
      }
    } else if (++id.q == nB) {
      id.q = nA ? -1 : 0;
      ++id.chunk;
    }
  }
};

// element offset of 16-byte chunk c of row r of a [rows][DT] bf16 slice,
// DT 64 or 128 at run time (mma::swz)
__device__ __forceinline__ int swz_rt(int DT, int r, int c) {
  return r * DT + ((c ^ (r & 7)) << 3);
}

// One conv1 pass of the consumers: the [kCM x KRA] GEMM of mid positions
// [p0, p0 + KRA) over K1 from the ring's stages sl .. sl + nsl1 - 1, bias1
// and ReLU into the slab (the twin's conv1_pass_bf16 on ring stages)
template <int KRA, int NS, int SLOT, int XB>
__device__ __forceinline__ void conv1_pass_i8(
    const ClusterArgs<storage::bf16, int8_t>& p, const unsigned char* stages,
    float* mid, int p0, int p_hi, int cm0, int cmn, int tid, int nsl1,
    int& sl, int nsl) {
  using storage::bf16;
  constexpr int NTA = KRA / 32;  // n8 tiles of a warp (2 x 4 warps)
  const StackArgs<bf16, int8_t>& a = p.s;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 32 mid channels, KRA/4 positions
  const int ar = (lane & 7) + ((lane >> 4) << 3), ac = (lane >> 3) & 1;
  const int br = (lane & 7) + (((lane >> 3) & 1) << 3), bc = lane >> 4;
  int aoff[2], boff[NTA / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    aoff[mt] = mma::swz<kCM>(ar, (wm * 32 + mt * 16) / 8 + ac);
#pragma unroll
  for (int np = 0; np < NTA / 2; ++np)
    boff[np] = mma::swz<KRA>(br, (wn * (KRA / 4) + np * 16) / 8 + bc);
  float acc[2][NTA][4];  // the pass's sums: one chain over K1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int s = 0; s < nsl1; ++s, ++sl) {
    const int buf = sl % NS;
    mma::bar_sync(ring::full_bar(buf), kI8Threads);
    const bf16* as = reinterpret_cast<const bf16*>(stages + buf * SLOT);
    const bf16* bs = reinterpret_cast<const bf16*>(stages + buf * SLOT + XB);
    unsigned af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma::ldsm_x4_t(af[mt], as + aoff[mt]);
#pragma unroll
    for (int nt = 0; nt < NTA; nt += 2) {
      unsigned bq[4];
      mma::ldsm_x4_t(bq, bs + boff[nt / 2]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma::mma_bf16(acc[mt][nt], af[mt], bq[0], bq[1]);
        mma::mma_bf16(acc[mt][nt + 1], af[mt], bq[2], bq[3]);
      }
    }
    if (sl + NS < nsl) mma::bar_arrive(ring::empty_bar<NS>(buf), kI8Threads);
  }
  // bias, ReLU, into my range of the slab; accumulator e of (mt, nt) is
  // mid channel wm*32 + mt*16 + g + 8 (e >= 2), position wn*KRA/4 + nt*8 +
  // 2 tq + (e & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cml = wm * 32 + mt * 16 + g + 8 * h;
      if (cml >= cmn) continue;
      const float b = a.b1 ? storage::ld(a.b1 + cm0 + cml) : 0.f;
#pragma unroll
      for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = p0 + wn * (KRA / 4) + nt * 8 + 2 * tq + e;
          if (r >= p_hi) continue;
          float v = acc[mt][nt][2 * h + e] + b;
          if (a.relu1) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
          mid[cml * a.RSTR + r] = v;
        }
    }
}

template <bool POOL, int GM>
__global__ void __launch_bounds__(kI8Threads, 1)
cluster_stack_i8bf16_kernel(const ClusterArgs<storage::bf16, int8_t> p) {
  using storage::bf16;
  using S = IShape<GM>;
  constexpr int NS = S::NS, SLOT = S::SLOT;
  constexpr int TBM = S::TBM, TBN = S::TBN;
  constexpr int WCH2 = TBM / 8;  // 16-byte chunks of a w2 row
  const StackArgs<bf16, int8_t>& a = p.s;
  extern __shared__ __align__(128) unsigned char smem_b[];
  unsigned char* stages = smem_b;  // the ring: NS stages of SLOT bytes
  // [kCM][RSTR] slab; later the pool tile: where the twin has it
  float* mid = reinterpret_cast<float*>(smem_b) + CShape<GM>::RING;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = p.CL;
  const int tid = threadIdx.x;
  const Tile t = stack::make_tile(a);
  const int rs_w = t.NBc, rs_h = t.NBc * t.MWc;
  const int co0 = blockIdx.y * TBM;
  const int RR = (((t.RA + CL - 1) / CL) + 63) & ~63;
  const int p_lo = min(t.RA, rank * RR), p_hi = min(t.RA, p_lo + RR);
  const int F2sq = a.F2 * a.F2;
  const int chunks = (a.Cm + kCM - 1) / kCM;
  IWalk wk;
  wk.nsl1 = (a.K1 + kNBK - 1) / kNBK;
  wk.nA = (p_hi - p_lo + kPassMax - 1) / kPassMax * wk.nsl1;
  wk.nB = (kCM * F2sq + S::KB * kNBK - 1) / (S::KB * kNBK);
  const int nsl = (chunks - 1) * (wk.nA + wk.nB) + wk.nA +
                  ((a.Cm - (chunks - 1) * kCM) * F2sq + S::KB * kNBK - 1) /
                      (S::KB * kNBK);

  if (tid >= kI8Consumers) {
    // ---- the producer warpgroup: every stage's copies, x widened ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kI8ProducerRegs));
    const int pt = tid - kI8Consumers;
    const KIdx dk1 = kidx(kNBK, a.F1);
    struct {
      bool ok;          // the runs' position lies in this rank's range
      int ih, iw;       // its first tap's row and column in x
      const int8_t* col;  // its 8 images' column of x
      KIdx k[2];        // each run's (c, dy, dx) at this slice
    } rx;               // this thread's runs of the pass being issued
    IStage is = wk.first(), ws = is;  // the stages to issue and to widen
    auto stage = [&](int sl) {
      const IStage id = is;
      wk.step(is);
      unsigned char* st = stages + (sl % NS) * SLOT;
      const int cm0 = id.chunk * kCM, cmn = min(kCM, a.Cm - cm0);
      if (id.q >= 0) {
        // w2 rows k2 [cm0 F2^2 + KB 16 q, + KB 16) of Co co0 .. co0 + TBM -
        // 1: KB k16 slices, each [16][TBM] swizzled (zeros past K2c)
        const int K2c = cmn * F2sq, k0 = id.q * S::KB * kNBK;
        const long long k2base = (long long)cm0 * F2sq;
        bf16* as = reinterpret_cast<bf16*>(st);
        for (int e = pt; e < S::KB * kNBK * WCH2; e += kI8Producers) {
          const int r = e / WCH2, cq = e - r * WCH2;
          const int k = k0 + r, co = co0 + 8 * cq;
          chunk8(as + (r / kNBK) * kNBK * TBM + mma::swz<TBM>(r % kNBK, cq),
                 k < K2c && co < a.Co ? a.w2 + (k2base + k) * a.w2K + co
                                      : a.w2,
                 k < K2c ? a.Co - co : 0, p.vec_w2 && co + 8 <= a.Co);
        }
        return;
      }
      const int k0 = id.s * kNBK, p0 = p_lo + id.pass * kPassMax;
      const int KRA = p_hi - p0 > 64 ? 128 : 64;
      {  // w1: kNBK rows of 8 chunks, one a thread
        const int r = pt >> 3, cq = pt & 7, k = k0 + r, m = 8 * cq;
        chunk8(reinterpret_cast<bf16*>(st) + mma::swz<kCM>(r, cq),
               k < a.K1 && m < cmn ? a.w1 + (long long)k * a.w1K + cm0 + m
                                   : a.w1,
               k < a.K1 ? cmn - m : 0, p.vec_w1 && m + 8 <= cmn);
      }
      if (p.vec_x) {
        // runs of 8 positions (8 images at one mid position): the bytes.
        // A thread's runs of a pass share a position (run xq of rows xr0,
        // xr0 + 128 / (KRA / 8)): it is decoded once a pass, and each run's
        // tap (c, dy, dx) stepped on by 16 a slice, never divided
        const int kq = KRA / 8, nrun = KRA / 64;
        if (id.s == 0) {
          const int xq = pt & (kq - 1), pp = p0 + 8 * xq;
          const int rr = pp < p_hi ? pp : p_lo;
          const int nl = rr % t.NBc, mq = rr / t.NBc;
          rx.ok = pp < p_hi;
          rx.ih = (t.mh_lo + mq / t.MWc) * a.S1 - a.P1;
          rx.iw = (t.mw_lo + mq % t.MWc) * a.S1 - a.P1;
          rx.col = a.x + (long long)(t.n0 + nl) * a.xs.n;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            rx.k[i] = kidx(pt / kq + i * (kI8Producers / kq), a.F1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= nrun) break;
          const int xq = pt & (kq - 1);
          const int xr = pt / kq + i * (kI8Producers / kq), k = k0 + xr;
          const int h = rx.ih + rx.k[i].dy, w = rx.iw + rx.k[i].dx;
          const bool ok = rx.ok && k < a.K1 && h >= 0 && h < a.H && w >= 0 &&
                          w < a.W;
          mma::cp8(st + S::X8 + xr * KRA + 8 * xq,
                   ok ? rx.col + rx.k[i].c * a.xs.c + h * a.xs.h +
                            w * a.xs.w
                      : a.x,
                   ok);
          kadvance(rx.k[i], dk1, a.F1);
        }
        return;
      }
      // elements, 8 loads a thread issued before any is stored
      unsigned short* bs = reinterpret_cast<unsigned short*>(st + S::XB);
      const int pc = pt % KRA, pp = p0 + pc;
      const int rr = pp < p_hi ? pp : p_lo;
      const int nl = rr % t.NBc, mq = rr / t.NBc;
      const int ih0 = (t.mh_lo + mq / t.MWc) * a.S1 - a.P1;
      const int iw0 = (t.mw_lo + mq % t.MWc) * a.S1 - a.P1;
      const int8_t* xcol = a.x + (long long)(t.n0 + nl) * a.xs.n;
      const int rstep = kI8Producers / KRA;  // rows between a thread's
      for (int i0 = 0; i0 < kNBK * KRA / kI8Producers; i0 += 8) {
        unsigned v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kk = pt / KRA + rstep * (i0 + i), k = k0 + kk;
          const KIdx q = kidx(k, a.F1);
          const int h = ih0 + q.dy, w = iw0 + q.dx;
          const bool ok = pp < p_hi && k < a.K1 && h >= 0 && h < a.H &&
                          w >= 0 && w < a.W;
          v[i] = storage::bf16_bits(
              ok ? xcol + q.c * a.xs.c + h * a.xs.h + w * a.xs.w : a.x, ok);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kk = pt / KRA + rstep * (i0 + i);
          bs[swz_rt(KRA, kk, pc >> 3) + (pc & 7)] =
              static_cast<unsigned short>(v[i]);
        }
      }
    };
    // the runs this thread copied into stage sl, widened into the bf16
    // slice
    auto widen = [&](int sl) {
      const IStage id = ws;
      wk.step(ws);
      if (!p.vec_x || id.q >= 0) return;
      unsigned char* st = stages + (sl % NS) * SLOT;
      const int KRA = p_hi - (p_lo + id.pass * kPassMax) > 64 ? 128 : 64;
      const int kq = KRA / 8, xq = pt & (kq - 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= KRA / 64) break;
        const int xr = pt / kq + i * (kI8Producers / kq);
        *reinterpret_cast<uint4*>(st + S::XB + 2 * swz_rt(KRA, xr, xq)) =
            storage::bf16x8(*reinterpret_cast<const uint2*>(
                st + S::X8 + xr * KRA + 8 * xq));
      }
    };
    // the cluster barrier's phases of chunk pc (after its phase A, after
    // its exchange), once stage `upto` is NS - 1 past its first B stage
    int pc = 0;
    auto phases = [&](int upto) {
      while (pc < chunks && pc * (wk.nA + wk.nB) + wk.nA + NS - 1 <= upto) {
        cluster_wait();
        cluster_arrive();
        cluster_wait();
        if (++pc < chunks) cluster_arrive();
      }
    };
    cluster_arrive();  // chunk 0's first phase
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < nsl) stage(q);
      mma::cp_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      mma::cp_wait<NS - 2>();  // stage sl has landed: widen, announce it
      widen(sl);
      mma::bar_arrive(ring::full_bar(sl % NS), kI8Threads);
      const int nx = sl + NS - 1;
      if (nx < nsl) {
        phases(nx);
        if (nx >= NS) mma::bar_sync(ring::empty_bar<NS>(nx % NS), kI8Threads);
        stage(nx);
      }
      mma::cp_commit();
    }
    phases(nsl + NS);
    return;
  }

  // ---- the consumer warpgroups: both GEMMs, the exchange, the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kI8ConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % GM, wn = warp / GM;  // 64 rows x 32 columns a warp
  const int ar = (lane & 7) + ((lane >> 4) << 3), ac = (lane >> 3) & 1;
  int aoff[4];  // this lane's swizzled ldmatrix offsets in a w2 slice
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    aoff[mt] = mma::swz<TBM>(ar, (wm * 64 + mt * 16) / 8 + ac);
  // phase B: this lane's column of each n tile, wn*32 + 8 nt + g (8 lanes
  // on 8 neighbouring columns: 8 images of one tap where nb >= 8), its slab
  // base and its first tap's mid row and column (-2^20 where the column
  // lies past the tile, so every tap tests outside the mid extent)
  int cbase[4], ohb[4], owb[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const SCol col = scol(a, t, wn * 32 + 8 * nt + g);
    ohb[nt] = col.ok ? col.oh * a.S2 - a.P2 : -(1 << 20);
    owb[nt] = col.ok ? col.ow * a.S2 - a.P2 : -(1 << 20);
    cbase[nt] = col.nl + (ohb[nt] - t.mh_lo) * rs_h + (owb[nt] - t.mw_lo) * rs_w;
  }
  const KIdx dk2 = kidx(kNBK, a.F2);
  const int k16 = wk.nsl1;
  unsigned long long fma_count = 0;

  // conv2's sums: one chain over all of K2 (as K1's narrow build runs one
  // over K1), which leaves the registers to load the next slice's B values
  // while this one's products run
  float tot[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] = 0.f;

  int sl = 0;
  for (int cm0 = 0; cm0 < a.Cm; cm0 += kCM) {
    const int cmn = min(kCM, a.Cm - cm0);
    // local phase B is done with the slab, and the other ranks with my share
    mma::bar_sync(ring::cons_bar<NS>(), kI8Consumers);
    if (cm0 > 0) cluster_wait();

    // ---- phase A: my share of conv1 -> mid slab (cm0 .. cm0+cmn) --------
    for (int p0 = p_lo; p0 < p_hi;) {
      if (p_hi - p0 > 64) {
        conv1_pass_i8<128, NS, SLOT, S::XB>(p, stages, mid, p0, p_hi, cm0, cmn,
                                            tid, k16, sl, nsl);
        fma_count += (unsigned long long)kCM * 128 * k16 * kNBK;
        p0 += 128;
      } else {
        conv1_pass_i8<64, NS, SLOT, S::XB>(p, stages, mid, p0, p_hi, cm0, cmn,
                                           tid, k16, sl, nsl);
        fma_count += (unsigned long long)kCM * 64 * k16 * kNBK;
        p0 += 64;
      }
    }

    // ---- the other ranks' shares, through distributed shared memory -----
    cluster_arrive();  // every rank's share of this chunk is in its slab
    cluster_wait();
    exchange_mid(a, t, cluster, mid, RR, CL, rank, cmn, tid, kI8Consumers);
    cluster_arrive();  // done reading the other ranks' slabs
    mma::bar_sync(ring::cons_bar<NS>(), kI8Consumers);  // the whole slab

    // ---- phase B: conv2's (cm, dy, dx) terms of this chunk --------------
    const int K2c = cmn * F2sq;
    const int nsl2 = (K2c + kNBK - 1) / kNBK;
    // this lane's k rows 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of each slice
    KIdx kr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      kr[i] = kidx(2 * tq + (i & 1) + 8 * (i >> 1), a.F2);
    // B[k][column] of this lane for slice q: the slab at the column's tap
    // (dy, dx) of mid channel c, 0 outside the mid extent (conv2's zero
    // padding) or past the chunk's K2c.  Branch-free: every lane loads
    // (slab word 0 where it reads nothing) and selects, so the 16 loads
    // issue back to back (as a conditional load each, they compiled to a
    // branch and a reconvergence apiece)
    float bv[4][4];  // [k row][n tile]
    auto load_b = [&](int q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = q * kNBK + 2 * tq + (i & 1) + 8 * (i >> 1);
        const int koff = kr[i].c * a.RSTR + kr[i].dy * rs_h + kr[i].dx * rs_w;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bool ok = k < K2c &&
                          static_cast<unsigned>(ohb[nt] + kr[i].dy) <
                              static_cast<unsigned>(a.Ho1) &&
                          static_cast<unsigned>(owb[nt] + kr[i].dx) <
                              static_cast<unsigned>(a.Wo1);
          const float v = mid[ok ? koff + cbase[nt] : 0];
          bv[i][nt] = ok ? v : 0.f;
        }
        kadvance(kr[i], dk2, a.F2);
      }
    };
    load_b(0);
    for (int qs = 0; qs < nsl2; qs += S::KB, ++sl) {
      const int buf = sl % NS;
      mma::bar_sync(ring::full_bar(buf), kI8Threads);
#pragma unroll
      for (int j = 0; j < S::KB; ++j) {
        const int q = qs + j;  // the k16 slice
        if (q >= nsl2) break;
        unsigned bf[4][6];  // per n tile: (hi, md, lo) of b0, then of b1
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          split3(bv[0][nt], bv[1][nt], bf[nt][0], bf[nt][1], bf[nt][2]);
          split3(bv[2][nt], bv[3][nt], bf[nt][3], bf[nt][4], bf[nt][5]);
        }
        if (q + 1 < nsl2) load_b(q + 1);  // in flight during the products
        const bf16* as = reinterpret_cast<const bf16*>(stages + buf * SLOT) +
                         j * kNBK * TBM;
        unsigned af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma::ldsm_x4_t(af[mt], as + aoff[mt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            float (&c)[4] = tot[mt][nt];
            mma::mma_bf16(c, af[mt], bf[nt][2], bf[nt][5]);
            mma::mma_bf16(c, af[mt], bf[nt][1], bf[nt][4]);
            mma::mma_bf16(c, af[mt], bf[nt][0], bf[nt][3]);
          }
      }
      if (sl + NS < nsl)
        mma::bar_arrive(ring::empty_bar<NS>(buf), kI8Threads);
    }
    fma_count += (unsigned long long)TBM * TBN * nsl2 * kNBK;
  }
  cluster_wait();  // no rank reads my slab any more
  mma::bar_sync(ring::cons_bar<NS>(), kI8Consumers);  // the pool tile
                                                      // overlays the slab
  if (p.stats && tid == 0) {
    atomicAdd(p.stats, 2ull * fma_count);
    atomicMax(p.stats + 1, (unsigned long long)cluster.num_blocks());
  }
  constexpr int TSTR = TBN + 1;
  float* Ts = mid;
  tile_epilogue<POOL, GM, false>(a, t, tot, Ts, TSTR, co0, tid);
  if (POOL) {
    mma::bar_sync(ring::cons_bar<NS>(), kI8Consumers);
    pool_tile(a, t, Ts, TSTR, TBM, co0, tid, kI8Consumers);
  }
}

// ---- the int8->fp32 build: warp-specialised, on the tensor cores ----------
//
// Instantiated only by the int8->fp32 build (launch below).  The float32
// kernel above on int8 x: fp32 FMA on the CUDA cores (67 TFLOP/s), 256
// threads that both copy and multiply around a __syncthreads a slice, each
// x quad a blocking 4-byte load widened in registers.  On VGG16 b32's
// conv1 pair (118.4 of its 123.9 GFLOP in conv2) it bounds the row at
// 1.85 ms, where the tensor cores at fp32 accuracy bound it near 0.73.
//
// Design: the int8->bf16 kernel's skeleton (cluster_stack_i8bf16_kernel):
// the cluster, its DSMEM exchange (exchange_mid), the tiles, the cluster
// size, the passes, the epilogue (tile_epilogue, pool_tile) and the
// counted FLOPs are the float32 kernel's; 384 threads on conv_ring.cuh's
// barriers, NS stages of SLOT bytes inside the twin's ring (FShape).
//
//   one producer warpgroup keeps every global copy in flight, NS - 1
//   stages ahead across passes, phases and chunks.  Phase A's stage is a
//   k16 slice: w1 [16][64] float32 (rows of 64 + 4 floats) by 16-byte
//   cp.async, and x as the int8->bf16 kernel takes it (runs of 8 images by
//   one 8-byte cp.async into the bytes, widened by the thread that copied
//   them into the swizzled bf16 slice, exact; elsewhere 8 element loads
//   issued together).  Phase B's stage is KB8 = 4 / GM k8 slices of w2
//   [8][TBM] float32 (rows of TBM + 8 floats) by 16-byte cp.async.
//
//   two consumer warpgroups.  conv1 (conv1_pass_f32): each w1 pair cut
//   into three bf16 parts in registers (storage::split3: hi, md, lo, sum
//   exact, as K1 int8->fp32 does), three m16n8k16 products a term of exact
//   bf16 values with the exact bf16 x from ldmatrix.trans, a chain of 32
//   terms (two k16 slices) flushed into fp32 registers, mma rows g and g +
//   8 mid channels 2g and 2g + 1 so a fragment pair is one float2 load;
//   bias1 and ReLU in fp32, the mid slab float32.  conv2 (conv2_3xtf32, a
//   function over a float32 mid and float32 w2 rings): 3xTF32 mma.sync
//   m16n8k8 (split_tf32 of both operands: small.big + big.small +
//   big.big), the B values read straight from the slab, branch-free (every
//   load made, its value selected), the next k8 slice's in flight during
//   this one's products; chains of 32 terms flushed into fp32 registers
//   (the tensor core truncates as it accumulates).  3xTF32 and not six
//   bf16 products (split3 of both operands): the same tensor time (a
//   m16n8k8 TF32 product takes a m16n8k16 bf16 one's), but two parts of
//   each operand where split3 makes three, in two integer ops each: fewer
//   registers beside the chain and its sums.
//
// What bounds it: operations on the tensor cores, three bf16 products a
// conv1 term (989 TFLOP/s) and three TF32 products a conv2 term (495); on
// VGG16 b32's conv1 pair about 0.73 ms.  On the card (timed apart with
// tools/timing_variants.py, PERF.md) it runs ~3.9 ms: ~1.7 without its
// products (phase A at its producers' pace, as in the int8->bf16 kernel,
// the exchange, the epilogue), ~3.35 without its copies; the products run
// after phase A, not beside it (one block an SM), at a third of their
// bound, and their order (chains interleaved or not) changes nothing.
constexpr int kFConsumerRegs = 216;  // setmaxnreg, as the int8->bf16 kernel
constexpr int kFProducerRegs = 72;
constexpr int kW1F = kCM + 4;        // float row stride of a w1 slice

template <int GM>
struct FShape {
  static constexpr int TBM = 64 * GM, TBN = kTile / TBM;
  static constexpr int W2S = TBM + 8;  // float row stride of a w2 slice
  static constexpr int KB8 = 4 / GM;   // k8 slices of a phase-B stage
  // byte offsets in a stage: phase A's x bf16 slice and x bytes (after the
  // w1 slice at 0); phase B's KB8 w2 slices from 0
  static constexpr int XB = kNBK * kW1F * 4;
  static constexpr int X8 = XB + kNBK * kPassMax * 2;
  static constexpr int A_BYTES = X8 + kNBK * kPassMax;
  static constexpr int B_BYTES = KB8 * 8 * W2S * 4;
  static constexpr int SLOT = A_BYTES > B_BYTES ? A_BYTES : B_BYTES;
  // as many stages as the twin's ring holds (the slab stays where it is)
  static constexpr int NS = 4 * CShape<GM>::RING / SLOT;
  static_assert(NS >= 3 && NS * SLOT <= 4 * CShape<GM>::RING,
                "the stages fit the twin's ring");
  static_assert(XB % 128 == 0 && SLOT % 128 == 0,
                "bf16 slices on 128-byte rows (the swizzle's)");
};

// One conv1 pass of the int8->fp32 consumers: the [kCM x KRA] GEMM of mid
// positions [p0, p0 + KRA) over K1 from the ring's stages sl .. sl + nsl1
// - 1 (w1 float32 in three bf16 parts, x bf16), bias1 and ReLU into the
// slab
template <int KRA, int NS, int SLOT, int XB>
__device__ __forceinline__ void conv1_pass_f32(
    const ClusterArgs<float, int8_t>& p, const unsigned char* stages,
    float* mid, int p0, int p_hi, int cm0, int cmn, int tid, int nsl1,
    int& sl, int nsl) {
  using storage::bf16;
  constexpr int NTA = KRA / 32;  // n8 tiles of a warp (2 x 4 warps)
  const StackArgs<float, int8_t>& a = p.s;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 32 mid channels, KRA/4 positions
  const int br = (lane & 7) + (((lane >> 3) & 1) << 3), bc = lane >> 4;
  // this lane's w1 float2 (mid channels 2g, 2g + 1 of each 16) at k 2tq
  const int aoff = 2 * tq * kW1F + wm * 32 + 2 * g;
  int boff[NTA / 2];
#pragma unroll
  for (int np = 0; np < NTA / 2; ++np)
    boff[np] = mma::swz<KRA>(br, (wn * (KRA / 4) + np * 16) / 8 + bc);
  float acc[2][NTA][4], chain[2][NTA][4];  // the pass's sums; a chain
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = chain[mt][nt][e] = 0.f;
  for (int s = 0; s < nsl1; ++s, ++sl) {
    const int buf = sl % NS;
    mma::bar_sync(ring::full_bar(buf), kI8Threads);
    const float* as = reinterpret_cast<const float*>(stages + buf * SLOT);
    const bf16* bs = reinterpret_cast<const bf16*>(stages + buf * SLOT + XB);
    // w1's three parts: a0 (row g: k 2tq, 2tq + 1), a1 (row g + 8), a2, a3
    // (k + 8); rows g and g + 8 are mid channels 2g and 2g + 1
    unsigned ahi[2][4], amd[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* pa = as + aoff + mt * 16;
      const float2 k0 = *reinterpret_cast<const float2*>(pa);
      const float2 k1 = *reinterpret_cast<const float2*>(pa + kW1F);
      const float2 k8 = *reinterpret_cast<const float2*>(pa + 8 * kW1F);
      const float2 k9 = *reinterpret_cast<const float2*>(pa + 9 * kW1F);
      split3(k0.x, k1.x, ahi[mt][0], amd[mt][0], alo[mt][0]);
      split3(k0.y, k1.y, ahi[mt][1], amd[mt][1], alo[mt][1]);
      split3(k8.x, k9.x, ahi[mt][2], amd[mt][2], alo[mt][2]);
      split3(k8.y, k9.y, ahi[mt][3], amd[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NTA; nt += 2) {
      unsigned bq[4];
      mma::ldsm_x4_t(bq, bs + boff[nt / 2]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float (&c)[4] = chain[mt][nt + h];
          mma::mma_bf16(c, alo[mt], bq[2 * h], bq[2 * h + 1]);
          mma::mma_bf16(c, amd[mt], bq[2 * h], bq[2 * h + 1]);
          mma::mma_bf16(c, ahi[mt], bq[2 * h], bq[2 * h + 1]);
        }
    }
    if (sl + NS < nsl) mma::bar_arrive(ring::empty_bar<NS>(buf), kI8Threads);
    if ((s & 1) || s == nsl1 - 1) {  // flush the chain: 32 terms
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nt][e] += chain[mt][nt][e];
            chain[mt][nt][e] = 0.f;
          }
    }
  }
  // bias, ReLU, into my range of the slab; accumulator e of (mt, nt) is
  // mid channel wm*32 + mt*16 + 2g + (e >= 2), position wn*KRA/4 + nt*8 +
  // 2 tq + (e & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cml = wm * 32 + mt * 16 + 2 * g + h;
      if (cml >= cmn) continue;
      const float b = a.b1 ? storage::ld(a.b1 + cm0 + cml) : 0.f;
#pragma unroll
      for (int nt = 0; nt < NTA; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = p0 + wn * (KRA / 4) + nt * 8 + 2 * tq + e;
          if (r >= p_hi) continue;
          float v = acc[mt][nt][2 * h + e] + b;
          if (a.relu1) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
          mid[cml * a.RSTR + r] = v;
        }
    }
}

// conv2's terms of one chunk at fp32 accuracy on the tensor cores, for a
// warp of a block's 256 consumers (64 x 32 of the TBM x TBN tile: 4 x 4
// m16n8 tiles): 3xTF32 mma.sync m16n8k8 over K2c = cmn F2^2 terms, from
// the float32 mid slab (B, read straight from it) and float32 w2 k8
// slices [8][W2S] (A, KB8 of them a ring stage of SLOT bytes, stages sl
// ..), chains of 32 terms flushed into tot.  cbase, ohb, owb: this lane's
// column (wn*32 + 8 nt + g) of each n tile: its slab base and its first
// tap's mid row and column (-2^20 past the tile); rs_h, rs_w the slab's
// row and column strides.
template <int GM, int NS, int SLOT, int KB8, int W2S, int NTHREADS,
          typename E, typename X>
__device__ __forceinline__ void conv2_3xtf32(
    const StackArgs<E, X>& a, const float* mid, const unsigned char* stages,
    int K2c, const int (&cbase)[4], const int (&ohb)[4], const int (&owb)[4],
    int rs_h, int rs_w, float (&tot)[4][4][4], int tid, int& sl, int nsl) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % GM;
  const int nsl2 = (K2c + 7) / 8;  // k8 slices
  const KIdx dk = kidx(8, a.F2);
  // this lane's k rows tq, tq + 4 of each slice
  KIdx kr[2] = {kidx(tq, a.F2), kidx(tq + 4, a.F2)};
  // B[k][column] of this lane for slice q: the slab at the column's tap
  // (dy, dx) of mid channel c, 0 outside the mid extent (conv2's zero
  // padding) or past K2c.  Branch-free: every lane loads (slab word 0
  // where it reads nothing) and selects
  float bv[2][4];  // [k row][n tile]
  auto load_b = [&](int q) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 8 * q + tq + 4 * i;
      const int koff = kr[i].c * a.RSTR + kr[i].dy * rs_h + kr[i].dx * rs_w;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bool ok = k < K2c &&
                        static_cast<unsigned>(ohb[nt] + kr[i].dy) <
                            static_cast<unsigned>(a.Ho1) &&
                        static_cast<unsigned>(owb[nt] + kr[i].dx) <
                            static_cast<unsigned>(a.Wo1);
        const float v = mid[ok ? koff + cbase[nt] : 0];
        bv[i][nt] = ok ? v : 0.f;
      }
      kadvance(kr[i], dk, a.F2);
    }
  };
  float chain[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) chain[mt][nt][e] = 0.f;
  load_b(0);
  for (int qs = 0; qs < nsl2; qs += KB8, ++sl) {
    const int buf = sl % NS;
    mma::bar_sync(ring::full_bar(buf), NTHREADS);
#pragma unroll
    for (int j = 0; j < KB8; ++j) {
      const int q = qs + j;  // the k8 slice
      if (q >= nsl2) break;
      unsigned bbig[4][2], bsmall[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma::split_tf32(bv[i][nt], bbig[nt][i], bsmall[nt][i]);
      if (q + 1 < nsl2) load_b(q + 1);  // in flight during the products
      const float* as = reinterpret_cast<const float*>(stages + buf * SLOT) +
                        j * 8 * W2S + tq * W2S + wm * 64 + g;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // a0 (row g, k tq), a1 (row g + 8), a2 (k tq + 4), a3
        unsigned abig[4], asmall[4];
        const float* pa = as + mt * 16;
        mma::split_tf32(pa[0], abig[0], asmall[0]);
        mma::split_tf32(pa[8], abig[1], asmall[1]);
        mma::split_tf32(pa[4 * W2S], abig[2], asmall[2]);
        mma::split_tf32(pa[4 * W2S + 8], abig[3], asmall[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float (&c)[4] = chain[mt][nt];
          mma::mma_tf32(c, asmall, bbig[nt][0], bbig[nt][1], c);
          mma::mma_tf32(c, abig, bsmall[nt][0], bsmall[nt][1], c);
          mma::mma_tf32(c, abig, bbig[nt][0], bbig[nt][1], c);
        }
      }
      if ((q & 3) == 3 || q == nsl2 - 1) {  // flush the chain: 32 terms
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[mt][nt][e] += chain[mt][nt][e];
              chain[mt][nt][e] = 0.f;
            }
      }
    }
    if (sl + NS < nsl) mma::bar_arrive(ring::empty_bar<NS>(buf), NTHREADS);
  }
}

template <bool POOL, int GM>
__global__ void __launch_bounds__(kI8Threads, 1)
cluster_stack_i8f32_kernel(const ClusterArgs<float, int8_t> p) {
  using storage::bf16;
  using S = FShape<GM>;
  constexpr int NS = S::NS, SLOT = S::SLOT;
  constexpr int TBM = S::TBM, TBN = S::TBN;
  constexpr int WQ2 = TBM / 4;  // 16-byte quads of a w2 row
  const StackArgs<float, int8_t>& a = p.s;
  extern __shared__ __align__(128) unsigned char smem_f[];
  unsigned char* stages = smem_f;  // the ring: NS stages of SLOT bytes
  // [kCM][RSTR] slab; later the pool tile: where the twin has it
  float* mid = reinterpret_cast<float*>(smem_f) + CShape<GM>::RING;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = p.CL;
  const int tid = threadIdx.x;
  const Tile t = stack::make_tile(a);
  const int rs_w = t.NBc, rs_h = t.NBc * t.MWc;
  const int co0 = blockIdx.y * TBM;
  const int RR = (((t.RA + CL - 1) / CL) + 63) & ~63;
  const int p_lo = min(t.RA, rank * RR), p_hi = min(t.RA, p_lo + RR);
  const int F2sq = a.F2 * a.F2;
  const int chunks = (a.Cm + kCM - 1) / kCM;
  constexpr int BK = S::KB8 * 8;  // k2 terms of a phase-B stage
  IWalk wk;
  wk.nsl1 = (a.K1 + kNBK - 1) / kNBK;
  wk.nA = (p_hi - p_lo + kPassMax - 1) / kPassMax * wk.nsl1;
  wk.nB = (kCM * F2sq + BK - 1) / BK;
  const int nsl = (chunks - 1) * (wk.nA + wk.nB) + wk.nA +
                  ((a.Cm - (chunks - 1) * kCM) * F2sq + BK - 1) / BK;

  if (tid >= kI8Consumers) {
    // ---- the producer warpgroup: every stage's copies, x widened ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kFProducerRegs));
    const int pt = tid - kI8Consumers;
    const KIdx dk1 = kidx(kNBK, a.F1);
    struct {
      bool ok;          // the runs' position lies in this rank's range
      int ih, iw;       // its first tap's row and column in x
      const int8_t* col;  // its 8 images' column of x
      KIdx k[2];        // each run's (c, dy, dx) at this slice
    } rx;               // this thread's runs of the pass being issued
    IStage is = wk.first(), ws = is;  // the stages to issue and to widen
    auto stage = [&](int sl) {
      const IStage id = is;
      wk.step(is);
      unsigned char* st = stages + (sl % NS) * SLOT;
      const int cm0 = id.chunk * kCM, cmn = min(kCM, a.Cm - cm0);
      if (id.q >= 0) {
        // w2 rows k2 [cm0 F2^2 + BK q, + BK) of Co co0 .. co0 + TBM - 1:
        // KB8 k8 slices [8][W2S] (zeros past K2c and Co)
        const int K2c = cmn * F2sq, k0 = id.q * BK;
        const long long k2base = (long long)cm0 * F2sq;
        float* as = reinterpret_cast<float*>(st);
        for (int e = pt; e < BK * WQ2; e += kI8Producers) {
          const int r = e / WQ2, cq = e - r * WQ2;
          const int k = k0 + r, co = co0 + 4 * cq;
          ring::copy_quad(as + r * S::W2S + 4 * cq,
                          a.w2 + (k2base + k) * a.w2K + co, a.w2,
                          k < K2c && co < a.Co ? min(4, a.Co - co) : 0,
                          p.vec_w2);
        }
        return;
      }
      const int k0 = id.s * kNBK, p0 = p_lo + id.pass * kPassMax;
      const int KRA = p_hi - p0 > 64 ? 128 : 64;
      // w1: kNBK rows of 16 quads, two a thread
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = pt + i * kI8Producers;
        const int r = e >> 4, m = 4 * (e & 15), k = k0 + r;
        ring::copy_quad(reinterpret_cast<float*>(st) + r * kW1F + m,
                        a.w1 + (long long)k * a.w1K + cm0 + m, a.w1,
                        k < a.K1 ? min(4, cmn - m) : 0, p.vec_w1);
      }
      if (p.vec_x) {
        // runs of 8 positions (8 images at one mid position): the bytes.
        // A thread's runs of a pass share a position (run xq of rows xr0,
        // xr0 + 128 / (KRA / 8)): it is decoded once a pass, and each run's
        // tap (c, dy, dx) stepped on by 16 a slice, never divided
        const int kq = KRA / 8, nrun = KRA / 64;
        if (id.s == 0) {
          const int xq = pt & (kq - 1), pp = p0 + 8 * xq;
          const int rr = pp < p_hi ? pp : p_lo;
          const int nl = rr % t.NBc, mq = rr / t.NBc;
          rx.ok = pp < p_hi;
          rx.ih = (t.mh_lo + mq / t.MWc) * a.S1 - a.P1;
          rx.iw = (t.mw_lo + mq % t.MWc) * a.S1 - a.P1;
          rx.col = a.x + (long long)(t.n0 + nl) * a.xs.n;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            rx.k[i] = kidx(pt / kq + i * (kI8Producers / kq), a.F1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= nrun) break;
          const int xq = pt & (kq - 1);
          const int xr = pt / kq + i * (kI8Producers / kq), k = k0 + xr;
          const int h = rx.ih + rx.k[i].dy, w = rx.iw + rx.k[i].dx;
          const bool ok = rx.ok && k < a.K1 && h >= 0 && h < a.H && w >= 0 &&
                          w < a.W;
          mma::cp8(st + S::X8 + xr * KRA + 8 * xq,
                   ok ? rx.col + rx.k[i].c * a.xs.c + h * a.xs.h +
                            w * a.xs.w
                      : a.x,
                   ok);
          kadvance(rx.k[i], dk1, a.F1);
        }
        return;
      }
      // elements, 8 loads a thread issued before any is stored
      unsigned short* bs = reinterpret_cast<unsigned short*>(st + S::XB);
      const int pc = pt % KRA, pp = p0 + pc;
      const int rr = pp < p_hi ? pp : p_lo;
      const int nl = rr % t.NBc, mq = rr / t.NBc;
      const int ih0 = (t.mh_lo + mq / t.MWc) * a.S1 - a.P1;
      const int iw0 = (t.mw_lo + mq % t.MWc) * a.S1 - a.P1;
      const int8_t* xcol = a.x + (long long)(t.n0 + nl) * a.xs.n;
      const int rstep = kI8Producers / KRA;  // rows between a thread's
      for (int i0 = 0; i0 < kNBK * KRA / kI8Producers; i0 += 8) {
        unsigned v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kk = pt / KRA + rstep * (i0 + i), k = k0 + kk;
          const KIdx q = kidx(k, a.F1);
          const int h = ih0 + q.dy, w = iw0 + q.dx;
          const bool ok = pp < p_hi && k < a.K1 && h >= 0 && h < a.H &&
                          w >= 0 && w < a.W;
          v[i] = storage::bf16_bits(
              ok ? xcol + q.c * a.xs.c + h * a.xs.h + w * a.xs.w : a.x, ok);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kk = pt / KRA + rstep * (i0 + i);
          bs[swz_rt(KRA, kk, pc >> 3) + (pc & 7)] =
              static_cast<unsigned short>(v[i]);
        }
      }
    };
    // the runs this thread copied into stage sl, widened into the bf16
    // slice
    auto widen = [&](int sl) {
      const IStage id = ws;
      wk.step(ws);
      if (!p.vec_x || id.q >= 0) return;
      unsigned char* st = stages + (sl % NS) * SLOT;
      const int KRA = p_hi - (p_lo + id.pass * kPassMax) > 64 ? 128 : 64;
      const int kq = KRA / 8, xq = pt & (kq - 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= KRA / 64) break;
        const int xr = pt / kq + i * (kI8Producers / kq);
        *reinterpret_cast<uint4*>(st + S::XB + 2 * swz_rt(KRA, xr, xq)) =
            storage::bf16x8(*reinterpret_cast<const uint2*>(
                st + S::X8 + xr * KRA + 8 * xq));
      }
    };
    // the cluster barrier's phases of chunk pc (after its phase A, after
    // its exchange), once stage `upto` is NS - 1 past its first B stage
    int pc = 0;
    auto phases = [&](int upto) {
      while (pc < chunks && pc * (wk.nA + wk.nB) + wk.nA + NS - 1 <= upto) {
        cluster_wait();
        cluster_arrive();
        cluster_wait();
        if (++pc < chunks) cluster_arrive();
      }
    };
    cluster_arrive();  // chunk 0's first phase
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < nsl) stage(q);
      mma::cp_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      mma::cp_wait<NS - 2>();  // stage sl has landed: widen, announce it
      widen(sl);
      mma::bar_arrive(ring::full_bar(sl % NS), kI8Threads);
      const int nx = sl + NS - 1;
      if (nx < nsl) {
        phases(nx);
        if (nx >= NS) mma::bar_sync(ring::empty_bar<NS>(nx % NS), kI8Threads);
        stage(nx);
      }
      mma::cp_commit();
    }
    phases(nsl + NS);
    return;
  }

  // ---- the consumer warpgroups: both GEMMs, the exchange, the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kFConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const int wn = warp / GM;  // 64 rows x 32 columns a warp
  // phase B: this lane's column of each n tile, wn*32 + 8 nt + g, its slab
  // base and its first tap's mid row and column (-2^20 where the column
  // lies past the tile, so every tap tests outside the mid extent)
  int cbase[4], ohb[4], owb[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const SCol col = scol(a, t, wn * 32 + 8 * nt + g);
    ohb[nt] = col.ok ? col.oh * a.S2 - a.P2 : -(1 << 20);
    owb[nt] = col.ok ? col.ow * a.S2 - a.P2 : -(1 << 20);
    cbase[nt] = col.nl + (ohb[nt] - t.mh_lo) * rs_h + (owb[nt] - t.mw_lo) * rs_w;
  }
  const int k16 = wk.nsl1;
  unsigned long long fma_count = 0;
  float tot[4][4][4];  // conv2's sums
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] = 0.f;

  int sl = 0;
  for (int cm0 = 0; cm0 < a.Cm; cm0 += kCM) {
    const int cmn = min(kCM, a.Cm - cm0);
    // local phase B is done with the slab, and the other ranks with my share
    mma::bar_sync(ring::cons_bar<NS>(), kI8Consumers);
    if (cm0 > 0) cluster_wait();

    // ---- phase A: my share of conv1 -> mid slab (cm0 .. cm0+cmn) --------
    for (int p0 = p_lo; p0 < p_hi;) {
      if (p_hi - p0 > 64) {
        conv1_pass_f32<128, NS, SLOT, S::XB>(p, stages, mid, p0, p_hi, cm0,
                                             cmn, tid, k16, sl, nsl);
        fma_count += (unsigned long long)kCM * 128 * k16 * kNBK;
        p0 += 128;
      } else {
        conv1_pass_f32<64, NS, SLOT, S::XB>(p, stages, mid, p0, p_hi, cm0,
                                            cmn, tid, k16, sl, nsl);
        fma_count += (unsigned long long)kCM * 64 * k16 * kNBK;
        p0 += 64;
      }
    }

    // ---- the other ranks' shares, through distributed shared memory -----
    cluster_arrive();  // every rank's share of this chunk is in its slab
    cluster_wait();
    exchange_mid(a, t, cluster, mid, RR, CL, rank, cmn, tid, kI8Consumers);
    cluster_arrive();  // done reading the other ranks' slabs
    mma::bar_sync(ring::cons_bar<NS>(), kI8Consumers);  // the whole slab

    // ---- phase B: conv2's (cm, dy, dx) terms of this chunk --------------
    const int K2c = cmn * F2sq;
    conv2_3xtf32<GM, NS, SLOT, S::KB8, S::W2S, kI8Threads>(
        a, mid, stages, K2c, cbase, ohb, owb, rs_h, rs_w, tot, tid, sl, nsl);
    // the twin's count: k16 granules
    fma_count += (unsigned long long)TBM * TBN * ((K2c + kNBK - 1) / kNBK) *
                 kNBK;
  }
  cluster_wait();  // no rank reads my slab any more
  mma::bar_sync(ring::cons_bar<NS>(), kI8Consumers);  // the pool tile
                                                      // overlays the slab
  if (p.stats && tid == 0) {
    atomicAdd(p.stats, 2ull * fma_count);
    atomicMax(p.stats + 1, (unsigned long long)cluster.num_blocks());
  }
  constexpr int TSTR = TBN + 1;
  float* Ts = mid;
  tile_epilogue<POOL, GM, false>(a, t, tot, Ts, TSTR, co0, tid);
  if (POOL) {
    mma::bar_sync(ring::cons_bar<NS>(), kI8Consumers);
    pool_tile(a, t, Ts, TSTR, TBM, co0, tid, kI8Consumers);
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

template <bool POOL, int GM, typename E, typename X>
int launch(const ClusterArgs<E, X>& p, dim3 grid, cudaStream_t st,
           int* clusters) {
  const long long bytes = smem_bytes<GM>(p.s.RSTR, POOL);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // where w is bf16 the build runs its own kernel (on the bf16 tensor
  // cores), int8 x with bf16 w another (warp-specialised, 384 threads)
  void (*kernel)(ClusterArgs<E, X>);
  int threads = kThreads;
  if constexpr (std::is_same<E, storage::bf16>::value &&
                std::is_same<X, int8_t>::value) {
    kernel = cluster_stack_i8bf16_kernel<POOL, GM>;
    threads = kI8Threads;
  } else if constexpr (std::is_same<X, int8_t>::value) {
    kernel = cluster_stack_i8f32_kernel<POOL, GM>;
    threads = kI8Threads;
  } else if constexpr (std::is_same<E, storage::bf16>::value) {
    kernel = cluster_stack_bf16_kernel<X, POOL, GM>;
  } else {
    kernel = cluster_stack_kernel<E, X, POOL, GM>;
  }
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
  cfg.blockDim = dim3(threads);
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

template <bool POOL, typename E, typename X>
int dispatch(const ClusterArgs<E, X>& p, int gm, dim3 grid, cudaStream_t st,
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

template <typename E, typename X>
int forward(const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, const void* res, void* y, int N, int Ci, int H,
            int W, int Cm, int F1, int S1, int P1, int Co, int F2, int S2,
            int P2, int pool_F, int pool_S, int pool_avg, int relu1,
            int relu2, int src_nchw, int dst_nchw, int res_nchw, int bm,
            int nb, int uth, int utw, int cl, void* stats, void* stream,
            int* clusters) {
  ClusterArgs<E, X> p;
  StackArgs<E, X>& a = p.s;
  a.x = static_cast<const X*>(x);
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
  // runs of 4 float32 or 8 bf16 elements: 16 bytes of the ring, from kRun
  // elements of x (int8: 8 bytes, aligned to that; both int8 kernels copy
  // runs of 8 images)
  constexpr int kRun = 16 / static_cast<int>(sizeof(E));
  constexpr int kXN = std::is_same<X, int8_t>::value ? 8 : kRun;
  constexpr uintptr_t kXRun = kXN * sizeof(X);
  p.vec_x = !src_nchw && N % kXN == 0 && nb % kXN == 0 &&
            reinterpret_cast<uintptr_t>(x) % kXRun == 0;
  p.vec_w1 = Cm % kRun == 0 && al16(w1);
  p.vec_w2 = Co % kRun == 0 && al16(w2);
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
// added to [0], the cluster size it ran with goes to [1].  x is REPRO_XT,
// every other tensor REPRO_WT (storage.cuh: conv_stack_chwn_forward is
// float32, conv_stack_chwn_forward_bf16 bf16, _i8f32 and _i8bf16 int8 x
// with float32 or bf16 w).  Returns a cudaError_t code.
extern "C" int REPRO_ENTRY(conv_stack_chwn_forward)(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* res, void* y, int N, int Ci, int H, int W,
    int Cm, int F1, int S1, int P1, int Co, int F2, int S2, int P2,
    int pool_F, int pool_S, int pool_avg, int relu1, int relu2, int src_nchw,
    int dst_nchw, int res_nchw, int bm, int nb, int uth, int utw, int cl,
    void* stats, void* stream) {
  return repro::stack_cluster::forward<REPRO_WT, REPRO_XT>(
      x, w1, b1, w2, b2, res, y, N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2,
      pool_F, pool_S, pool_avg, relu1, relu2, src_nchw, dst_nchw, res_nchw,
      bm, nb, uth, utw, cl, stats, stream, nullptr);
}

// How many clusters of the tile above can be resident on the device at once
// (cudaOccupancyMaxActiveClusters of this build's kernel: the builds'
// kernels differ in registers), into *clusters.  Returns a cudaError_t.
extern "C" int REPRO_ENTRY(conv_stack_chwn_max_clusters)(
    int N, int Ci, int H, int W, int Cm, int F1, int S1, int P1, int Co,
    int F2, int S2, int P2, int pool_F, int pool_S, int bm, int nb, int uth,
    int utw, int cl, int* clusters) {
  *clusters = 0;
  return repro::stack_cluster::forward<REPRO_WT, REPRO_XT>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, N, Ci,
      H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool_F, pool_S, 0, 1, 1, 0, 0, 0,
      bm, nb, uth, utw, cl, nullptr, nullptr, clusters);
}
