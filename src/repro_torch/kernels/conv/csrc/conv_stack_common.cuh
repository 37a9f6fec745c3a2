// Fused conv -> conv stack of the NCHW engine K5b (conv_stack_nchw.cu);
// the CHWN engine K5a (conv_stack_chwn.cu) runs its own cluster kernel on
// the tile and column helpers here (StackArgs, make_tile, scol, mid_span).
// The K5b kernel (its host entry is in conv_stack_nchw.cu): conv1
// [+bias1] [+ReLU] into a mid activation that never leaves the SM, then
// conv2 with the full epilogue of the single-conv kernels (bias2 ->
// residual -> ReLU -> max/avg pool), reading x in the producer's layout
// and writing y in the consumer's.  fp32 FMA on the CUDA cores, fp32
// accumulation.
//
// A block owns one conv2 output tile: TBM output channels by TBN GEMM
// columns, where the columns are NB images x UTH x UTW units x T taps (a
// unit is one conv2 output, or one pooled output whose T = pF*pF taps are
// the conv2 outputs of its window, as in conv_common.cuh).  Its 256
// threads each keep a (4*GM) x (4*GN) register tile of that product
// (TBM = 64*GM, TBN = 64*GN, GM*GN = 4).  The reduction over conv2's
// K2 = Cm*F2*F2 runs in chunks of kCM mid channels:
//
//   phase A (conv1): the chunk's mid slab over the block's mid box (the
//     conv2 tile plus its (F2-1) halo, clipped to the real mid extent) is
//     an implicit GEMM [kCM x box positions] over K1 = Ci*F1*F1, computed
//     in passes of kRA positions with a 4 x 8 register tile per thread;
//     bias1 and ReLU are applied and the slab is stored in shared memory;
//   phase B (conv2): the chunk's (cm, dy, dx) terms are gathered from
//     that slab into the same shared-memory GEMM tiles and accumulated
//     into the output registers.
//
// Mid positions outside [0, Ho1) x [0, Wo1) are conv2's zero padding: they
// are never computed and read as 0 (a window just outside the edge would
// give nonzero conv1 values).  Conv1 is recomputed for the halo of each
// tile and once per TBM-wide slice of Co; the wrapper picks the tile
// (bm, nb, uth, utw) that minimises that work (ops.py::stack_tiling).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "conv_common.cuh"  // Strides, layout_strides

namespace repro {
namespace stack {

constexpr int kThreads = 256;
constexpr int kBK = 8;      // reduction slice
constexpr int kCM = 64;     // mid channels per chunk (phase A rows)
constexpr int kRA = 128;    // mid positions per phase-A pass (phase A cols)
constexpr int kTile = 16384;  // TBM * TBN
constexpr int kMaxSmem = 232448;  // 227 KB, what an H100 block may use

struct StackArgs {
  const float* x;
  const float* w1;  // w1[cm * w1O + k1 * w1K], k1 = (ci, dy, dx)
  const float* b1;  // [Cm] or null
  const float* w2;  // w2[co * w2O + k2 * w2K], k2 = (cm, dy, dx)
  const float* b2;  // [Co] or null
  const float* res; // conv2-output (pre-pool) shape, or null
  float* y;
  int N, Ci, H, W, Cm, F1, S1, P1, K1, Ho1, Wo1;
  int Co, F2, S2, P2, Ho2, Wo2;
  int pF, pS, pool_avg, relu1, relu2, T;
  int UH, UW;          // unit grid: the pooled output, or conv2's output
  int NB, UTH, UTW, BU;  // block tile in units (BU = NB*UTH*UTW)
  int nTH, nTW;        // tiles along the unit rows / cols
  int RSTR;            // mid slab row stride: the unclipped box size
  int w1O, w1K, w2O, w2K;
  Strides xs, ys, rs;
};

// one block's tile: its first image/unit, how much of it is real, and the
// clipped mid box it reads (index r = nl*rs_n + mhl*rs_h + mwl*rs_w)
struct Tile {
  int n0, uh0, uw0, NBc, UTHc, UTWc;
  int mh_lo, mw_lo, MHc, MWc, RA;
  int rs_n, rs_h, rs_w;
};

// mid rows [lo, lo + count) that conv2 outputs o0 .. o0+on-1 read, clipped
// to the real mid extent [0, M1)
__device__ __forceinline__ void mid_span(int o0, int on, int S2, int P2,
                                         int F2, int M1, int& lo, int& cnt) {
  const int m0 = o0 * S2 - P2, m1 = (o0 + on - 1) * S2 - P2 + F2;
  lo = m0 > 0 ? m0 : 0;
  cnt = (m1 < M1 ? m1 : M1) - lo;
  if (cnt < 0) cnt = 0;
}

template <bool N_FASTEST>
__device__ __forceinline__ Tile make_tile(const StackArgs& a) {
  Tile t;
  int b = blockIdx.x;
  const int tw = b % a.nTW;
  b /= a.nTW;
  const int th = b % a.nTH, ng = b / a.nTH;
  t.n0 = ng * a.NB;
  t.uh0 = th * a.UTH;
  t.uw0 = tw * a.UTW;
  t.NBc = min(a.NB, a.N - t.n0);
  t.UTHc = min(a.UTH, a.UH - t.uh0);
  t.UTWc = min(a.UTW, a.UW - t.uw0);
  const bool pool = a.pF > 0;
  const int oh0 = pool ? t.uh0 * a.pS : t.uh0;
  const int ohn = pool ? (t.UTHc - 1) * a.pS + a.pF : t.UTHc;
  const int ow0 = pool ? t.uw0 * a.pS : t.uw0;
  const int own = pool ? (t.UTWc - 1) * a.pS + a.pF : t.UTWc;
  mid_span(oh0, ohn, a.S2, a.P2, a.F2, a.Ho1, t.mh_lo, t.MHc);
  mid_span(ow0, own, a.S2, a.P2, a.F2, a.Wo1, t.mw_lo, t.MWc);
  t.RA = t.NBc * t.MHc * t.MWc;
  if (N_FASTEST) {
    t.rs_n = 1;
    t.rs_w = t.NBc;
    t.rs_h = t.NBc * t.MWc;
  } else {
    t.rs_w = 1;
    t.rs_h = t.MWc;
    t.rs_n = t.MWc * t.MHc;
  }
  return t;
}

// GEMM column c of the block's conv2 tile: its unit and the conv2 output
// its tap is
struct SCol {
  int n, nl, uh, uw, oh, ow;
  bool ok;
};

template <bool N_FASTEST>
__device__ __forceinline__ SCol scol(const StackArgs& a, const Tile& t,
                                     int c) {
  SCol s;
  const int tap = c / a.BU, ul = c - tap * a.BU;
  int uhl, uwl;
  if (N_FASTEST) {
    s.nl = ul % a.NB;
    const int q = ul / a.NB;
    uwl = q % a.UTW;
    uhl = q / a.UTW;
  } else {
    uwl = ul % a.UTW;
    const int q = ul / a.UTW;
    uhl = q % a.UTH;
    s.nl = q / a.UTH;
  }
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

// next (c, dy, dx) of a reduction index k = (c, dy, dx) over c*F*F
__device__ __forceinline__ void step(int& c, int& dy, int& dx, int F) {
  if (++dx == F) {
    dx = 0;
    if (++dy == F) {
      dy = 0;
      ++c;
    }
  }
}

// acc += As[kBK][rows] x Bs[kBK][cols] for this thread's rows
// {g*64 + ty*4 + i} and cols {g*64 + tx*4 + j}: float4 operand loads, so
// (GM + GN) shared-memory loads feed 16*GM*GN FMAs
template <int GM, int GN>
__device__ __forceinline__ void mma_slice(const float* As, int astr,
                                          const float* Bs, int bstr,
                                          float (&acc)[4 * GM][4 * GN],
                                          int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float av[4 * GM], bv[4 * GN];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(As + kk * astr + g * 64 + ty * 4);
      av[4 * g] = v.x;
      av[4 * g + 1] = v.y;
      av[4 * g + 2] = v.z;
      av[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(Bs + kk * bstr + g * 64 + tx * 4);
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
}

template <int GM>
struct Shape {
  static constexpr int GN = 4 / GM;
  static constexpr int TBM = 64 * GM, TBN = 64 * GN;
  static constexpr int ASTR = (TBM > kCM ? TBM : kCM) + 4;
  static constexpr int BSTR = TBN > kRA ? TBN : kRA;
};

template <bool POOL, int GM>
__global__ void __launch_bounds__(kThreads)
conv_stack_kernel(const StackArgs a) {
  using S = Shape<GM>;
  constexpr int GN = S::GN, TBM = S::TBM, TBN = S::TBN;
  constexpr int ASTR = S::ASTR, BSTR = S::BSTR;
  constexpr int RPT_A = kBK * kRA / kThreads;  // x values per thread, A
  constexpr int WPT_A = kBK * kCM / kThreads;  // w1 values per thread
  constexpr int RPT_B = kBK * TBN / kThreads;  // mid values per thread, B
  constexpr int WPT_B = kBK * TBM / kThreads;  // w2 values per thread
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                 // [kBK][ASTR] weights slice
  float* Bs = As + kBK * ASTR;      // [kBK][BSTR] patch slice
  float* mid = Bs + kBK * BSTR;     // [kCM][RSTR] mid slab; later the pool
                                    // tile [TBM][TBN + 1]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const Tile t = make_tile<false>(a);
  const int co0 = blockIdx.y * TBM;

  // phase B: the conv2 column this thread gathers, and its mid base
  const int cB = tid % TBN, kkB0 = (tid / TBN) * RPT_B;
  const SCol gb = scol<false>(a, t, cB);
  const int ohb = gb.oh * a.S2 - a.P2, owb = gb.ow * a.S2 - a.P2;
  const int rbase = gb.nl * t.rs_n + (ohb - t.mh_lo) * t.rs_h +
                    (owb - t.mw_lo) * t.rs_w;
  // phase A: the mid position (within a pass) this thread gathers for
  const int cA = tid % kRA, kkA0 = (tid / kRA) * RPT_A;

  float acc[4 * GM][4 * GN];
#pragma unroll
  for (int i = 0; i < 4 * GM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * GN; ++j) acc[i][j] = 0.f;

  const int F2sq = a.F2 * a.F2;
  for (int cm0 = 0; cm0 < a.Cm; cm0 += kCM) {
    const int cmn = min(kCM, a.Cm - cm0);
    __syncthreads();  // the previous chunk's phase B is done with the slab

    // ---- phase A: conv1 -> mid slab (channels cm0 .. cm0+cmn) ----------
    for (int r0 = 0; r0 < t.RA; r0 += kRA) {
      const int r = r0 + cA;
      const bool rok = r < t.RA;
      int nl, mhl, mwl;
      {
        const int rr = rok ? r : 0;
        mwl = rr % t.MWc;
        const int q = rr / t.MWc;
        mhl = q % t.MHc;
        nl = q / t.MHc;
      }
      const float* xcol = a.x + (long long)(t.n0 + nl) * a.xs.n;
      const int ih0 = (t.mh_lo + mhl) * a.S1 - a.P1;
      const int iw0 = (t.mw_lo + mwl) * a.S1 - a.P1;
      int kci = 0, kdy = 0, kdx = 0;
      for (int s = 0; s < kkA0; ++s) step(kci, kdy, kdx, a.F1);
      float rb[RPT_A], ra[WPT_A];
      auto gather = [&](int k0) {
#pragma unroll
        for (int kk = 0; kk < RPT_A; ++kk) {
          const int h = ih0 + kdy, w = iw0 + kdx;
          const bool ok = rok && k0 + kkA0 + kk < a.K1 && h >= 0 &&
                          h < a.H && w >= 0 && w < a.W;
          rb[kk] = ok ? __ldg(xcol + kci * a.xs.c + h * a.xs.h + w * a.xs.w)
                      : 0.f;
          step(kci, kdy, kdx, a.F1);
        }
#pragma unroll
        for (int kk = RPT_A; kk < kBK; ++kk) step(kci, kdy, kdx, a.F1);
#pragma unroll
        for (int i = 0; i < WPT_A; ++i) {
          const int e = tid + i * kThreads;
          const int m = e / kBK, kk = e % kBK;
          const int k = k0 + kk;
          ra[i] = (m < cmn && k < a.K1)
                      ? __ldg(a.w1 + (long long)(cm0 + m) * a.w1O +
                              (long long)k * a.w1K)
                      : 0.f;
        }
      };
      auto stage = [&]() {
#pragma unroll
        for (int kk = 0; kk < RPT_A; ++kk)
          Bs[(kkA0 + kk) * BSTR + cA] = rb[kk];
#pragma unroll
        for (int i = 0; i < WPT_A; ++i) {
          const int e = tid + i * kThreads;
          const int m = e / kBK, kk = e % kBK;
          As[kk * ASTR + m] = ra[i];
        }
      };
      float acc1[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc1[i][j] = 0.f;
      gather(0);
      stage();
      __syncthreads();
      for (int k0 = 0; k0 < a.K1; k0 += kBK) {
        const bool more = k0 + kBK < a.K1;
        if (more) gather(k0 + kBK);
        mma_slice<1, 2>(As, ASTR, Bs, BSTR, acc1, tx, ty);
        __syncthreads();
        if (more) {
          stage();
          __syncthreads();
        }
      }
      // conv1's epilogue: bias, ReLU, into the slab
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cml = ty * 4 + i;
        if (cml >= cmn) continue;
        const float b = a.b1 ? __ldg(a.b1 + cm0 + cml) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int rr = r0 + (j / 4) * 64 + tx * 4 + (j % 4);
          if (rr >= t.RA) continue;
          float v = acc1[i][j] + b;
          if (a.relu1) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
          mid[cml * a.RSTR + rr] = v;
        }
      }
    }
    __syncthreads();  // the slab is complete

    // ---- phase B: conv2's (cm, dy, dx) terms of this chunk --------------
    const int K2c = cmn * F2sq;
    const long long k2base = (long long)cm0 * F2sq;
    int kcm = 0, kdy = 0, kdx = 0;
    for (int s = 0; s < kkB0; ++s) step(kcm, kdy, kdx, a.F2);
    float rb[RPT_B], ra[WPT_B];
    auto gather = [&](int k0) {
#pragma unroll
      for (int kk = 0; kk < RPT_B; ++kk) {
        const int mh = ohb + kdy, mw = owb + kdx;
        // outside [0, Ho1) x [0, Wo1) is conv2's zero padding
        const bool ok = gb.ok && k0 + kkB0 + kk < K2c && mh >= 0 &&
                        mh < a.Ho1 && mw >= 0 && mw < a.Wo1;
        rb[kk] = ok ? mid[kcm * a.RSTR + rbase + kdy * t.rs_h + kdx * t.rs_w]
                    : 0.f;
        step(kcm, kdy, kdx, a.F2);
      }
#pragma unroll
      for (int kk = RPT_B; kk < kBK; ++kk) step(kcm, kdy, kdx, a.F2);
#pragma unroll
      for (int i = 0; i < WPT_B; ++i) {
        const int e = tid + i * kThreads;
        const int m = e / kBK, kk = e % kBK;
        const int co = co0 + m, k = k0 + kk;
        ra[i] = (co < a.Co && k < K2c)
                    ? __ldg(a.w2 + (long long)co * a.w2O +
                            (k2base + k) * a.w2K)
                    : 0.f;
      }
    };
    auto stage = [&]() {
#pragma unroll
      for (int kk = 0; kk < RPT_B; ++kk) Bs[(kkB0 + kk) * BSTR + cB] = rb[kk];
#pragma unroll
      for (int i = 0; i < WPT_B; ++i) {
        const int e = tid + i * kThreads;
        const int m = e / kBK, kk = e % kBK;
        As[kk * ASTR + m] = ra[i];
      }
    };
    gather(0);
    stage();
    __syncthreads();
    for (int k0 = 0; k0 < K2c; k0 += kBK) {
      const bool more = k0 + kBK < K2c;
      if (more) gather(k0 + kBK);
      mma_slice<GM, GN>(As, ASTR, Bs, BSTR, acc, tx, ty);
      __syncthreads();
      if (more) {
        stage();
        __syncthreads();
      }
    }
  }

  // conv2's epilogue on the registers: bias, residual, ReLU; then store,
  // or stage the tile (over the slab) for the pool reduction
  constexpr int TSTR = TBN + 1;
  float* Ts = mid;
  if (POOL) __syncthreads();
#pragma unroll
  for (int j = 0; j < 4 * GN; ++j) {
    const int c = (j / 4) * 64 + tx * 4 + (j % 4);
    const SCol col = scol<false>(a, t, c);
#pragma unroll
    for (int i = 0; i < 4 * GM; ++i) {
      const int m = (i / 4) * 64 + ty * 4 + (i % 4);
      const int co = co0 + m;
      if (!col.ok || co >= a.Co) continue;
      float v = acc[i][j];
      if (a.b2) v += __ldg(a.b2 + co);
      if (a.res)
        v += __ldg(a.res + (long long)col.n * a.rs.n + (long long)co * a.rs.c +
                   col.oh * a.rs.h + col.ow * a.rs.w);
      if (a.relu2) v = v < 0.f ? 0.f : v;
      if (POOL)
        Ts[m * TSTR + c] = v;
      else
        a.y[(long long)col.n * a.ys.n + (long long)co * a.ys.c +
            col.oh * a.ys.h + col.ow * a.ys.w] = v;
    }
  }
  if (POOL) {
    __syncthreads();
    const float area = (float)(a.pF * a.pF);
    for (int e = tid; e < TBM * a.BU; e += kThreads) {
      const int m = e / a.BU, ul = e - m * a.BU;
      const SCol col = scol<false>(a, t, ul);  // tap 0 of unit ul
      const int co = co0 + m;
      if (!col.ok || co >= a.Co) continue;
      float r = a.pool_avg ? 0.f : -INFINITY;
      for (int tp = 0; tp < a.T; ++tp) {
        const float v = Ts[m * TSTR + tp * a.BU + ul];
        r = a.pool_avg ? r + v : nan_max(r, v);
      }
      a.y[(long long)col.n * a.ys.n + (long long)co * a.ys.c +
          col.uh * a.ys.h + col.uw * a.ys.w] = a.pool_avg ? r / area : r;
    }
  }
}

}  // namespace stack
}  // namespace repro
