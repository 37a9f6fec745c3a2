// The fused convolution of the NCHW engine K2 (conv_nchw.cu): conv ->
// +bias -> +residual -> ReLU -> max/avg pool, read in the producer's layout
// and written in the consumer's layout, fp32 FMA on the CUDA cores with
// fp32 accumulation.  Strides and layout_strides also serve K1, K5 and K6.
//
// The conv is an implicit GEMM: out[co, col] = sum_k w[co, k] * P[k, col],
// k = (ci, dy, dx) over Ci*F*F, where P is the im2col patch matrix.  P is
// never built: each column is one conv output position (n, oh, ow), and a
// block gathers the BK x BN slice of P it needs straight from x into
// shared memory (zero where the window hangs over the padding, so there is
// no padded copy).  A block computes a BM x BN tile of out; each of its
// 128 threads keeps an 8 x 8 register tile and reads its operands from
// shared memory as float4, so four shared-memory loads feed 64 FMAs.  The
// next BK slice is fetched into registers while the current one is
// multiplied.
//
// Columns and the pool epilogue.  The GEMM columns of a block are "units"
// (one output position of the fused op, for one n) times "taps": without a
// pool a unit is one conv output (T = 1 tap); with an F x F pool a unit is
// one pooled output and its T = F*F taps are the conv outputs of its
// window.  A block holds every tap of each of its BU = BN / T units, so it
// stages the finished conv tile in shared memory and reduces each window
// there.  Windows that overlap (AlexNet's 3/2) are recomputed by each unit
// that owns them: 2.25x the conv FLOPs for 3/2, none for 2/2.
//
// The units run with the output column fastest, which is the order of a
// warp's gathers and stores: coalesced along W in NCHW.  Every tensor is
// addressed through four element strides, one per logical dim (n, c, h,
// w), so a src/dst/residual layout fold is a stride choice, not a code
// path; a fold against the engine's order (a CHWN input or output) reads
// or writes with stride N between neighbouring threads, served by L1/L2.
//
// The save_act output (training).  With ``z`` given, the kernel also writes
// the conv output after bias, residual and ReLU and before the pool, in
// NCHW, the engine's own layout: the activation the
// backward pass needs for its ReLU mask and its max-pool routing.  With a
// pool, the block writes z from its finished tile; where windows overlap
// (3/2), a conv output that several units recompute is written by one of
// them only: the unit whose window holds it in its first pS rows (and
// columns), or the last unit row (column) for the rows past them.  Conv
// outputs under no window are never computed: the wrapper zero-fills z.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "../../csrc/nan_max.cuh"

namespace repro {

constexpr int kThreads = 128;
constexpr int BM = 64;    // output channels per block
constexpr int BN = 128;   // GEMM columns (unit x tap) per block
constexpr int BK = 8;     // reduction slice
constexpr int kWeightsPerThread = BK * BM / kThreads;

struct Strides {
  int n, c, h, w;
};

// element strides of a [N,C,H,W] (nchw) or [C,H,W,N] tensor
inline Strides layout_strides(bool nchw, int N, int C, int H, int W) {
  if (nchw) return Strides{C * H * W, H * W, W, 1};
  return Strides{1, H * W * N, W * N, N};
}

struct ConvArgs {
  const float* x;
  const float* w;     // [Co, K], k = (ci, dy, dx)
  const float* bias;  // [Co] or null
  const float* res;   // conv-output (pre-pool) shape, or null
  float* y;
  float* z;       // save_act: the pre-pool activation, or null
  int N, Ci, H, W, Co, F, S, pad, K;
  int Ho, Wo;     // conv output
  int UH, UW;     // unit grid: the pooled output, or the conv output
  int units;      // N * UH * UW
  int pF, pS, pool_avg, relu;  // pF == 0: no pool
  int T, BU;      // taps per unit, units per block
  Strides xs, ys, rs, zs;
};

// GEMM column c of block bx: its unit, and the conv output its tap is
struct Column {
  int n, uh, uw, oh, ow;
  bool ok;
};

__device__ __forceinline__ Column column(const ConvArgs& a, int bx, int c) {
  Column col;
  const int t = c / a.BU;
  const int u = bx * a.BU + (c - t * a.BU);
  col.ok = t < a.T && u < a.units;
  const int uu = col.ok ? u : 0;
  col.uw = uu % a.UW;
  const int r = uu / a.UW;
  col.uh = r % a.UH;
  col.n = r / a.UH;
  if (a.pF > 0) {  // tap t of the unit's pool window
    const int tt = col.ok ? t : 0;
    col.oh = col.uh * a.pS + tt / a.pF;
    col.ow = col.uw * a.pS + tt % a.pF;
  } else {
    col.oh = col.uh;
    col.ow = col.uw;
  }
  return col;
}

template <bool POOL>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const ConvArgs a) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  // the finished conv tile, for the pool reduction
  __shared__ float Ts[POOL ? BM : 1][POOL ? BN + 1 : 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 column x 8 row groups
  const int bx = blockIdx.x;
  const int co0 = blockIdx.y * BM;

  // the column this thread gathers from x, and where it is in k
  const Column g = column(a, bx, tid);
  const float* xcol = a.x + (long long)g.n * a.xs.n;
  const int ih0 = g.oh * a.S - a.pad, iw0 = g.ow * a.S - a.pad;
  int kci = 0, kdy = 0, kdx = 0;  // (ci, dy, dx) of the next k to gather

  float rb[BK], ra[kWeightsPerThread];
  // weights: w is [Co, K] (k fastest), so neighbouring threads read
  // neighbouring k
  auto weight_slot = [&](int i, int& m, int& kk) {
    const int e = tid + i * kThreads;
    m = e / BK;
    kk = e % BK;
  };
  auto gather = [&](int k0) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int h = ih0 + kdy, wc = iw0 + kdx;
      const bool ok = g.ok && k0 + kk < a.K && h >= 0 && h < a.H &&
                      wc >= 0 && wc < a.W;
      rb[kk] = ok ? __ldg(xcol + kci * a.xs.c + h * a.xs.h + wc * a.xs.w)
                  : 0.f;
      if (++kdx == a.F) {
        kdx = 0;
        if (++kdy == a.F) {
          kdy = 0;
          ++kci;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kWeightsPerThread; ++i) {
      int m, kk;
      weight_slot(i, m, kk);
      const int co = co0 + m, k = k0 + kk;
      ra[i] = (co < a.Co && k < a.K)
                  ? __ldg(a.w + (long long)co * a.K + k)
                  : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) Bs[kk][tid] = rb[kk];
#pragma unroll
    for (int i = 0; i < kWeightsPerThread; ++i) {
      int m, kk;
      weight_slot(i, m, kk);
      As[kk][m] = ra[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  gather(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < a.K; k0 += BK) {
    const bool more = k0 + BK < a.K;
    if (more) gather(k0 + BK);  // in flight while this slice multiplies
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  // epilogue on the registers: bias, residual, ReLU; then store, or stage
  // the tile for the pool reduction
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
    const Column col = column(a, bx, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4);
      const int co = co0 + m;
      if (!col.ok || co >= a.Co) continue;
      float v = acc[i][j];
      if (a.bias) v += __ldg(a.bias + co);
      if (a.res)
        v += __ldg(a.res + (long long)col.n * a.rs.n +
                   (long long)co * a.rs.c + col.oh * a.rs.h +
                   col.ow * a.rs.w);
      if (a.relu) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
      bool save = a.z != nullptr;
      if (POOL) {
        Ts[m][c] = v;
        // one writer per conv output where windows overlap
        const int t = c / a.BU, dy = t / a.pF, dx = t - dy * a.pF;
        save = save && (dy < a.pS || col.uh == a.UH - 1) &&
               (dx < a.pS || col.uw == a.UW - 1);
      } else {
        a.y[(long long)col.n * a.ys.n + (long long)co * a.ys.c +
            col.oh * a.ys.h + col.ow * a.ys.w] = v;
      }
      if (save)
        a.z[(long long)col.n * a.zs.n + (long long)co * a.zs.c +
            col.oh * a.zs.h + col.ow * a.zs.w] = v;
    }
  }
  if (POOL) {
    __syncthreads();
    const float area = (float)(a.pF * a.pF);
    for (int e = tid; e < BM * a.BU; e += kThreads) {
      const int m = e / a.BU, ul = e - m * a.BU;
      const Column col = column(a, bx, ul);  // tap 0 of unit ul
      const int co = co0 + m;
      if (!col.ok || co >= a.Co) continue;
      float r = a.pool_avg ? 0.f : -INFINITY;
      for (int t = 0; t < a.T; ++t) {
        const float v = Ts[m][t * a.BU + ul];
        r = a.pool_avg ? r + v : nan_max(r, v);
      }
      a.y[(long long)col.n * a.ys.n + (long long)co * a.ys.c +
          col.uh * a.ys.h + col.uw * a.ys.w] = a.pool_avg ? r / area : r;
    }
  }
}

}  // namespace repro
