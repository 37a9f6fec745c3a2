// K6: the conv weight gradient, dw[co, ci, dy, dx] = sum over the output
// positions p = (n, oh, ow) of g[n, co, oh, ow] * x[n, ci, oh*S - pad + dy,
// ow*S - pad + dx] (zero where the window hangs over the padding).
//
// Replaces repro/kernels/conv/backward.py::wgrad_pallas (body
// _wgrad_kernel), which accumulates the [Co, Ci, F, F] result in VMEM
// scratch over an (N, row-block) grid that the TPU walks in order.
//
// What bounds it on an H100: operations.  It is an implicit GEMM with
// M = Co, N = Ci*F*F (k = (ci, dy, dx), the im2col row) and a reduction
// over K = N*Ho*Wo output positions: 2*Co*Ci*F*F*N*Ho*Wo fp32 FMA
// operations against a few bytes per position.  The output is tiny and the
// reduction is huge (VGG16 conv1_2 at batch 32: 64 x 576 with K = 1.6 M),
// so one block per output tile would leave most of the 132 SMs idle.
//
// Design: split-K.  Blocks run in parallel and in no order, so nothing
// carries over between them as the TPU grid's scratch does.  A block owns
// a 64 (co) x 128 (k) tile of dw and one contiguous range of output
// positions; its 128 threads keep an 8 x 8 register tile each (as K1/K2 do,
// conv_common.cuh) and reduce the range in 32-position slices staged in
// shared memory.  The patch slice is gathered straight from x (the im2col
// matrix exists only as addresses, a per-block table of k offsets) and the
// g slice straight from g, each through the four element strides of its
// layout, so every (x_layout, g_layout) pair is a stride choice.  A warp's
// lanes take 32 consecutive positions of one k (or one co): with the
// positions ordered n fastest when x is CHWN and ow fastest when x is NCHW,
// the gathers run along the contiguous dim.  Each block writes its partial
// tile to a workspace [splits, Co, K]; a second launch sums the partials in
// split order, so the result is the same bit for bit on every run (no
// float atomics).  With one split the first launch writes dw itself.  The
// wrapper counts the two launches as one K6 call.
#include <cuda_runtime.h>

#include "conv_common.cuh"  // Strides, layout_strides

namespace {

constexpr int kThreads = 128;
constexpr int BM = 64;    // output channels per block
constexpr int BN = 128;   // k = (ci, dy, dx) per block
constexpr int BP = 32;    // output positions per reduction slice
constexpr int kNoRow = -(1 << 28);  // k past Ci*F*F: every bound check fails

struct WgradArgs {
  const float* x;
  const float* g;
  float* out;     // [splits, Co, K] partials, or dw [Co, K] for one split
  int N, Ci, H, W, Co, F, S, pad, Ho, Wo, K, P;  // K = Ci*F*F, P = N*Ho*Wo
  int p_per_split;
  repro::Strides xs, gs;
};

template <bool N_FASTEST>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const WgradArgs a) {
  __shared__ __align__(16) float Gs[BP][BM + 4];
  __shared__ __align__(16) float Ps[BP][BN + 4];
  __shared__ long long koff[BN];
  __shared__ int kdy[BN], kdx[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;    // 16 column x 8 row groups
  const int lane = tid % 32, warp = tid / 32;
  const int k0 = blockIdx.x * BN, co0 = blockIdx.y * BM;
  const int p_begin = blockIdx.z * a.p_per_split;
  const int p_end = min(a.P, p_begin + a.p_per_split);

  {  // this block's k columns: x offset and tap of each
    const int k = k0 + tid;
    const int ff = a.F * a.F;
    const int ci = k / ff, r = k - ci * ff, dy = r / a.F, dx = r - dy * a.F;
    const bool ok = k < a.K;
    koff[tid] = ok ? (long long)ci * a.xs.c + (long long)dy * a.xs.h +
                         (long long)dx * a.xs.w
                   : 0;
    kdy[tid] = ok ? dy : kNoRow;
    kdx[tid] = dx;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int p0 = p_begin; p0 < p_end; p0 += BP) {
    // lane -> output position p0 + lane
    const int p = p0 + lane;
    const bool pok = p < p_end;
    const int pp = pok ? p : p_begin;
    int n, oh, ow;
    if (N_FASTEST) {
      n = pp % a.N;
      const int r = pp / a.N;
      ow = r % a.Wo;
      oh = r / a.Wo;
    } else {
      ow = pp % a.Wo;
      const int r = pp / a.Wo;
      oh = r % a.Ho;
      n = r / a.Ho;
    }
    const long long gbase = (long long)n * a.gs.n + (long long)oh * a.gs.h +
                            (long long)ow * a.gs.w;
#pragma unroll 4
    for (int i = 0; i < BM / 4; ++i) {
      const int m = warp + 4 * i, co = co0 + m;
      Gs[lane][m] = (pok && co < a.Co)
                        ? __ldg(a.g + gbase + (long long)co * a.gs.c)
                        : 0.f;
    }
    const int ih0 = oh * a.S - a.pad, iw0 = ow * a.S - a.pad;
    const long long xbase = (long long)n * a.xs.n + (long long)ih0 * a.xs.h +
                            (long long)iw0 * a.xs.w;
#pragma unroll 4
    for (int i = 0; i < BN / 4; ++i) {
      const int c = warp + 4 * i;
      const int h = ih0 + kdy[c], w = iw0 + kdx[c];
      const bool ok = pok && h >= 0 && h < a.H && w >= 0 && w < a.W;
      Ps[lane][c] = ok ? __ldg(a.x + xbase + koff[c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < BP; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Gs[q][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Gs[q][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ps[q][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Ps[q][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = a.out + (long long)blockIdx.z * a.Co * a.K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4));
    if (co >= a.Co) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (k < a.K) out[(long long)co * a.K + k] = acc[i][j];
    }
  }
}

// dw[i] = sum of the split partials in split order
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                    int splits, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[(long long)sp * n + i];
  dw[i] = s;
}

}  // namespace

// x [N,Ci,H,W] (x_nchw) or [Ci,H,W,N]; g [N,Co,Ho,Wo] (g_nchw) or
// [Co,Ho,Wo,N]; dw [Co, Ci*F*F] (canonical [Co,Ci,F,F]); ws [splits, Co,
// Ci*F*F] when splits > 1 (else unused).  Split s reduces the output
// positions [s * p_per_split, (s + 1) * p_per_split).  Returns
// cudaGetLastError().
extern "C" int wgrad_forward(const void* x, const void* g, void* ws,
                             void* dw, int N, int Ci, int H, int W, int Co,
                             int F, int S, int pad, int x_nchw, int g_nchw,
                             int p_per_split, int splits, void* stream) {
  WgradArgs a;
  a.x = static_cast<const float*>(x);
  a.g = static_cast<const float*>(g);
  a.out = static_cast<float*>(splits > 1 ? ws : dw);
  a.N = N; a.Ci = Ci; a.H = H; a.W = W; a.Co = Co; a.F = F; a.S = S;
  a.pad = pad;
  a.Ho = (H + 2 * pad - F) / S + 1;
  a.Wo = (W + 2 * pad - F) / S + 1;
  a.K = Ci * F * F;
  a.P = N * a.Ho * a.Wo;
  a.p_per_split = p_per_split;
  a.xs = repro::layout_strides(x_nchw, N, Ci, H, W);
  a.gs = repro::layout_strides(g_nchw, N, Co, a.Ho, a.Wo);
  if (a.K <= 0 || Co <= 0 || splits < 1 || p_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((a.K + BN - 1) / BN, (Co + BM - 1) / BM, splits);
  if (x_nchw)
    wgrad_partial_kernel<false><<<grid, kThreads, 0, st>>>(a);
  else
    wgrad_partial_kernel<true><<<grid, kThreads, 0, st>>>(a);
  if (splits > 1) {
    const int n = Co * a.K;
    wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<float*>(dw), splits, n);
  }
  return static_cast<int>(cudaGetLastError());
}
