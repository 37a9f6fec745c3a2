// K3a/K3b: standalone max/avg pooling over the H, W dims, F x F windows at
// stride S, no padding, written in either layout.
//
// Replaces repro/kernels/pool/pool.py::pool_chwn_pallas (K3a, CHWN source)
// and ::pool_nchw_pallas (K3b, NCHW source), the paper's §V.A pooling
// study.
//
// What bounds it on an H100: bytes.  A pool reads its input once and writes
// an output S*S times smaller, with one operation per tap.
//
// K3a, CHWN [C, H, W, N]: N is minormost, so a warp's 32 lanes take 32
// consecutive images of one (c, ho) output row and every load is one
// coalesced 128-byte line.  Each thread produces a strip of kE consecutive
// wo outputs (the paper's thread coarsening, at a fixed kE rather than its
// hill climb): for each window row it walks the (kE - 1) * S + F input
// columns the strip needs once, and each loaded value updates every output
// of the strip whose window holds it, from registers.  Overlapping windows
// (F > S) therefore load a shared column once, not once per window.
//
// K3b, NCHW [N, C, H, W]: one thread per output, threads along wo.  The
// window slides along the contiguous W, so neighbouring lanes read S
// elements apart: the uncoalesced access the paper measures for this
// layout, kept as it is because the layout comparison is the point.
//
// Both write either layout: the output's four strides decide it, so the
// folded re-layout (dst != src) is a strided write.  Max starts at -inf
// and propagates NaN (nan_max); avg sums the taps in f32 in row-major
// (dy, dx) order, then divides by F*F, as the reference does.  The TPU
// version's N-tile / C-tile padding and its VMEM-sized N tile are not
// carried over: the kernels check the ragged edges of N and C themselves.
//
// Storage dtypes (csrc/storage.cuh): the float32 build defines
// pool_{chwn,nchw}_forward, the bf16 build (-DREPRO_VARIANT_BF16)
// pool_{chwn,nchw}_forward_bf16 over bf16 x and y.  Both widen each tap to
// float32, take the max or the float32 sum, divide, and round once where
// they store, as the reference's kernels do (x.astype(f32), then
// acc.astype(o_ref.dtype)); a bf16 max is exact.
#include <cuda_runtime.h>
#include <math.h>

#include "../../csrc/nan_max.cuh"
#include "../../csrc/storage.cuh"

namespace {

using repro::storage::widen;
using repro::storage::put;
using T = REPRO_WT;  // the storage type of x and y

constexpr int kE = 4;       // K3a outputs per thread along wo
constexpr int kWarps = 8;   // K3a warps per block
constexpr int kThreads = 256;  // K3b threads per block

struct Out {                // y's element strides for (n, c, ho, wo)
  int n, c, h, w;
};

Out out_strides(int N, int C, int Ho, int Wo, bool dst_nchw) {
  if (dst_nchw) return {C * Ho * Wo, Ho * Wo, Wo, 1};
  return {1, Ho * Wo * N, Wo * N, N};
}

template <bool AVG>
__device__ __forceinline__ float tap(float r, float v) {
  return AVG ? r + v : nan_max(r, v);
}

template <bool AVG>
__global__ void __launch_bounds__(32 * kWarps)
pool_chwn_kernel(const T* __restrict__ x, T* __restrict__ y, int N,
                 int C, int H, int W, int F, int S, int Ho, int Wo,
                 int n_chunks, int strips, Out ys) {
  long long item = (long long)blockIdx.x * kWarps + threadIdx.y;
  const int nc = (int)(item % n_chunks);
  item /= n_chunks;
  const int st = (int)(item % strips);
  item /= strips;
  const int ho = (int)(item % Ho);
  const long long c = item / Ho;
  const int n = nc * 32 + threadIdx.x;
  if (c >= C || n >= N) return;
  const int wo0 = st * kE, w0 = wo0 * S;
  const int cols = (kE - 1) * S + F;
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = AVG ? 0.f : -INFINITY;
  const T* xc = x + ((c * H + (long long)ho * S) * W + w0) * N + n;
  for (int dy = 0; dy < F; ++dy) {
    const T* xr = xc + (long long)dy * W * N;
    for (int j = 0; j < cols && w0 + j < W; ++j) {
      const float v = widen(xr[(long long)j * N]);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int dx = j - e * S;
        if (dx >= 0 && dx < F) acc[e] = tap<AVG>(acc[e], v);
      }
    }
  }
  const float area = (float)(F * F);
  T* yp = y + (long long)n * ys.n + c * ys.c + (long long)ho * ys.h;
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (wo0 + e < Wo)
      put(yp + (long long)(wo0 + e) * ys.w, AVG ? acc[e] / area : acc[e]);
}

template <bool AVG>
__global__ void __launch_bounds__(kThreads)
pool_nchw_kernel(const T* __restrict__ x, T* __restrict__ y, int N,
                 int C, int H, int W, int F, int S, int Ho, int Wo, Out ys) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)N * C * Ho * Wo) return;
  const int wo = (int)(i % Wo);
  i /= Wo;
  const int ho = (int)(i % Ho);
  i /= Ho;
  const int c = (int)(i % C);
  const long long n = i / C;
  const T* xp =
      x + ((n * C + c) * H + (long long)ho * S) * W + (long long)wo * S;
  float r = AVG ? 0.f : -INFINITY;
  for (int dy = 0; dy < F; ++dy)
    for (int dx = 0; dx < F; ++dx) r = tap<AVG>(r, widen(xp[dy * W + dx]));
  put(y + n * ys.n + (long long)c * ys.c + (long long)ho * ys.h +
          (long long)wo * ys.w,
      AVG ? r / (float)(F * F) : r);
}

int pool_out(int hw, int F, int S) { return (hw - F) / S + 1; }

}  // namespace

// K3a: x [C, H, W, N] -> y [C, Ho, Wo, N] (dst_nchw = 0) or
// [N, C, Ho, Wo] (dst_nchw = 1), both REPRO_WT (float32, or bf16 in the
// bf16 build).  Returns cudaGetLastError().
extern "C" int REPRO_ENTRY(pool_chwn_forward)(const void* x, void* y,
                                             int N, int C, int H, int W,
                                             int F, int S, int avg,
                                             int dst_nchw, void* stream) {
  const int Ho = pool_out(H, F, S), Wo = pool_out(W, F, S);
  if (N > 0 && C > 0 && Ho > 0 && Wo > 0) {
    const int n_chunks = (N + 31) / 32, strips = (Wo + kE - 1) / kE;
    const long long items = (long long)C * Ho * strips * n_chunks;
    const long long blocks = (items + kWarps - 1) / kWarps;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const Out ys = out_strides(N, C, Ho, Wo, dst_nchw != 0);
    const dim3 block(32, kWarps);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* xf = static_cast<const T*>(x);
    T* yf = static_cast<T*>(y);
    if (avg)
      pool_chwn_kernel<true><<<(unsigned)blocks, block, 0, s>>>(
          xf, yf, N, C, H, W, F, S, Ho, Wo, n_chunks, strips, ys);
    else
      pool_chwn_kernel<false><<<(unsigned)blocks, block, 0, s>>>(
          xf, yf, N, C, H, W, F, S, Ho, Wo, n_chunks, strips, ys);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3b: x [N, C, H, W] -> y [N, C, Ho, Wo] (dst_nchw = 1) or
// [C, Ho, Wo, N] (dst_nchw = 0), both REPRO_WT.  Returns
// cudaGetLastError().
extern "C" int REPRO_ENTRY(pool_nchw_forward)(const void* x, void* y,
                                             int N, int C, int H, int W,
                                             int F, int S, int avg,
                                             int dst_nchw, void* stream) {
  const int Ho = pool_out(H, F, S), Wo = pool_out(W, F, S);
  if (N > 0 && C > 0 && Ho > 0 && Wo > 0) {
    const long long outs = (long long)N * C * Ho * Wo;
    const long long blocks = (outs + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const Out ys = out_strides(N, C, Ho, Wo, dst_nchw != 0);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* xf = static_cast<const T*>(x);
    T* yf = static_cast<T*>(y);
    if (avg)
      pool_nchw_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
          xf, yf, N, C, H, W, F, S, Ho, Wo, ys);
    else
      pool_nchw_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
          xf, yf, N, C, H, W, F, S, Ho, Wo, ys);
  }
  return static_cast<int>(cudaGetLastError());
}
