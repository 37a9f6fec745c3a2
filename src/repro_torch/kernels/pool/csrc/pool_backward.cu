// K7a/K7b: the pool backward, dx of an F x F max/avg pool at stride S (no
// padding), with the ReLU mask folded in.
//
// Replaces repro/kernels/pool/backward.py::pool_backward (its two
// pallas_calls: _pool_bwd_chwn_kernel for a CHWN source, K7a, and
// _pool_bwd_nchw_kernel for an NCHW one, K7b).  Max routes each window's
// gradient to the window's FIRST maximal element in row-major tap order
// (XLA's select-and-scatter tie-breaking); a window that holds a NaN
// routes nothing, as the reference's NaN-propagating max never equals any
// element.  Avg adds g/F^2 to every element of the window.  With
// relu_mask, dx is multiplied by (x > 0) at the end: in the fused conv
// block x is the saved pre-pool activation z, so the ReLU backward and the
// pool backward are one pass.
//
// What bounds it on an H100: bytes.  It reads x and g once and writes dx
// once, with a handful of compares per element.
//
// Design: a gather, not a scatter.  One thread computes one dx element:
// it loops over the at most ceil(F/S)^2 windows that contain it, and for
// max recomputes each window's maximum and first-max position from x
// (L1/L2 serve the re-reads of neighbouring threads).  No two threads
// write one element, so the result is deterministic with no atomics, and
// the per-element order of the window sums is the reference's (taps dy,
// dx ascending).  Elements under no window get 0.  Threads run in x's
// memory order: K7a (CHWN) puts n on the lanes, so x and dx load and store
// coalesced, as K3a does; K7b (NCHW) runs along w, one thread per element
// as K3b runs one per output.  g is read through its four strides, so the
// downstream layout (g_layout) folds into the read.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Strides4 {  // element strides of (n, c, h, w)
  long long n, c, h, w;
};

Strides4 strides_of(bool nchw, int N, int C, int H, int W) {
  if (nchw)
    return {(long long)C * H * W, (long long)H * W, (long long)W, 1};
  return {1, (long long)H * W * N, (long long)W * N, (long long)N};
}

template <bool CHWN>
__global__ void __launch_bounds__(kThreads)
pool_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ dx, int N, int C, int H, int W,
                     int F, int S, int Ho, int Wo, int avg, int relu_mask,
                     Strides4 xs, Strides4 gs) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)N * C * H * W) return;
  int n, c, h, w;
  long long r = i;
  if (CHWN) {
    n = (int)(r % N); r /= N;
    w = (int)(r % W); r /= W;
    h = (int)(r % H);
    c = (int)(r / H);
  } else {
    w = (int)(r % W); r /= W;
    h = (int)(r % H); r /= H;
    c = (int)(r % C);
    n = (int)(r / C);
  }
  const float* xp = x + n * xs.n + c * xs.c;   // the (n, c) plane
  const float* gp = g + n * gs.n + c * gs.c;
  // windows oh with oh*S <= h <= oh*S + F - 1, inside [0, Ho)
  const int oh_hi = min(h / S, Ho - 1), ow_hi = min(w / S, Wo - 1);
  const int oh_lo = h >= F ? (h - F + S) / S : 0;
  const int ow_lo = w >= F ? (w - F + S) / S : 0;
  const float area = (float)(F * F);
  float acc = 0.f;
  // tap dy = h - oh*S ascending, then dx: the reference's summation order
  for (int oh = oh_hi; oh >= oh_lo; --oh) {
    for (int ow = ow_hi; ow >= ow_lo; --ow) {
      const float gv = gp[oh * gs.h + ow * gs.w];
      if (avg) {
        acc += gv / area;
        continue;
      }
      // the window's max and the first tap that attains it
      const float* wp =
          xp + (long long)oh * S * xs.h + (long long)ow * S * xs.w;
      // (one pass: the first strictly greater value is the first maximum,
      // and a NaN poisons the window as nan_max would)
      float m = -INFINITY;
      int first = 0;
      bool has_nan = false;
      for (int dy = 0; dy < F; ++dy)
        for (int dxx = 0; dxx < F; ++dxx) {
          const float v = wp[dy * xs.h + dxx * xs.w];
          if (v != v) has_nan = true;
          if (v > m) {
            m = v;
            first = dy * F + dxx;
          }
        }
      if (!has_nan && first == (h - oh * S) * F + (w - ow * S)) acc += gv;
    }
  }
  if (relu_mask) acc *= xp[h * xs.h + w * xs.w] > 0.f ? 1.f : 0.f;
  dx[i] = acc;
}

int launch(bool chwn, const void* x, const void* g, void* dx, int N, int C,
           int H, int W, int F, int S, int avg, int relu_mask, int g_nchw,
           void* stream) {
  const int Ho = (H - F) / S + 1, Wo = (W - F) / S + 1;
  const long long n = (long long)N * C * H * W;
  if (n > 0 && Ho > 0 && Wo > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const Strides4 xs = strides_of(!chwn, N, C, H, W);
    const Strides4 gs = strides_of(g_nchw != 0, N, C, Ho, Wo);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const float* gf = static_cast<const float*>(g);
    float* df = static_cast<float*>(dx);
    if (chwn)
      pool_backward_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
          xf, gf, df, N, C, H, W, F, S, Ho, Wo, avg, relu_mask, xs, gs);
    else
      pool_backward_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
          xf, gf, df, N, C, H, W, F, S, Ho, Wo, avg, relu_mask, xs, gs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7a: x, dx [C, H, W, N]; g [C, Ho, Wo, N] or (g_nchw) [N, C, Ho, Wo].
extern "C" int pool_backward_chwn(const void* x, const void* g, void* dx,
                                  int N, int C, int H, int W, int F, int S,
                                  int avg, int relu_mask, int g_nchw,
                                  void* stream) {
  return launch(true, x, g, dx, N, C, H, W, F, S, avg, relu_mask, g_nchw,
                stream);
}

// K7b: x, dx [N, C, H, W]; g [N, C, Ho, Wo] or (g_nchw = 0) [C, Ho, Wo, N].
extern "C" int pool_backward_nchw(const void* x, const void* g, void* dx,
                                  int N, int C, int H, int W, int F, int S,
                                  int avg, int relu_mask, int g_nchw,
                                  void* stream) {
  return launch(false, x, g, dx, N, C, H, W, F, S, avg, relu_mask, g_nchw,
                stream);
}
