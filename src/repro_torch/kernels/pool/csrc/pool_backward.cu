// K7a/K7b: the pool backward, dx of an F x F max/avg pool at stride S (no
// padding), with the ReLU mask folded in.
//
// Replaces repro/kernels/pool/backward.py::pool_backward (its two
// pallas_calls: _pool_bwd_chwn_kernel for a CHWN source, K7a, and
// _pool_bwd_nchw_kernel for an NCHW one, K7b).  Max routes each window's
// gradient to the window's FIRST maximal element in row-major tap order
// (XLA's select-and-scatter tie-breaking); a window that holds a NaN
// routes nothing, as the reference's NaN-propagating max never equals any
// element; an all -inf window routes to tap 0.  Avg adds g/F^2 to every
// element of the window.  With relu_mask, dx is multiplied by (x > 0) at
// the end: in the fused conv block x is the saved pre-pool activation z,
// so the ReLU backward and the pool backward are one pass.  Every element
// sums its windows' shares in the reference's order (taps dy, then dx,
// ascending: windows oh, ow descending), so max is exact; no two threads
// write one element, so the result is deterministic with no atomics.
// Elements under no window get 0.  g is read through its four strides, so
// the downstream layout (g_layout) folds into the read.
//
// What bounds it on an H100: bytes.  It reads x and g once and writes dx
// once, with a handful of compares per element.
//
// K7a (CHWN) is a two-phase block kernel.  A block owns one channel, a
// band of dx rows [h0, h1) over all of W, and 32 images on the lanes (x
// and dx run along n, so every load and store is coalesced).  Phase 1
// visits every window that touches the band once: it stages the window's
// g (32 lanes) in shared memory and, for max, the window's first-max tap
// (0xFFFF for a NaN window); on the way it records (x > 0) of the band's
// elements as one ballot word per (h, w).  A window row that straddles two
// bands is visited by both blocks (the band is chosen in
// backward.py::pool_backward_band).  Phase 2, after one __syncthreads,
// forms each dx element of the band from shared memory alone: the g of
// the at most ceil(F/S)^2 windows whose stored tap is its own, and its
// ReLU bit.  So x is read once (the taps of overlapping windows from L1),
// not once per window that holds it.  Avg skips the taps, and reads x in
// phase 2 for its mask.
//
// K7b (NCHW) is a gather: one thread per dx element, along w, loops over
// the windows that contain it and for max recomputes each window's
// maximum and first-max position from x (L1/L2 serve the re-reads of
// neighbouring threads).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned short kNoTap = 0xFFFF;  // a window holding a NaN

struct Strides4 {  // element strides of (n, c, h, w)
  long long n, c, h, w;
};

Strides4 strides_of(bool nchw, int N, int C, int H, int W) {
  if (nchw)
    return {(long long)C * H * W, (long long)H * W, (long long)W, 1};
  return {1, (long long)H * W * N, (long long)W * N, (long long)N};
}

// dynamic shared memory of a K7a block: the window g values [win][33]
// (padded: the NCHW-g staging stores run along windows), the taps
// [win][32], the ReLU words [band * W]
int chwn_smem_bytes(int win, int band, int W) {
  return win * 33 * 4 + win * 32 * 2 + band * W * 4;
}

// K7a: x, dx [C, H, W, N]; g through gs.  FT, ST > 0 fix F and S at
// compile time (the index arithmetic of phase 2 then has no division).
template <int FT, int ST>
__global__ void __launch_bounds__(kThreads)
pool_backward_chwn_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          float* __restrict__ dx, int N, int H, int W,
                          int F_, int S_, int Ho, int Wo, int band, int avg,
                          int relu_mask, int g_nchw, Strides4 gs) {
  constexpr int kWarps = kThreads / 32;
  const int F = FT > 0 ? FT : F_, S = ST > 0 ? ST : S_;
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.y;
  const int h0 = blockIdx.x * band, h1 = min(H, h0 + band);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.z * 32, n = n0 + lane;
  const bool nok = n < N;
  // the window rows that touch [h0, h1)
  const int oh_lo = h0 >= F ? (h0 - F + S) / S : 0;
  const int oh_hi = min(Ho - 1, (h1 - 1) / S);
  const int nwin = max(0, oh_hi - oh_lo + 1) * Wo;
  float* gsm = sm;                                      // [nwin][33]
  unsigned short* tap =
      reinterpret_cast<unsigned short*>(sm + nwin * 33);  // [nwin][32]
  unsigned* pos = reinterpret_cast<unsigned*>(tap + nwin * 32);  // [band*W]
  const long long xc = (long long)c * H * W * N;  // the channel's plane

  // phase 1a: stage g; window r is (oh_lo + r / Wo, r % Wo), and in both
  // layouts g's (h, w) offset is (oh * Wo + ow) * gs.w
  const long long gc = c * gs.c + (long long)oh_lo * Wo * gs.w;
  if (g_nchw) {  // runs along the windows: lanes over r
    for (int nl = warp; nl < 32; nl += kWarps) {
      const bool ok = n0 + nl < N;
      const float* gp = g + gc + (long long)(n0 + nl) * gs.n;
#pragma unroll 4
      for (int r = lane; r < nwin; r += 32)
        gsm[r * 33 + nl] = ok ? __ldg(gp + r) : 0.f;
    }
  } else {  // runs along n: lanes over n
#pragma unroll 4
    for (int r = warp; r < nwin; r += kWarps)
      gsm[r * 33 + lane] =
          nok ? __ldg(g + gc + (long long)r * gs.w + n) : 0.f;
  }

  // phase 1b (max): each window's first-max tap, and the band's ReLU words.
  // The first strictly greater value is the first max; (x > 0) of the taps
  // in the band goes to the ReLU words (the band test is warp-uniform, so
  // every lane takes part in the ballot).
  if (!avg) {
    if constexpr (FT > 0) {
      // a warp walks down window columns, keeping the F - S rows that two
      // windows share in registers: each x row of the column loads once
      constexpr int KEEP = FT > ST ? FT - ST : 0;
      const int wrows = max(0, oh_hi - oh_lo + 1);
      for (int ow = warp; ow < Wo; ow += kWarps) {
        const float* col = x + xc + (long long)ow * S * N + n;
        float v[FT][FT];
        for (int wr = 0; wr < wrows; ++wr) {
          const int oh = oh_lo + wr;
          if (wr > 0) {
#pragma unroll
            for (int rr = 0; rr < KEEP; ++rr)
#pragma unroll
              for (int c = 0; c < FT; ++c) v[rr][c] = v[rr + ST][c];
          }
#pragma unroll
          for (int rr = 0; rr < FT; ++rr)
            if (wr == 0 || rr >= KEEP)
#pragma unroll
              for (int c = 0; c < FT; ++c)
                v[rr][c] = nok ? __ldg(col + ((long long)(oh * S + rr) * W
                                              + c) * N)
                               : -INFINITY;
          float m = -INFINITY;
          int first = 0;
          bool has_nan = false;
#pragma unroll
          for (int rr = 0; rr < FT; ++rr)
#pragma unroll
            for (int c = 0; c < FT; ++c) {
              if (v[rr][c] != v[rr][c]) has_nan = true;
              if (v[rr][c] > m) {
                m = v[rr][c];
                first = rr * FT + c;
              }
            }
          if (relu_mask) {
#pragma unroll
            for (int rr = 0; rr < FT; ++rr) {
              const int h = oh * S + rr;
              if ((wr == 0 || rr >= KEEP) && h >= h0 && h < h1) {
#pragma unroll
                for (int c = 0; c < FT; ++c) {
                  const unsigned b =
                      __ballot_sync(0xffffffffu, v[rr][c] > 0.f);
                  if (lane == 0) pos[(h - h0) * W + ow * S + c] = b;
                }
              }
            }
          }
          tap[(wr * Wo + ow) * 32 + lane] =
              has_nan ? kNoTap : static_cast<unsigned short>(first);
        }
      }
    } else {
      int wr = 0, ow = warp;  // window r = wr * Wo + ow, stepped by kWarps
      while (ow >= Wo) {
        ow -= Wo;
        ++wr;
      }
      for (int r = warp; r < nwin; r += kWarps) {
        const int oh = oh_lo + wr;
        const float* wp = x + xc + ((long long)oh * S * W + ow * S) * N + n;
        float m = -INFINITY;
        int first = 0;
        bool has_nan = false;
        for (int dy = 0; dy < F; ++dy) {
          const int h = oh * S + dy;
          for (int dxx = 0; dxx < F; ++dxx) {
            const float v = nok ? __ldg(wp + (long long)(dy * W + dxx) * N)
                                : -INFINITY;
            if (v != v) has_nan = true;
            if (v > m) {
              m = v;
              first = dy * F + dxx;
            }
            if (relu_mask && h >= h0 && h < h1) {
              const unsigned b = __ballot_sync(0xffffffffu, v > 0.f);
              if (lane == 0) pos[(h - h0) * W + ow * S + dxx] = b;
            }
          }
        }
        tap[r * 32 + lane] =
            has_nan ? kNoTap : static_cast<unsigned short>(first);
        ow += kWarps;
        while (ow >= Wo) {
          ow -= Wo;
          ++wr;
        }
      }
    }
  }
  __syncthreads();

  // phase 2: every dx element of the band, from shared memory, a row at a
  // time (each row's windows worked out once)
  if (!nok) return;
  constexpr int WH = FT > 0 ? (FT + ST - 1) / ST : 0;  // windows over a
  const int wh = WH > 0 ? WH : (F + S - 1) / S;         // row, at most
  const float area = (float)(F * F);
  const float* gl = gsm + lane;
  const unsigned short* tl = tap + lane;
  for (int h = h0; h < h1; ++h) {
    const int oh_a = min(h / S, Ho - 1);
    const int oh_b = h >= F ? (h - F + S) / S : 0;
    const unsigned* prow = pos + (h - h0) * W;
    const long long row = xc + (long long)h * W * N + n;
    for (int w = warp; w < W; w += kWarps) {
      const int ow_a = min(w / S, Wo - 1);
      const int ow_b = w >= F ? (w - F + S) / S : 0;
      float acc = 0.f;
      // tap dy = h - oh*S ascending, then dx: the reference's summation
      // order
#pragma unroll
      for (int i = 0; i < wh; ++i) {
        const int oh = oh_a - i;
        if (oh < oh_b) break;
        const int rb = (oh - oh_lo) * Wo;
        const int tb = (h - oh * S) * F + w;  // tap of (h, w), less ow*S
#pragma unroll
        for (int j = 0; j < wh; ++j) {
          const int ow = ow_a - j;
          if (ow < ow_b) break;
          const int r = rb + ow;
          const float gv = gl[r * 33];
          if (avg)
            acc += gv / area;
          else if (tl[r * 32] == tb - ow * S)
            acc += gv;
        }
      }
      const long long i = row + (long long)w * N;
      if (relu_mask) {
        const bool on = avg ? x[i] > 0.f : (prow[w] >> lane) & 1u;
        acc *= on ? 1.f : 0.f;
      }
      dx[i] = acc;
    }
  }
}

// K7b: x, dx [N, C, H, W]; one thread per element along w
__global__ void __launch_bounds__(kThreads)
pool_backward_nchw_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          float* __restrict__ dx, int N, int C, int H, int W,
                          int F, int S, int Ho, int Wo, int avg,
                          int relu_mask, Strides4 xs, Strides4 gs) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)N * C * H * W) return;
  int n, c, h, w;
  long long r = i;
  w = (int)(r % W); r /= W;
  h = (int)(r % H); r /= H;
  c = (int)(r % C);
  n = (int)(r / C);
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

template <int FT, int ST>
cudaError_t launch_chwn(const float* x, const float* g, float* dx, int N,
                        int C, int H, int W, int F, int S, int Ho, int Wo,
                        int band, int smem, int avg, int relu_mask,
                        int g_nchw, Strides4 gs, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      pool_backward_chwn_kernel<FT, ST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((H + band - 1) / band, C, (N + 31) / 32);
  pool_backward_chwn_kernel<FT, ST><<<grid, kThreads, smem, s>>>(
      x, g, dx, N, H, W, F, S, Ho, Wo, band, avg, relu_mask, g_nchw, gs);
  return cudaGetLastError();
}

}  // namespace

// K7a: x, dx [C, H, W, N]; g [C, Ho, Wo, N] or (g_nchw) [N, C, Ho, Wo].
// A block covers `band` dx rows and touches at most `win_rows` window rows
// (backward.py::pool_backward_band).
extern "C" int pool_backward_chwn(const void* x, const void* g, void* dx,
                                  int N, int C, int H, int W, int F, int S,
                                  int avg, int relu_mask, int g_nchw,
                                  int band, int win_rows, void* stream) {
  const int Ho = (H - F) / S + 1, Wo = (W - F) / S + 1;
  if (N <= 0 || C <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaGetLastError();
  if (band < 1 || win_rows < 1 || F * F >= kNoTap || C > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = chwn_smem_bytes(win_rows * Wo, band, W);
  const Strides4 gs = strides_of(g_nchw != 0, N, C, Ho, Wo);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* df = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (F == 3 && S == 2)  // AlexNet's overlapping pools
    e = launch_chwn<3, 2>(xf, gf, df, N, C, H, W, F, S, Ho, Wo, band, smem,
                          avg, relu_mask, g_nchw, gs, s);
  else if (F == 2 && S == 2)
    e = launch_chwn<2, 2>(xf, gf, df, N, C, H, W, F, S, Ho, Wo, band, smem,
                          avg, relu_mask, g_nchw, gs, s);
  else
    e = launch_chwn<0, 0>(xf, gf, df, N, C, H, W, F, S, Ho, Wo, band, smem,
                          avg, relu_mask, g_nchw, gs, s);
  return static_cast<int>(e);
}

// K7b: x, dx [N, C, H, W]; g [N, C, Ho, Wo] or (g_nchw = 0) [C, Ho, Wo, N].
extern "C" int pool_backward_nchw(const void* x, const void* g, void* dx,
                                  int N, int C, int H, int W, int F, int S,
                                  int avg, int relu_mask, int g_nchw,
                                  void* stream) {
  const int Ho = (H - F) / S + 1, Wo = (W - F) / S + 1;
  const long long n = (long long)N * C * H * W;
  if (n > 0 && Ho > 0 && Wo > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    const Strides4 xs = strides_of(true, N, C, H, W);
    const Strides4 gs = strides_of(g_nchw != 0, N, C, Ho, Wo);
    pool_backward_nchw_kernel<<<(unsigned)blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dx), N, C, H, W, F, S, Ho, Wo, avg, relu_mask,
        xs, gs);
  }
  return static_cast<int>(cudaGetLastError());
}
