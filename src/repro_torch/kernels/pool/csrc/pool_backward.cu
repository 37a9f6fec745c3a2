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
// K7b (NCHW) is K7a's design turned for NCHW, where w is the contiguous
// dimension.  A block owns a band of dx rows [h0, h1) over all of W of
// one (n, c) plane, or of several consecutive small planes whole (the
// split is chosen in backward.py::pool_backward_planes).  Phase 1 stages,
// per plane, the x rows that the windows touching the band cover (16-byte
// coalesced loads along w where W is a multiple of 4) and every such
// window's g, then finds each window's first-max tap once from shared
// memory (kNoTap for a NaN window).  Phase 2, after one __syncthreads,
// forms each dx element from shared memory alone, 4 along w a thread: the
// g of the at most ceil(F/S)^2 windows whose stored tap is its own, times
// (x > 0) from the staged rows, stored as one 16-byte vector.  Avg skips
// the taps (and x, without the mask).  F and S are fixed at compile time
// for 2/2 and 3/2, so the window arithmetic has no division.
//
// Storage dtypes (csrc/storage.cuh): the float32 build defines
// pool_backward_{chwn,nchw}, the bf16 build (-DREPRO_VARIANT_BF16)
// pool_backward_{chwn,nchw}_bf16 over bf16 x, g and dx.  x and g are
// widened to float32 as they are loaded (into registers and the float32
// shared arrays above), each window's first max is found among the
// widened values, so ties, frequent in bf16, are broken exactly as in
// float32 (the first maximal tap in row-major order, the reference's
// _route), and dx sums its windows' shares in float32 registers (F > S
// windows overlap: AlexNet's and ResNet-18's 3/2 pools) and is rounded
// once, to nearest even, where it is stored, as the reference casts acc.
//
// K7a bf16 runs kernels of its own, built only into the bf16 library, that
// work in bf16 bytes.  Their lanes run over (w or window, n), n fastest, a
// unit being two neighbouring images moved by one 4-byte access where N is
// even and the bases allow it (else one image): at VGG16's N = 32 a warp
// covers two neighbouring windows or columns, 128 bytes a tap, where the
// float32 design's lanes took 32 images of 2 bytes each.  Each first max is
// found among the widened values (ties break as the reference's _route),
// and dx sums its shares in float32 registers in the reference's order and
// is rounded once where it is stored.
//   direct (max with F <= S, every VGG16 and unet_mini max pool): no two
//     windows share an element, so a thread takes one window unit: it loads
//     the window's taps and its g, finds each image's first max, and writes
//     the block of dx the window owns (its taps, and the rows and columns
//     up to the next window or the edge, which no window covers and get 0),
//     with the ReLU mask from the taps in its registers.  No shared memory,
//     no barrier: x and g are read once and dx written once.
//   banded (avg, and max with overlapping windows): K7a's two phases in
//     bf16 bytes.  A block owns one channel, a band of dx rows
//     (backward.py::pool_backward_band with itemsize 2) and a chunk of 32
//     units; phase 1 stages each touching window's g as its 4-byte word
//     and, for max, both images' first-max taps as one word; phase 2 forms
//     each dx unit of the band from shared memory, reading x again (from
//     L2) for the ReLU mask.
// backward.py::k7a_bf16_direct_unit and ::k7a_bf16_banded_unit are these
// maps in Python.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/storage.cuh"

namespace {

using repro::storage::ld;
using repro::storage::ld4;
using repro::storage::put;
using repro::storage::widen;
using T = REPRO_WT;  // the storage type of x, g and dx

// elements 4 r .. 4 r + 3 of base widened to float32, by one load of
// 4 * sizeof(T) bytes (16-byte aligned for float32, 8 for bf16)
__device__ __forceinline__ float4 load4(const float* base, int r) {
  return __ldg(reinterpret_cast<const float4*>(base) + r);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* base, int r) {
  return ld4(base + 4 * r);
}
// 4 float32 values stored as 4 consecutive elements of T, by one store
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

constexpr int kThreads = 256;
constexpr unsigned short kNoTap = 0xFFFF;  // a window holding a NaN
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory a block
                                         // has without the attribute

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

// dynamic shared memory of a K7b block: for each of its planes the x rows
// its windows cover [(win_rows - 1) S + F][W], the window g values and
// first-max taps [win_rows][Wo]
long long nchw_smem_bytes(int planes, int win_rows, int F, int S, int W,
                          int Wo) {
  return static_cast<long long>(planes) *
         (4LL * ((win_rows - 1) * S + F) * W + 6LL * win_rows * Wo);
}

// K7a: x, dx [C, H, W, N]; g through gs.  FT, ST > 0 fix F and S at
// compile time (the index arithmetic of phase 2 then has no division).
template <int FT, int ST>
__global__ void __launch_bounds__(kThreads)
pool_backward_chwn_kernel(const T* __restrict__ x,
                          const T* __restrict__ g,
                          T* __restrict__ dx, int N, int H, int W,
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
      const T* gp = g + gc + (long long)(n0 + nl) * gs.n;
#pragma unroll 4
      for (int r = lane; r < nwin; r += 32)
        gsm[r * 33 + nl] = ok ? ld(gp + r) : 0.f;
    }
  } else {  // runs along n: lanes over n
#pragma unroll 4
    for (int r = warp; r < nwin; r += kWarps)
      gsm[r * 33 + lane] =
          nok ? ld(g + gc + (long long)r * gs.w + n) : 0.f;
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
        const T* col = x + xc + (long long)ow * S * N + n;
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
                v[rr][c] = nok ? ld(col + ((long long)(oh * S + rr) * W
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
        const T* wp = x + xc + ((long long)oh * S * W + ow * S) * N + n;
        float m = -INFINITY;
        int first = 0;
        bool has_nan = false;
        for (int dy = 0; dy < F; ++dy) {
          const int h = oh * S + dy;
          for (int dxx = 0; dxx < F; ++dxx) {
            const float v = nok ? ld(wp + (long long)(dy * W + dxx) * N)
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
        const bool on = avg ? widen(x[i]) > 0.f : (prow[w] >> lane) & 1u;
        acc *= on ? 1.f : 0.f;
      }
      put(dx + i, acc);
    }
  }
}

// K7b: x, dx [N, C, H, W], the (n, c) planes p = n C + c; g through gs.
// A block takes `P` consecutive planes and dx rows [h0, h0 + band) of each;
// FT, ST > 0 fix F and S at compile time.
template <int FT, int ST>
__global__ void __launch_bounds__(kThreads)
pool_backward_nchw_kernel(const T* __restrict__ x,
                          const T* __restrict__ g,
                          T* __restrict__ dx, int planes, int C, int H,
                          int W, int F_, int S_, int Ho, int Wo, int P,
                          int band, int win_rows, int avg, int relu_mask,
                          int vec, Strides4 gs) {
  const int F = FT > 0 ? FT : F_, S = ST > 0 ? ST : S_;
  extern __shared__ __align__(16) float sm[];
  const int p0 = blockIdx.x * P, pc = min(P, planes - p0);
  const int h0 = blockIdx.y * band, h1 = min(H, h0 + band);
  // the window rows that touch [h0, h1), and the x rows they cover
  const int oh_lo = h0 >= F ? (h0 - F + S) / S : 0;
  const int oh_hi = min(Ho - 1, (h1 - 1) / S);
  const int wr = max(0, oh_hi - oh_lo + 1);
  const int xr0 = oh_lo * S, xr = wr > 0 ? min(H, oh_hi * S + F) - xr0 : 0;
  const int XP = ((win_rows - 1) * S + F) * W;  // x floats of a plane
  const int GP = win_rows * Wo;                   // windows of a plane
  float* xs = sm;                                 // [P][x rows][W]
  float* gsm = xs + P * XP;                       // [P][win_rows][Wo]
  unsigned short* tap =
      reinterpret_cast<unsigned short*>(gsm + P * GP);  // [P][win_rows][Wo]
  const bool need_x = !avg || relu_mask;
  const long long HW = static_cast<long long>(H) * W;
  const T* xb = x + p0 * HW + static_cast<long long>(xr0) * W;

  // phase 1a: the x rows (16-byte loads where W is a multiple of 4) and
  // each window's g
  if (need_x) {
    if (vec) {
      const int WQ = W / 4, per = xr * WQ;
      for (int e = threadIdx.x; e < pc * per; e += kThreads) {
        const int pl = e / per, r = e - pl * per;
        *reinterpret_cast<float4*>(xs + pl * XP + 4 * r) =
            load4(xb + pl * HW, r);
      }
    } else {
      const int per = xr * W;
      for (int e = threadIdx.x; e < pc * per; e += kThreads) {
        const int pl = e / per, r = e - pl * per;
        xs[pl * XP + r] = ld(xb + pl * HW + r);
      }
    }
  }
  {
    const int per = wr * Wo;
    for (int e = threadIdx.x; e < pc * per; e += kThreads) {
      const int pl = e / per, r = e - pl * per;
      const int rw = r / Wo, ow = r - rw * Wo;
      const int p = p0 + pl, n = p / C, c = p - n * C;
      gsm[pl * GP + r] = ld(g + n * gs.n + c * gs.c +
                               (oh_lo + rw) * gs.h + ow * gs.w);
    }
  }
  __syncthreads();

  // phase 1b (max): each window's first maximal tap in row-major order
  // (the first strictly greater value), kNoTap for a window with a NaN
  if (!avg) {
    const int per = wr * Wo;
    for (int e = threadIdx.x; e < pc * per; e += kThreads) {
      const int pl = e / per, r = e - pl * per;
      const int rw = r / Wo, ow = r - rw * Wo;
      const float* wp = xs + pl * XP + rw * S * W + ow * S;
      float m = -INFINITY;
      int first = 0;
      bool has_nan = false;
      for (int dy = 0; dy < F; ++dy)
        for (int dxx = 0; dxx < F; ++dxx) {
          const float v = wp[dy * W + dxx];
          if (v != v) has_nan = true;
          if (v > m) {
            m = v;
            first = dy * F + dxx;
          }
        }
      tap[pl * GP + r] = has_nan ? kNoTap : static_cast<unsigned short>(first);
    }
    __syncthreads();
  }

  // phase 2: every dx element of the band from shared memory, 4 along w a
  // thread (a 16-byte store where W is a multiple of 4)
  constexpr int WH = FT > 0 ? (FT + ST - 1) / ST : 0;  // windows over an
  const int wh = WH > 0 ? WH : (F + S - 1) / S;         // element, a dim
  const float area = static_cast<float>(F * F);
  const int WQ = (W + 3) / 4, per = (h1 - h0) * WQ;
  for (int e = threadIdx.x; e < pc * per; e += kThreads) {
    const int pl = e / per, r = e - pl * per;
    const int hh = r / WQ, w0 = 4 * (r - hh * WQ), h = h0 + hh;
    const int oh_a = min(h / S, Ho - 1);
    const int oh_b = h >= F ? (h - F + S) / S : 0;
    const float* gp = gsm + pl * GP - oh_lo * Wo;
    const unsigned short* tp = tap + pl * GP - oh_lo * Wo;
    const float* xrow = xs + pl * XP + (h - xr0) * W;
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + j;
      float acc = 0.f;
      if (w < W) {
        const int ow_a = min(w / S, Wo - 1);
        const int ow_b = w >= F ? (w - F + S) / S : 0;
        // tap dy = h - oh*S ascending, then dx: the reference's summation
        // order
#pragma unroll
        for (int i = 0; i < wh; ++i) {
          const int oh = oh_a - i;
          if (oh < oh_b) break;
          const int tb = (h - oh * S) * F + w;  // tap of (h, w), less ow*S
#pragma unroll
          for (int k = 0; k < wh; ++k) {
            const int ow = ow_a - k;
            if (ow < ow_b) break;
            const float gv = gp[oh * Wo + ow];
            if (avg)
              acc += gv / area;
            else if (tp[oh * Wo + ow] == tb - ow * S)
              acc += gv;
          }
        }
        // an element under no window (past the last one) stays 0 and was
        // not staged
        if (relu_mask && oh_a >= oh_b && ow_a >= ow_b)
          acc *= xrow[w] > 0.f ? 1.f : 0.f;
      }
      out[j] = acc;
    }
    T* d = dx + (p0 + pl) * HW + static_cast<long long>(h) * W + w0;
    if (vec) {
      store4(d, out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w0 + j < W) put(d + j, out[j]);
    }
  }
}

template <int FT, int ST>
cudaError_t launch_nchw(const T* x, const T* g, T* dx, int N,
                        int C, int H, int W, int F, int S, int Ho, int Wo,
                        int P, int band, int win_rows, int smem, int avg,
                        int relu_mask, int vec, Strides4 gs,
                        cudaStream_t s) {
  if (smem > kDefaultSmem) {  // the attribute costs host time a launch
    const cudaError_t e = cudaFuncSetAttribute(
        pool_backward_nchw_kernel<FT, ST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int planes = N * C;
  const dim3 grid((planes + P - 1) / P, (H + band - 1) / band);
  pool_backward_nchw_kernel<FT, ST><<<grid, kThreads, smem, s>>>(
      x, g, dx, planes, C, H, W, F, S, Ho, Wo, P, band, win_rows, avg,
      relu_mask, vec, gs);
  return cudaGetLastError();
}

template <int FT, int ST>
cudaError_t launch_chwn(const T* x, const T* g, T* dx, int N,
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

#if defined(REPRO_VARIANT_BF16)
// K7a bf16's units: two images (a 4-byte word) or one (a halfword)
__device__ __forceinline__ unsigned ld_unit(const __nv_bfloat16* p,
                                            bool pair) {
  return pair ? __ldg(reinterpret_cast<const unsigned*>(p))
              : __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ void st_unit(__nv_bfloat16* p, float a0, float a1,
                                        bool pair) {
  if (pair)
    *reinterpret_cast<unsigned*>(p) = repro::mma::pack_bf16(a0, a1);
  else
    put(p, a0);
}
// g of images n (and n + 1) at window offset o: one word where g runs
// along n (gs.n == 1), else a halfword each
__device__ __forceinline__ unsigned ld_g(const __nv_bfloat16* g, long long o,
                                         long long sn, int n, bool pair) {
  const __nv_bfloat16* p = g + o + n * sn;
  if (sn == 1) return ld_unit(p, pair);
  const unsigned lo = __ldg(reinterpret_cast<const unsigned short*>(p));
  return pair ? lo | (static_cast<unsigned>(__ldg(
                          reinterpret_cast<const unsigned short*>(p + sn)))
                      << 16)
              : lo;
}
__device__ __forceinline__ float mask(float v, bool relu_mask) {
  return relu_mask && !(v > 0.f) ? 0.f : 1.f;
}

// direct: unit u = ((c Ho + oh) Wo + ow) U + q (U = N / 2 pairs or N
// images) owns dx rows [oh S, oh S + S) and columns [ow S, ow S + S), the
// last window row and column up to H and W.  F <= S.
template <int FT, int ST, bool PAIR>
__global__ void __launch_bounds__(kThreads)
pool_backward_direct_bf16(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ g,
                          __nv_bfloat16* __restrict__ dx, int N, int H,
                          int W, int F_, int S_, int Ho, int Wo, int U,
                          long long units, int relu_mask, Strides4 gs) {
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const int F = FT > 0 ? FT : F_, S = ST > 0 ? ST : S_;
  long long r = u / U;
  const int q = (int)(u - r * U);
  const int ow = (int)(r % Wo);
  r /= Wo;
  const int oh = (int)(r % Ho);
  const long long c = r / Ho;
  const int n = PAIR ? 2 * q : q;
  const unsigned gw = ld_g(g, c * gs.c + oh * gs.h + ow * gs.w, gs.n, n, PAIR);
  const float g0 = repro::storage::lo_bf16(gw);
  const float g1 = repro::storage::hi_bf16(gw);
  const int h0 = oh * S, w0 = ow * S;
  const long long base = ((c * H + h0) * W + w0) * N + n;
  const int rows = oh == Ho - 1 ? H - h0 : S;  // the owned block
  const int cols = ow == Wo - 1 ? W - w0 : S;
  // each image's first max in row-major tap order; a NaN routes nothing
  float m0 = -INFINITY, m1 = -INFINITY;
  int f0 = 0, f1 = 0;
  bool nan0 = false, nan1 = false;
  if constexpr (FT > 0) {
    unsigned v[FT * FT];
#pragma unroll
    for (int dy = 0; dy < FT; ++dy)
#pragma unroll
      for (int dxx = 0; dxx < FT; ++dxx)
        v[dy * FT + dxx] = ld_unit(x + base + (dy * W + dxx) * N, PAIR);
#pragma unroll
    for (int t = 0; t < FT * FT; ++t) {
      const float a = repro::storage::lo_bf16(v[t]);
      const float b = repro::storage::hi_bf16(v[t]);
      nan0 |= a != a;
      if (a > m0) { m0 = a; f0 = t; }
      if (PAIR) {
        nan1 |= b != b;
        if (b > m1) { m1 = b; f1 = t; }
      }
    }
#pragma unroll
    for (int dy = 0; dy < FT; ++dy)
#pragma unroll
      for (int dxx = 0; dxx < FT; ++dxx) {
        const int t = dy * FT + dxx;
        const float a = repro::storage::lo_bf16(v[t]);
        const float b = repro::storage::hi_bf16(v[t]);
        const float d0 = (!nan0 && f0 == t ? g0 : 0.f) * mask(a, relu_mask);
        const float d1 = (!nan1 && f1 == t ? g1 : 0.f) * mask(b, relu_mask);
        st_unit(dx + base + (dy * W + dxx) * N, d0, d1, PAIR);
      }
  } else {
    for (int t = 0; t < F * F; ++t) {
      const unsigned v =
          ld_unit(x + base + ((t / F) * W + t % F) * N, PAIR);
      const float a = repro::storage::lo_bf16(v);
      const float b = repro::storage::hi_bf16(v);
      nan0 |= a != a;
      if (a > m0) { m0 = a; f0 = t; }
      if (PAIR) {
        nan1 |= b != b;
        if (b > m1) { m1 = b; f1 = t; }
      }
    }
    for (int t = 0; t < F * F; ++t) {
      const long long o = base + ((t / F) * W + t % F) * N;
      const unsigned v = ld_unit(x + o, PAIR);
      const float d0 = (!nan0 && f0 == t ? g0 : 0.f) *
                       mask(repro::storage::lo_bf16(v), relu_mask);
      const float d1 = (!nan1 && f1 == t ? g1 : 0.f) *
                       mask(repro::storage::hi_bf16(v), relu_mask);
      st_unit(dx + o, d0, d1, PAIR);
    }
  }
  // the owned elements under no window: 0
  for (int dy = 0; dy < rows; ++dy)
    for (int dxx = dy < F ? F : 0; dxx < cols; ++dxx)
      st_unit(dx + base + (dy * W + dxx) * N, 0.f, 0.f, PAIR);
}

// dynamic shared memory of a banded K7a bf16 block: for each window of the
// band and each of the chunk's 32 units, its g word and its taps word
int chwn_bf16_smem_bytes(int win) { return win * 32 * 8; }

// banded: a block takes channel blockIdx.y, dx rows [h0, h0 + band) and
// units [32 blockIdx.z, + 32); window unit r = win * NU + j, win = (oh -
// oh_lo) Wo + ow; dx unit e = ((h - h0) W + w) NU + j.
template <int FT, int ST, bool PAIR>
__global__ void __launch_bounds__(kThreads)
pool_backward_banded_bf16(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ g,
                          __nv_bfloat16* __restrict__ dx, int N, int H,
                          int W, int F_, int S_, int Ho, int Wo, int U,
                          int band, int avg, int relu_mask, Strides4 gs) {
  const int F = FT > 0 ? FT : F_, S = ST > 0 ? ST : S_;
  extern __shared__ __align__(16) unsigned smw[];
  const long long c = blockIdx.y;
  const int h0 = blockIdx.x * band, h1 = min(H, h0 + band);
  const int q0 = blockIdx.z * 32, NU = min(32, U - q0);
  const int oh_lo = h0 >= F ? (h0 - F + S) / S : 0;
  const int oh_hi = min(Ho - 1, (h1 - 1) / S);
  const int nwin = max(0, oh_hi - oh_lo + 1) * Wo;
  unsigned* gsm = smw;                  // [nwin][NU] g words
  unsigned* tsm = smw + nwin * NU;      // [nwin][NU] taps words
  const long long xc = c * H * W * N;   // the channel's plane

  // phase 1: each window's g word and, for max, its taps word (image 0's
  // first-max tap in the low half; kNoTap for a window holding a NaN)
  for (int r = threadIdx.x; r < nwin * NU; r += kThreads) {
    const int win = r / NU, j = r - win * NU;
    const int wr = win / Wo, ow = win - wr * Wo, oh = oh_lo + wr;
    const int n = PAIR ? 2 * (q0 + j) : q0 + j;
    gsm[r] = ld_g(g, c * gs.c + oh * gs.h + ow * gs.w, gs.n, n, PAIR);
    if (!avg) {
      const __nv_bfloat16* wp =
          x + xc + ((long long)oh * S * W + ow * S) * N + n;
      float m0 = -INFINITY, m1 = -INFINITY;
      unsigned f0 = 0, f1 = 0;
      bool nan0 = false, nan1 = false;
      auto visit = [&](int yy, int xx) {
        const unsigned v = ld_unit(wp + (yy * W + xx) * N, PAIR);
        const float a = repro::storage::lo_bf16(v);
        const float b = repro::storage::hi_bf16(v);
        const unsigned t = yy * F + xx;
        nan0 |= a != a;
        if (a > m0) { m0 = a; f0 = t; }
        nan1 |= b != b;
        if (b > m1) { m1 = b; f1 = t; }
      };
      if constexpr (FT > 0) {
#pragma unroll
        for (int yy = 0; yy < FT; ++yy)
#pragma unroll
          for (int xx = 0; xx < FT; ++xx) visit(yy, xx);
      } else {
        for (int yy = 0; yy < F; ++yy)
          for (int xx = 0; xx < F; ++xx) visit(yy, xx);
      }
      tsm[r] = (nan0 ? kNoTap : f0) | ((nan1 ? kNoTap : f1) << 16);
    }
  }
  __syncthreads();

  // phase 2: every dx unit of the band, its windows' shares summed in the
  // reference's order (tap dy ascending, then dx: windows oh, ow
  // descending), rounded once
  constexpr int WH = FT > 0 ? (FT + ST - 1) / ST : 0;  // windows over an
  const int wh = WH > 0 ? WH : (F + S - 1) / S;         // element, a dim
  const float area = (float)(F * F);
  const int per = (h1 - h0) * W * NU;
  for (int e = threadIdx.x; e < per; e += kThreads) {
    const int rw = e / NU, j = e - rw * NU;
    const int hh = rw / W, w = rw - hh * W, h = h0 + hh;
    const int oh_a = min(h / S, Ho - 1);
    const int oh_b = h >= F ? (h - F + S) / S : 0;
    const int ow_a = min(w / S, Wo - 1);
    const int ow_b = w >= F ? (w - F + S) / S : 0;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int i = 0; i < wh; ++i) {
      const int oh = oh_a - i;
      if (oh < oh_b) break;
      const int tb = (h - oh * S) * F + w;  // tap of (h, w), less ow*S
#pragma unroll
      for (int k = 0; k < wh; ++k) {
        const int ow = ow_a - k;
        if (ow < ow_b) break;
        const int idx = ((oh - oh_lo) * Wo + ow) * NU + j;
        const unsigned gw = gsm[idx];
        const float g0 = repro::storage::lo_bf16(gw);
        const float g1 = repro::storage::hi_bf16(gw);
        if (avg) {
          a0 += g0 / area;
          a1 += g1 / area;
        } else {
          const unsigned tw = tsm[idx], t = tb - ow * S;
          if ((tw & 0xFFFFu) == t) a0 += g0;
          if ((tw >> 16) == t) a1 += g1;
        }
      }
    }
    const int n = PAIR ? 2 * (q0 + j) : q0 + j;
    const long long i = xc + ((long long)h * W + w) * N + n;
    if (relu_mask) {
      const unsigned v = ld_unit(x + i, PAIR);
      a0 *= mask(repro::storage::lo_bf16(v), true);
      a1 *= mask(repro::storage::hi_bf16(v), true);
    }
    st_unit(dx + i, a0, a1, PAIR);
  }
}

template <int FT, int ST, bool PAIR>
cudaError_t launch_chwn_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                             __nv_bfloat16* dx, int N, int C, int H, int W,
                             int F, int S, int Ho, int Wo, int band,
                             int win_rows, int avg, int relu_mask,
                             Strides4 gs, cudaStream_t s) {
  const int U = PAIR ? N / 2 : N;
  if (!avg && F <= S) {
    const long long units = (long long)C * Ho * Wo * U;
    const long long blocks = (units + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
    pool_backward_direct_bf16<FT, ST, PAIR>
        <<<(unsigned)blocks, kThreads, 0, s>>>(x, g, dx, N, H, W, F, S, Ho,
                                                Wo, U, units, relu_mask, gs);
    return cudaGetLastError();
  }
  const int smem = chwn_bf16_smem_bytes(win_rows * Wo);
  if (smem > kDefaultSmem) {  // the attribute costs host time a launch
    const cudaError_t e = cudaFuncSetAttribute(
        pool_backward_banded_bf16<FT, ST, PAIR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((H + band - 1) / band, C, (U + 31) / 32);
  pool_backward_banded_bf16<FT, ST, PAIR><<<grid, kThreads, smem, s>>>(
      x, g, dx, N, H, W, F, S, Ho, Wo, U, band, avg, relu_mask, gs);
  return cudaGetLastError();
}

template <bool PAIR>
cudaError_t pool_backward_chwn_bf16(const __nv_bfloat16* x,
                                    const __nv_bfloat16* g,
                                    __nv_bfloat16* dx, int N, int C, int H,
                                    int W, int F, int S, int Ho, int Wo,
                                    int band, int win_rows, int avg,
                                    int relu_mask, Strides4 gs,
                                    cudaStream_t s) {
  if (F == 2 && S == 2)
    return launch_chwn_bf16<2, 2, PAIR>(x, g, dx, N, C, H, W, F, S, Ho, Wo,
                                        band, win_rows, avg, relu_mask, gs,
                                        s);
  if (F == 3 && S == 2)
    return launch_chwn_bf16<3, 2, PAIR>(x, g, dx, N, C, H, W, F, S, Ho, Wo,
                                        band, win_rows, avg, relu_mask, gs,
                                        s);
  return launch_chwn_bf16<0, 0, PAIR>(x, g, dx, N, C, H, W, F, S, Ho, Wo,
                                      band, win_rows, avg, relu_mask, gs, s);
}
#endif

}  // namespace

// K7a: x, dx [C, H, W, N]; g [C, Ho, Wo, N] or (g_nchw) [N, C, Ho, Wo]; all
// three REPRO_WT (float32, or bf16 in the bf16 build, which runs the direct
// or the banded bf16 kernel).
// A block covers `band` dx rows and touches at most `win_rows` window rows
// (backward.py::pool_backward_band; the direct kernel has no band).
extern "C" int REPRO_ENTRY(pool_backward_chwn)(
    const void* x, const void* g, void* dx, int N, int C, int H, int W,
    int F, int S, int avg, int relu_mask, int g_nchw, int band, int win_rows,
    void* stream) {
  const int Ho = (H - F) / S + 1, Wo = (W - F) / S + 1;
  if (N <= 0 || C <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaGetLastError();
  if (band < 1 || win_rows < 1 || F * F >= kNoTap || C > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides4 gs = strides_of(g_nchw != 0, N, C, Ho, Wo);
  const T* xf = static_cast<const T*>(x);
  const T* gf = static_cast<const T*>(g);
  T* df = static_cast<T*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if defined(REPRO_VARIANT_BF16)
  if (chwn_bf16_smem_bytes(win_rows * Wo) > 232448)
    return (int)cudaErrorInvalidValue;
  // two images a unit where every even n starts a 4-byte word of x, dx and
  // (where it runs along n) g
  const bool pair = N % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(dx) % 4 == 0 &&
                    (g_nchw || reinterpret_cast<uintptr_t>(g) % 4 == 0);
  return static_cast<int>(
      pair ? pool_backward_chwn_bf16<true>(xf, gf, df, N, C, H, W, F, S, Ho,
                                           Wo, band, win_rows, avg,
                                           relu_mask, gs, s)
           : pool_backward_chwn_bf16<false>(xf, gf, df, N, C, H, W, F, S, Ho,
                                            Wo, band, win_rows, avg,
                                            relu_mask, gs, s));
#else
  const int smem = chwn_smem_bytes(win_rows * Wo, band, W);
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
#endif
}

// K7b: x, dx [N, C, H, W]; g [N, C, Ho, Wo] or (g_nchw = 0) [C, Ho, Wo, N];
// all three REPRO_WT.
// A block covers `planes` (n, c) planes and `band` dx rows of each, and
// touches at most `win_rows` window rows
// (backward.py::pool_backward_planes).
extern "C" int REPRO_ENTRY(pool_backward_nchw)(
    const void* x, const void* g, void* dx, int N, int C, int H, int W,
    int F, int S, int avg, int relu_mask, int g_nchw, int planes, int band,
    int win_rows, void* stream) {
  const int Ho = (H - F) / S + 1, Wo = (W - F) / S + 1;
  if (N <= 0 || C <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaGetLastError();
  const long long np = static_cast<long long>(N) * C;
  if (planes < 1 || band < 1 || win_rows < 1 || F * F >= kNoTap ||
      np > 0x7fffffffLL || (np + planes - 1) / planes > 0x7fffffffLL ||
      (H + band - 1) / band > 65535)
    return (int)cudaErrorInvalidValue;
  const long long smem = nchw_smem_bytes(planes, win_rows, F, S, W, Wo);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const Strides4 gs = strides_of(g_nchw != 0, N, C, Ho, Wo);
  const T* xf = static_cast<const T*>(x);
  const T* gf = static_cast<const T*>(g);
  T* df = static_cast<T*>(dx);
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (F == 3 && S == 2)  // ResNet-18's overlapping pool
    e = launch_nchw<3, 2>(xf, gf, df, N, C, H, W, F, S, Ho, Wo, planes, band,
                          win_rows, (int)smem, avg, relu_mask, vec, gs, s);
  else if (F == 2 && S == 2)  // VGG16's
    e = launch_nchw<2, 2>(xf, gf, df, N, C, H, W, F, S, Ho, Wo, planes, band,
                          win_rows, (int)smem, avg, relu_mask, vec, gs, s);
  else
    e = launch_nchw<0, 0>(xf, gf, df, N, C, H, W, F, S, Ho, Wo, planes, band,
                          win_rows, (int)smem, avg, relu_mask, vec, gs, s);
  return static_cast<int>(e);
}
