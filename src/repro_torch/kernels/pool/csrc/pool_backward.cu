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
// pool_backward_{chwn,nchw}_bf16 over bf16 x, g and dx, which run kernels
// of their own (below).  Each window's first max is found among the
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
//
// K7b bf16 works in bf16 bytes too:
//   pair (S = 2, F = 2 or 3, W % 8 == 0 and 16-byte aligned x and dx:
//     ResNet-18's 3/2 pool, VGG16's 2/2 ones): a thread takes a window row
//     k and 8 columns.  It holds the x rows of its four windows and their g
//     in registers, finds their first-max taps, and forms dx rows 2k and
//     2k + 1 of its columns as 16-byte stores; for 3/2 the block passes
//     each thread's window words to the row below and the chunk to the
//     right through shared memory (one barrier).  x is read 1.5 times
//     (row 2k + 2 by two threads, the second from L1 or L2), g and dx once.
//   banded (every other case, the 7 x 7 global average pool among them):
//     the float32 design's two phases in bf16 bytes: max stages the x rows
//     as bf16 (halfword copies) and a block keeps a word a window (g and
//     the first-max tap's row and column); a thread forms 8 dx elements
//     along w, stored as halfwords; avg reads each element's x once, for
//     its mask, in phase 2.
// backward.py::k7b_bf16_pair_item, ::k7b_bf16_phase1_item and
// ::k7b_bf16_phase2_item are these maps in Python.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/storage.cuh"

namespace {

using repro::storage::ld;
using repro::storage::put;
using repro::storage::widen;
using T = REPRO_WT;  // the storage type of x, g and dx

#if !defined(REPRO_VARIANT_BF16)
// K7b float32's row quads: elements 4 r .. 4 r + 3 of base by one 16-byte
// load, and 4 values by one 16-byte store
__device__ __forceinline__ float4 load4(const float* base, int r) {
  return __ldg(reinterpret_cast<const float4*>(base) + r);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
#endif

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

#if !defined(REPRO_VARIANT_BF16)  // K7b bf16 runs kernels of its own
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
#endif

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

// a staged x row of K7b bf16's banded kernel: W rounded up to 8 (16-byte
// rows; a thread reads 8 elements of a row for its mask)
constexpr int kXRound = 8;
__host__ __device__ __forceinline__ int k7b_xw(int W) {
  return (W + kXRound - 1) / kXRound * kXRound;
}
// a K7b bf16 window's word: its g (bf16 bits) in the low half, its
// first-max tap's row ty in byte 2 and column tx in byte 3; kNoWin (ty
// 0xFF, g +0) matches no element: a window holding a NaN (its g kept), a
// slot with no window
constexpr unsigned kNoWin = 0xFFFF0000u;

// dynamic shared memory of a banded K7b bf16 block: for each of its planes
// the x rows its windows cover [(win_rows - 1) S + F][k7b_xw] bf16, and a
// word a window [win_rows][Wo]
long long nchw_bf16_smem_bytes(int planes, int win_rows, int F, int S, int W,
                               int Wo) {
  return static_cast<long long>(planes) *
         (2LL * ((win_rows - 1) * S + F) * k7b_xw(W) + 4LL * win_rows * Wo);
}

// K7b bf16's memory accesses (tools/timing_variants.py swaps them for
// stand-ins to time the kernel's parts): one x element into shared memory,
// 8 x elements by one 16-byte load, one g element's bits, 8 dx elements
// by one 16-byte store (wide) or [0, n) by halfwords
__device__ __forceinline__ void stage_x(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src) {
  *reinterpret_cast<unsigned short*>(dst) =
      __ldg(reinterpret_cast<const unsigned short*>(src));
}
__device__ __forceinline__ uint4 ld_x8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
// 8 x elements [0, n) of a row (0 past n) by halfwords
__device__ __forceinline__ uint4 ld_row8(const __nv_bfloat16* p, int n) {
  unsigned v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = j < n ? __ldg(reinterpret_cast<const unsigned short*>(p) + j) : 0u;
  return make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                    v[6] | v[7] << 16);
}
__device__ __forceinline__ unsigned ld_g1(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ void store_dx(__nv_bfloat16* d,
                                         const float (&acc)[8], bool wide,
                                         int n) {
  if (wide) {
    *reinterpret_cast<uint4*>(d) = make_uint4(
        repro::mma::pack_bf16(acc[0], acc[1]),
        repro::mma::pack_bf16(acc[2], acc[3]),
        repro::mma::pack_bf16(acc[4], acc[5]),
        repro::mma::pack_bf16(acc[6], acc[7]));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) put(d + j, acc[j]);
  }
}

// the index e = (a B + b) C + c of a block-stride loop, stepped by kThreads
// with no division a step
struct Step3 {
  int a, b, c;
  __device__ __forceinline__ Step3(int e, int B, int C)
      : a(e / (B * C)), b(e / C % B), c(e % C) {}
  __device__ __forceinline__ void add(const Step3& d, int B, int C) {
    c += d.c;
    b += d.b;
    a += d.a;
    if (c >= C) {
      c -= C;
      ++b;
    }
    if (b >= B) {
      b -= B;
      ++a;
    }
  }
};

// g's offset of plane p = n C + c (p Ho Wo where g is NCHW)
__device__ __forceinline__ long long g_plane(const Strides4& gs, int C,
                                             long long p) {
  return gs.n == C * gs.c ? p * gs.c : (p / C) * gs.n + (p % C) * gs.c;
}

// the windows of one window row that can hold 8 dx elements w0 .. w0 + 7
// of a row at tap row dy, for S = 2 and w0 = 8 i: wd[m + 1] is the word of
// window ow = 4 i + m, m = -1 .. 3.  Element j lies in the windows with
// 2 m <= j < 2 m + FT, at tap column j - 2 m; each adds its g (divided by
// F * F for avg; for max only where its first-max tap is (dy, j - 2 m)) in
// ow-descending order.
template <int FT>
__device__ __forceinline__ void add_row(float (&acc)[8],
                                        const unsigned (&wd)[5], int dy,
                                        bool avg) {
  float gv[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    gv[m] = repro::storage::lo_bf16(wd[m]);
    if (avg) gv[m] /= static_cast<float>(FT * FT);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int m = j >> 1; m >= -((FT - 1 - j) >> 1); --m) {
      const unsigned want = static_cast<unsigned>(dy) |
                            static_cast<unsigned>(j - 2 * m) << 8;
      acc[j] += avg || wd[m + 1] >> 16 == want ? gv[m + 1] : 0.f;
    }
}

// dx *= (x > 0) for 8 elements, x as 8 bf16
__device__ __forceinline__ void mask8(float (&acc)[8], const uint4& q) {
  const unsigned qq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[2 * j] *= mask(repro::storage::lo_bf16(qq[j]), true);
    acc[2 * j + 1] *= mask(repro::storage::hi_bf16(qq[j]), true);
  }
}

// bf16 pairs: the NaN-propagating max, and 0xFFFF in each half where a ==
// b (as numbers: -0 == +0, NaN equals nothing)
__device__ __forceinline__ unsigned bmax2_nan(unsigned a, unsigned b) {
  unsigned d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned beq2(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the first-max tap keys (ty | tx << 8; 0xFFFF where the window holds a
// NaN) of windows m and m + 1 at S = 2, both at once in bf16 pairs: q[rr][j]
// holds columns 2j and 2j + 1 of tap row rr, q[rr][4] column 8
template <int FT>
__device__ __forceinline__ void first_max2(const unsigned (&q)[FT][5], int m,
                                           unsigned& k0, unsigned& k1) {
  unsigned t[FT * FT];
#pragma unroll
  for (int rr = 0; rr < FT; ++rr)
#pragma unroll
    for (int cc = 0; cc < FT; ++cc)
      t[rr * FT + cc] = __byte_perm(q[rr][m + cc / 2], q[rr][m + cc / 2 + 1],
                                    cc % 2 ? 0x7632 : 0x5410);
  unsigned mx = t[0];
#pragma unroll
  for (int u = 1; u < FT * FT; ++u) mx = bmax2_nan(mx, t[u]);
  unsigned bits = 0;
#pragma unroll
  for (int u = 0; u < FT * FT; ++u)
    bits |= (beq2(t[u], mx) & 0x00010001u) << u;
  const int f0 = __ffs(bits & 0xFFFFu) - 1, f1 = __ffs(bits >> 16) - 1;
  k0 = (mx & 0x7FFFu) > 0x7F80u ? 0xFFFFu : f0 / FT | (f0 % FT) << 8;
  k1 = (mx & 0x7FFF0000u) > 0x7F800000u ? 0xFFFFu : f1 / FT | (f1 % FT) << 8;
}

// K7b bf16's pair kernel: S = 2, F = FT (2 or 3), W % 8 == 0, x and dx
// 16-byte aligned (ResNet-18's 3/2 pool, VGG16's 2/2 ones).  Block (p, b)
// takes plane p and window rows [k0, k0 + KB), k0 = b KB, and for FT = 3
// the row k0 - 1 above them (its words only).  Thread t = r WQ + i (WQ =
// W / 8) takes window row k = k0 - H3 + r (H3 = 1 for FT = 3, else 0) and
// chunk i: it loads x rows 2k .. 2k + FT - 1 at columns 8 i .. 8 i + 7 by
// 16-byte loads (and column 8 i + 8 for FT = 3) and the g of windows ow = 4
// i .. 4 i + 3, every load issued before any is used, finds those windows'
// first-max taps two windows at once in bf16 pairs (the max, then the
// first tap equal to it: the first strictly greater one), and forms dx
// rows 2k and 2k + 1 of its chunk, masked by the x it holds, as two 16-byte
// stores.  For FT = 3 a row's element at tap row 2 also takes the window
// row above, and column 8 i the window to the left: the block exchanges
// the words through shared memory (one barrier).  FT = 2's windows share
// no element: no shared memory, no barrier.
template <int FT>
__global__ void __launch_bounds__(kThreads)
pool_backward_pair_bf16(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g,
                        __nv_bfloat16* __restrict__ dx, int C, int H, int W,
                        int Ho, int Wo, int KB, int avg, int relu_mask,
                        Strides4 gs) {
  constexpr int H3 = FT == 3 ? 1 : 0;
  extern __shared__ __align__(16) unsigned pw[];  // [KB + 1][4 + W / 2]
  const int WQ = W / 8, RS = 4 + 4 * WQ;
  const int r = threadIdx.x / WQ, i = threadIdx.x - r * WQ;
  const int k = blockIdx.y * KB - H3 + r;
  const long long p = blockIdx.x;
  const bool live = r < KB + H3;
  const bool win = live && k >= 0 && k < Ho;        // a window row
  const bool own = live && r >= H3 && 2 * k < H;    // dx rows 2k, 2k + 1
  const __nv_bfloat16* xr = x + (p * H + 2 * k) * W + 8 * i;

  uint4 xq[FT];
  unsigned short x9[FT];
  unsigned wd[4];
#pragma unroll
  for (int rr = 0; rr < FT; ++rr) {
    // the window's rows, and the mask's (2k and 2k + 1, which may lie
    // under the row above's windows only); one predicate a load, no branch
    const bool need = (win || (own && rr < 2)) && 2 * k + rr < H;
    xq[rr] = need ? ld_x8(xr + rr * W) : make_uint4(0u, 0u, 0u, 0u);
    x9[rr] = FT == 3 && win && 8 * i + 8 < W
                 ? __ldg(reinterpret_cast<const unsigned short*>(xr + rr * W) +
                         8)
                 : 0;
  }
  const __nv_bfloat16* gp = g + g_plane(gs, C, p) + k * gs.h;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    wd[m] = win && 4 * i + m < Wo ? ld_g1(gp + (4 * i + m) * gs.w) : 0u;

  // the four windows' words
  if (!avg) {
    unsigned q[FT][5];
#pragma unroll
    for (int rr = 0; rr < FT; ++rr) {
      q[rr][0] = xq[rr].x;
      q[rr][1] = xq[rr].y;
      q[rr][2] = xq[rr].z;
      q[rr][3] = xq[rr].w;
      q[rr][4] = x9[rr];
    }
#pragma unroll
    for (int m = 0; m < 4; m += 2) {
      unsigned k0, k1;
      first_max2<FT>(q, m, k0, k1);
      wd[m] |= k0 << 16;
      wd[m + 1] |= k1 << 16;
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (!win || 4 * i + m >= Wo) wd[m] = kNoWin;

  // the words of this window row (w5[m + 1]: ow = 4 i + m) and, for FT = 3,
  // of the row above
  unsigned w5[5] = {kNoWin, wd[0], wd[1], wd[2], wd[3]};
  unsigned up[5] = {kNoWin, kNoWin, kNoWin, kNoWin, kNoWin};
  if constexpr (FT == 3) {
    if (live) {
      unsigned* row = pw + r * RS + 4;
      *reinterpret_cast<uint4*>(row + 4 * i) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
      if (i == 0)
        *reinterpret_cast<uint4*>(row - 4) =
            make_uint4(kNoWin, kNoWin, kNoWin, kNoWin);
    }
    __syncthreads();
    if (!own) return;
    const unsigned* row = pw + r * RS + 4;
    const unsigned* above = row - RS;
    const uint4 q = *reinterpret_cast<const uint4*>(above + 4 * i);
    w5[0] = row[4 * i - 1];
    up[0] = above[4 * i - 1];
    up[1] = q.x;
    up[2] = q.y;
    up[3] = q.z;
    up[4] = q.w;
  } else {
    if (!own) return;
  }

  // dx row 2k: this window row at tap row 0, then (FT = 3) the one above
  // at tap row 2; dx row 2k + 1: this window row at tap row 1
  __nv_bfloat16* d = dx + (p * H + 2 * k) * W + 8 * i;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  add_row<FT>(acc, w5, 0, avg);
  if constexpr (FT == 3) add_row<FT>(acc, up, 2, avg);
  if (relu_mask) mask8(acc, xq[0]);
  store_dx(d, acc, true, 8);
  if (2 * k + 1 < H) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    add_row<FT>(acc, w5, 1, avg);
    if (relu_mask) mask8(acc, xq[1]);
    store_dx(d + W, acc, true, 8);
  }
}

// K7b bf16's banded kernel, every other case: x, dx [N, C, H, W] bf16, the
// (n, c) planes p = n C + c; g through gs.  A block takes P consecutive
// planes and dx rows [h0, h0 + band) of each (pool_backward_planes with
// itemsize 2).
__global__ void __launch_bounds__(kThreads)
pool_backward_nchw_bf16(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g,
                        __nv_bfloat16* __restrict__ dx, int planes, int C,
                        int H, int W, int F, int S, int Ho, int Wo, int P,
                        int band, int win_rows, int avg, int relu_mask,
                        Strides4 gs) {
  extern __shared__ __align__(16) unsigned smw[];
  const int p0 = blockIdx.x * P, pc = min(P, planes - p0);
  const int h0 = blockIdx.y * band, h1 = min(H, h0 + band);
  // the window rows that touch [h0, h1), and the x rows they cover
  const int oh_lo = h0 >= F ? (h0 - F + S) / S : 0;
  const int oh_hi = min(Ho - 1, (h1 - 1) / S);
  const int wr = max(0, oh_hi - oh_lo + 1);
  const int xr0 = oh_lo * S, xr = wr > 0 ? min(H, oh_hi * S + F) - xr0 : 0;
  const int XW = k7b_xw(W), XP = ((win_rows - 1) * S + F) * XW;
  const int GP = win_rows * Wo;
  // [P][x rows][XW] bf16, then [P][win_rows][Wo] words
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smw);
  unsigned* wsm = smw + P * XP / 2;
  const long long HW = static_cast<long long>(H) * W;

  // staging (max): the x rows of every plane, at their storage width (a
  // band under no window has none, and no window words); avg reads each
  // element's x once, for its mask, in phase 2
  if (!avg && xr > 0) {
    const __nv_bfloat16* xb = x + p0 * HW + static_cast<long long>(xr0) * W;
    const Step3 d(kThreads, xr, W);
    for (Step3 it(threadIdx.x, xr, W); it.a < pc; it.add(d, xr, W))
      stage_x(xs + it.a * XP + it.b * XW + it.c,
              xb + it.a * HW + it.b * W + it.c);
  }
  if (!avg) __syncthreads();  // phase 1 reads them

  // phase 1: each window's word: its g, and for max its first maximal tap
  // in row-major order among the widened values (the first strictly
  // greater one; a window holding a NaN gets kNoWin's taps)
  if (wr > 0) {
    const Step3 d(kThreads, wr, Wo);
    for (Step3 it(threadIdx.x, wr, Wo); it.a < pc; it.add(d, wr, Wo)) {
      const int pl = it.a, rw = it.b, ow = it.c, oh = oh_lo + rw;
      unsigned wd =
          ld_g1(g + g_plane(gs, C, p0 + pl) + oh * gs.h + ow * gs.w);
      if (!avg) {
        const __nv_bfloat16* xw = xs + pl * XP + rw * S * XW + ow * S;
        float mx = -INFINITY;
        unsigned ty = 0, tx = 0;
        bool has_nan = false;
        for (int dy = 0; dy < F; ++dy)
          for (int dxx = 0; dxx < F; ++dxx) {
            const float val = widen(xw[dy * XW + dxx]);
            has_nan |= val != val;
            if (val > mx) {
              mx = val;
              ty = dy;
              tx = dxx;
            }
          }
        wd |= has_nan ? kNoWin : (ty << 16) | (tx << 24);
      }
      wsm[pl * GP + rw * Wo + ow] = wd;
    }
  }
  __syncthreads();

  // phase 2: a thread forms 8 dx elements along w of one row from the
  // words: each window's share added in the reference's order (windows
  // oh, then ow, descending: taps dy, dx ascending) in float32, the ReLU
  // mask from the staged row, rounded once, stored by halfwords
  const int wh = (F + S - 1) / S;  // window rows over an element, at most
  const float area = static_cast<float>(F * F);
  const int WQ = (W + 7) / 8, rows = h1 - h0;
  const Step3 d(kThreads, rows, WQ);
  for (Step3 it(threadIdx.x, rows, WQ); it.a < pc; it.add(d, rows, WQ)) {
    const int pl = it.a, h = h0 + it.b, w0 = 8 * it.c;
    const int oh_a = min(h / S, Ho - 1);
    const int oh_b = h >= F ? (h - F + S) / S : 0;
    const int ow_a = min((w0 + 7) / S, Wo - 1);
    const int ow_b = w0 >= F ? (w0 - F + S) / S : 0;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int oh = oh_a; oh >= max(oh_b, oh_a - wh + 1); --oh) {
      const int dy = h - oh * S;
      // the word of window (oh, ow) is row[ow]
      const unsigned* row = wsm + pl * GP + (oh - oh_lo) * Wo;
      for (int ow = ow_a; ow >= ow_b; --ow) {
        const unsigned wd = row[ow];
        const float gv = repro::storage::lo_bf16(wd);
        if (avg) {
          const float ga = gv / area;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = w0 + j - ow * S;
            acc[j] += col >= 0 && col < F ? ga : 0.f;
          }
        } else {
          const bool hit = static_cast<int>((wd >> 16) & 0xFFu) == dy;
          const int col = ow * S + static_cast<int>(wd >> 24) - w0;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] += hit && col == j ? gv : 0.f;
        }
      }
    }
    // a row under no window (acc all 0: above the first window row where
    // F < S, or past the last) reads the nearest staged row
    if (relu_mask && avg)
      mask8(acc, ld_row8(x + (p0 + pl) * HW + static_cast<long long>(h) * W +
                             w0,
                         W - w0));
    else if (relu_mask && xr > 0)
      mask8(acc, *reinterpret_cast<const uint4*>(
                     xs + pl * XP + max(0, min(h - xr0, xr - 1)) * XW + w0));
    store_dx(dx + (p0 + pl) * HW + static_cast<long long>(h) * W + w0, acc,
             false, W - w0);
  }
}

cudaError_t launch_nchw_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                             __nv_bfloat16* dx, int N, int C, int H, int W,
                             int F, int S, int Ho, int Wo, int P, int band,
                             int win_rows, int smem, int avg, int relu_mask,
                             Strides4 gs, cudaStream_t s) {
  if (smem > kDefaultSmem) {  // the attribute costs host time a launch
    const cudaError_t e = cudaFuncSetAttribute(
        pool_backward_nchw_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const int planes = N * C;
  const dim3 grid((planes + P - 1) / P, (H + band - 1) / band);
  pool_backward_nchw_bf16<<<grid, kThreads, smem, s>>>(
      x, g, dx, planes, C, H, W, F, S, Ho, Wo, P, band, win_rows, avg,
      relu_mask, gs);
  return cudaGetLastError();
}

// the pair kernel's window rows a block (backward.py::k7b_bf16_pairs): the
// most whose threads, with the row above for FT = 3, fit kThreads, evened
// out over the bands the plane's ceil(H / 2) row pairs then need; 0 where
// a block of two rows would not fit
int pair_rows(int H, int W, int F) {
  const int WQ = W / 8, halo = F == 3 ? 1 : 0;
  const int most = kThreads / WQ - halo;
  if (most < 1) return 0;
  const int K = (H + 1) / 2, bands = (K + most - 1) / most;
  return (K + bands - 1) / bands;
}

template <int FT>
cudaError_t launch_pair_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                             __nv_bfloat16* dx, int N, int C, int H, int W,
                             int Ho, int Wo, int KB, int avg, int relu_mask,
                             Strides4 gs, cudaStream_t s) {
  const int WQ = W / 8, rows = KB + (FT == 3 ? 1 : 0);
  const int threads = (rows * WQ + 31) / 32 * 32;
  const int smem = FT == 3 ? rows * (4 + 4 * WQ) * 4 : 0;
  const dim3 grid(N * C, ((H + 1) / 2 + KB - 1) / KB);
  pool_backward_pair_bf16<FT><<<grid, threads, smem, s>>>(
      x, g, dx, C, H, W, Ho, Wo, KB, avg, relu_mask, gs);
  return cudaGetLastError();
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
  const Strides4 gs = strides_of(g_nchw != 0, N, C, Ho, Wo);
  const T* xf = static_cast<const T*>(x);
  const T* gf = static_cast<const T*>(g);
  T* df = static_cast<T*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if defined(REPRO_VARIANT_BF16)
  const long long smem = nchw_bf16_smem_bytes(planes, win_rows, F, S, W, Wo);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // S = 2 and F = 2 or 3 on whole 16-byte rows: the pair kernel
  const int kb = S == 2 && (F == 2 || F == 3) && W % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(dx) % 16 == 0
                     ? pair_rows(H, W, F)
                     : 0;
  cudaError_t e;
  if (kb > 0 && F == 3)
    e = launch_pair_bf16<3>(xf, gf, df, N, C, H, W, Ho, Wo, kb, avg,
                            relu_mask, gs, s);
  else if (kb > 0)
    e = launch_pair_bf16<2>(xf, gf, df, N, C, H, W, Ho, Wo, kb, avg,
                            relu_mask, gs, s);
  else
    e = launch_nchw_bf16(xf, gf, df, N, C, H, W, F, S, Ho, Wo, planes, band,
                         win_rows, (int)smem, avg, relu_mask, gs, s);
  return static_cast<int>(e);
#else
  const long long smem = nchw_smem_bytes(planes, win_rows, F, S, W, Wo);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dx) % 16 == 0;
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
#endif
}
