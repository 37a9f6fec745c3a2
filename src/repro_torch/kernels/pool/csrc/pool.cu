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
//
// K3a bf16 runs a kernel of its own (pool_chwn_bf16_kernel), built only
// into the bf16 library.  Its lanes run over (wo, n), n fastest, so a warp
// fills at any N: at N = 8 it takes 8 neighbouring outputs of a row, where
// the float32 design's lanes along n left 24 of 32 idle.  Where N is even
// (and x 4-byte aligned) a lane moves two neighbouring images by one 4-byte
// access, so a unit is an image pair; else a single image.  A thread makes
// one output unit: it issues all the loads of its window (for a window
// other than 2/2 and 3/2, a row 8 taps at a time, with no branch between
// them) before it combines any, then takes the max or the float32 sum in
// row-major (dy, dx) order, divides and rounds once.  Overlapping windows
// read their shared columns again, from L1.  A window wider than 8 whose
// taps fit 48 KB (unet_mini's 32 x 32 global pool) is copied into shared
// memory by a block first, every load in flight at once, and each unit's
// thread combines its taps from there in the same order
// (pool_chwn_bf16_window_kernel), so that no thread waits on a chain of
// 1024 global loads.  pool.ops.k3a_bf16_unit is the map in Python.
//
// K3b bf16 runs a kernel of its own too (pool_nchw_bf16_kernel), not the
// float32 K3b's uncoalesced design, which stays for the unfused layout
// comparison (whose executor takes no dtype).  A thread makes two
// neighbouring outputs of a row (wo = 2q, 2q + 1), lanes along q: for each
// window row it loads the S + F columns the pair spans once, by 8-byte
// loads where W % 4 == 0 and x is 8-byte aligned (for 2/2 one load a row,
// neighbouring lanes 8 bytes apart: coalesced), else 4-byte words where W
// is even, else halfwords; every load of the window is issued before any
// is combined, with no branch between them.  Each tap is widened; the max
// (NaN-propagating, from -inf) or the float32 sum in row-major (dy, dx)
// order, divided by F * F, is rounded once where it is stored: the pair as
// one 4-byte word where y runs along w (NCHW, Wo even), else a halfword
// each through y's strides.  pool.ops.k3b_bf16_unit is the map in Python.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

#if defined(REPRO_VARIANT_BF16)
constexpr int kBf16Threads = 256;  // K3a and K3b bf16 threads per block
constexpr int kRow = 8;  // taps of a window row a K3a (K3b) bf16 thread
                         // loads at once

// one unit's taps: two images (the halves of a 4-byte word) or one (the
// low half)
__device__ __forceinline__ unsigned load_unit(const __nv_bfloat16* p,
                                              bool pair) {
  return pair ? __ldg(reinterpret_cast<const unsigned*>(p))
              : __ldg(reinterpret_cast<const unsigned short*>(p));
}

// a unit's max or float32 sum (divided by F * F for avg), rounded once
// into y at (c, ho, wo) of images n (and n + 1): one 4-byte word where y
// runs along n, else a halfword each
template <bool AVG, bool PAIR>
__device__ __forceinline__ void store_unit(__nv_bfloat16* y, const Out& ys,
                                           long long c, int ho, int wo,
                                           int n, int F, float a0,
                                           float a1) {
  if (AVG) {
    const float area = (float)(F * F);
    a0 /= area;
    a1 /= area;
  }
  __nv_bfloat16* yp = y + (long long)n * ys.n + c * ys.c +
                      (long long)ho * ys.h + (long long)wo * ys.w;
  if (PAIR && ys.n == 1) {
    *reinterpret_cast<unsigned*>(yp) = repro::mma::pack_bf16(a0, a1);
  } else {
    put(yp, a0);
    if (PAIR) put(yp + ys.n, a1);
  }
}

// K3a bf16: unit u = ((c Ho + ho) Wo + wo) U + q, U = N / 2 image pairs
// (PAIR) or N images; the unit's images are 2q, 2q + 1 or q.  FT, ST > 0
// fix F and S at compile time (every load of the window issued at once);
// else a window row is loaded kRow taps at a time.
template <int FT, int ST, bool AVG, bool PAIR>
__global__ void __launch_bounds__(kBf16Threads)
pool_chwn_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ y, int N, int H, int W,
                      int F_, int S_, int Ho, int Wo, int U, long long units,
                      Out ys) {
  const long long u = (long long)blockIdx.x * kBf16Threads + threadIdx.x;
  if (u >= units) return;
  const int F = FT > 0 ? FT : F_, S = ST > 0 ? ST : S_;
  long long r = u / U;
  const int q = (int)(u - r * U);
  const int wo = (int)(r % Wo);
  r /= Wo;
  const int ho = (int)(r % Ho);
  const long long c = r / Ho;
  const int n = PAIR ? 2 * q : q;
  const __nv_bfloat16* xp =
      x + ((c * H + (long long)ho * S) * W + (long long)wo * S) * N + n;
  float a0 = AVG ? 0.f : -INFINITY, a1 = a0;
  if constexpr (FT > 0) {
    unsigned v[FT * FT];
#pragma unroll
    for (int dy = 0; dy < FT; ++dy)
#pragma unroll
      for (int dx = 0; dx < FT; ++dx)
        v[dy * FT + dx] = load_unit(xp + (dy * W + dx) * N, PAIR);
#pragma unroll
    for (int t = 0; t < FT * FT; ++t) {
      a0 = tap<AVG>(a0, repro::storage::lo_bf16(v[t]));
      if (PAIR) a1 = tap<AVG>(a1, repro::storage::hi_bf16(v[t]));
    }
  } else {
    // a row of the window kRow taps at a time, every load issued before any
    // is combined, and no branch among them (which would serialise the
    // rows' latencies): a tap past the row reloads the row's last one and
    // combines the neutral value (0 or -inf), which changes nothing
    const float none = AVG ? 0.f : -INFINITY;
#pragma unroll 2
    for (int dy = 0; dy < F; ++dy) {
      const __nv_bfloat16* xr = xp + dy * W * N;
      for (int dx0 = 0; dx0 < F; dx0 += kRow) {
        unsigned v[kRow];
#pragma unroll
        for (int k = 0; k < kRow; ++k)
          v[k] = load_unit(xr + min(dx0 + k, F - 1) * N, PAIR);
#pragma unroll
        for (int k = 0; k < kRow; ++k) {
          const bool in = dx0 + k < F;
          a0 = tap<AVG>(a0, in ? repro::storage::lo_bf16(v[k]) : none);
          if (PAIR)
            a1 = tap<AVG>(a1, in ? repro::storage::hi_bf16(v[k]) : none);
        }
      }
    }
  }
  store_unit<AVG, PAIR>(y, ys, c, ho, wo, n, F, a0, a1);
}

// large windows whose taps of every image fit kWindowSmem (unet_mini's 32
// x 32 global pool: 16 KB): a block an output position (c, ho, wo), whose
// threads copy the window's rows into shared memory, every load in flight
// at once, before thread q < U combines unit q's taps from there in
// row-major order.  Block b's thread q makes unit b U + q, the same map.
constexpr int kWindowSmem = 48 * 1024;

template <bool AVG, bool PAIR>
__global__ void __launch_bounds__(kBf16Threads)
pool_chwn_bf16_window_kernel(const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ y, int N, int H,
                             int W, int F, int S, int Ho, int Wo, int U,
                             Out ys) {
  extern __shared__ unsigned win[];  // [F * F][U] unit words
  long long r = blockIdx.x;
  const int wo = (int)(r % Wo);
  r /= Wo;
  const int ho = (int)(r % Ho);
  const long long c = r / Ho;
  const __nv_bfloat16* xp =
      x + ((c * H + (long long)ho * S) * W + (long long)wo * S) * N;
  const int row = F * U;  // a window row's unit words, contiguous in x
#pragma unroll 4
  for (int i = threadIdx.x; i < F * row; i += kBf16Threads) {
    const int dy = i / row, k = i - dy * row;
    win[i] = load_unit(xp + dy * W * N + (PAIR ? 2 * k : k), PAIR);
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q >= U) return;
  float a0 = AVG ? 0.f : -INFINITY, a1 = a0;
#pragma unroll 8
  for (int t = 0; t < F * F; ++t) {
    const unsigned v = win[t * U + q];
    a0 = tap<AVG>(a0, repro::storage::lo_bf16(v));
    if (PAIR) a1 = tap<AVG>(a1, repro::storage::hi_bf16(v));
  }
  store_unit<AVG, PAIR>(y, ys, c, ho, wo, PAIR ? 2 * q : q, F, a0, a1);
}

template <int FT, int ST, bool AVG>
void launch_chwn_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int N,
                      int C, int H, int W, int F, int S, int Ho, int Wo,
                      bool pair, Out ys, cudaStream_t s) {
  const int U = pair ? N / 2 : N;
  const long long units = (long long)C * Ho * Wo * U;
  const unsigned blocks = (unsigned)((units + kBf16Threads - 1) / kBf16Threads);
  if (pair)
    pool_chwn_bf16_kernel<FT, ST, AVG, true>
        <<<blocks, kBf16Threads, 0, s>>>(x, y, N, H, W, F, S, Ho, Wo, U,
                                         units, ys);
  else
    pool_chwn_bf16_kernel<FT, ST, AVG, false>
        <<<blocks, kBf16Threads, 0, s>>>(x, y, N, H, W, F, S, Ho, Wo, U,
                                         units, ys);
}

// the kernel for (F, S): 2/2 and 3/2 at compile time; a window wider than
// 8 whose taps fit kWindowSmem through shared memory; else a row kRow taps
// at a time
template <bool AVG>
void pool_chwn_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int N, int C,
                    int H, int W, int F, int S, int Ho, int Wo, bool pair,
                    Out ys, cudaStream_t s) {
  const int U = pair ? N / 2 : N;
  const long long smem = 4LL * F * F * U;
  if (F > 8 && smem <= kWindowSmem && U <= kBf16Threads) {
    const unsigned blocks = (unsigned)((long long)C * Ho * Wo);
    if (pair)
      pool_chwn_bf16_window_kernel<AVG, true>
          <<<blocks, kBf16Threads, (int)smem, s>>>(x, y, N, H, W, F, S, Ho,
                                                   Wo, U, ys);
    else
      pool_chwn_bf16_window_kernel<AVG, false>
          <<<blocks, kBf16Threads, (int)smem, s>>>(x, y, N, H, W, F, S, Ho,
                                                   Wo, U, ys);
  } else if (F == 2 && S == 2) {
    launch_chwn_bf16<2, 2, AVG>(x, y, N, C, H, W, F, S, Ho, Wo, pair, ys, s);
  } else if (F == 3 && S == 2) {
    launch_chwn_bf16<3, 2, AVG>(x, y, N, C, H, W, F, S, Ho, Wo, pair, ys, s);
  } else {
    launch_chwn_bf16<0, 0, AVG>(x, y, N, C, H, W, F, S, Ho, Wo, pair, ys, s);
  }
}

// K3b bf16: unit u = ((n C + c) Ho + ho) Q + q, Q = ceil(Wo / 2), makes
// outputs wo = 2q and 2q + 1 (where 2q + 1 < Wo) of row (n, c, ho).  A
// window row of the unit spans L = S + F columns from w0 = 2 q S.  FT, ST
// > 0 fix F and S at compile time (2/2 and 3/2, where w0 = 4q): each row's
// span is loaded by XV elements at a time (XV 4: 8-byte loads, 2: 4-byte
// words, 1: halfwords), every load of the window issued before any is
// combined.  A load past the row's last whole one is clamped to it: it
// only feeds the second output of a unit that has none.  Else a row's span
// is loaded kRow halfwords at a time, a column past the row clamped to its
// last (it feeds no output that exists).
template <int FT, int ST, int XV, bool AVG>
__global__ void __launch_bounds__(kBf16Threads)
pool_nchw_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ y, int C, int H, int W,
                      int F_, int S_, int Ho, int Wo, int Q, long long units,
                      Out ys, bool word_store) {
  const long long u = (long long)blockIdx.x * kBf16Threads + threadIdx.x;
  if (u >= units) return;
  const int F = FT > 0 ? FT : F_, S = ST > 0 ? ST : S_;
  long long r = u / Q;
  const int q = (int)(u - r * Q);
  const int ho = (int)(r % Ho);
  r /= Ho;                       // the plane n C + c
  const int w0 = 2 * q * S;
  const __nv_bfloat16* xp = x + (r * H + (long long)ho * S) * W;
  float a0 = AVG ? 0.f : -INFINITY, a1 = a0;
  if constexpr (FT > 0) {
    constexpr int L = ST + FT, NV = (L + XV - 1) / XV;
    float v[FT][NV * XV];
    if constexpr (XV == 4) {
      const int last = W / 4 - 1;
      uint2 t[FT][NV];
#pragma unroll
      for (int dy = 0; dy < FT; ++dy)
#pragma unroll
        for (int k = 0; k < NV; ++k)
          t[dy][k] = __ldg(reinterpret_cast<const uint2*>(xp + dy * W) +
                           min(w0 / 4 + k, last));
#pragma unroll
      for (int dy = 0; dy < FT; ++dy)
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          v[dy][4 * k] = repro::storage::lo_bf16(t[dy][k].x);
          v[dy][4 * k + 1] = repro::storage::hi_bf16(t[dy][k].x);
          v[dy][4 * k + 2] = repro::storage::lo_bf16(t[dy][k].y);
          v[dy][4 * k + 3] = repro::storage::hi_bf16(t[dy][k].y);
        }
    } else if constexpr (XV == 2) {
      const int last = W / 2 - 1;
      unsigned t[FT][NV];
#pragma unroll
      for (int dy = 0; dy < FT; ++dy)
#pragma unroll
        for (int k = 0; k < NV; ++k)
          t[dy][k] = __ldg(reinterpret_cast<const unsigned*>(xp + dy * W) +
                           min(w0 / 2 + k, last));
#pragma unroll
      for (int dy = 0; dy < FT; ++dy)
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          v[dy][2 * k] = repro::storage::lo_bf16(t[dy][k]);
          v[dy][2 * k + 1] = repro::storage::hi_bf16(t[dy][k]);
        }
    } else {
      unsigned short t[FT][L];
#pragma unroll
      for (int dy = 0; dy < FT; ++dy)
#pragma unroll
        for (int k = 0; k < L; ++k)
          t[dy][k] = __ldg(reinterpret_cast<const unsigned short*>(xp) +
                           dy * W + min(w0 + k, W - 1));
#pragma unroll
      for (int dy = 0; dy < FT; ++dy)
#pragma unroll
        for (int k = 0; k < L; ++k)
          v[dy][k] = repro::storage::lo_bf16(t[dy][k]);
    }
#pragma unroll
    for (int dy = 0; dy < FT; ++dy)
#pragma unroll
      for (int dx = 0; dx < FT; ++dx) {
        a0 = tap<AVG>(a0, v[dy][dx]);
        a1 = tap<AVG>(a1, v[dy][ST + dx]);
      }
  } else {
    // column k of the span feeds output 0 where k < F and output 1 where
    // S <= k < S + F; elsewhere the neutral value (0 or -inf)
    const float none = AVG ? 0.f : -INFINITY;
    const int L = S + F;
#pragma unroll 2
    for (int dy = 0; dy < F; ++dy) {
      const unsigned short* xr =
          reinterpret_cast<const unsigned short*>(xp) + dy * W;
      for (int k0 = 0; k0 < L; k0 += kRow) {
        unsigned short t[kRow];
#pragma unroll
        for (int k = 0; k < kRow; ++k)
          t[k] = __ldg(xr + min(w0 + k0 + k, W - 1));
#pragma unroll
        for (int k = 0; k < kRow; ++k) {
          const int kk = k0 + k;
          const float val = repro::storage::lo_bf16(t[k]);
          a0 = tap<AVG>(a0, kk < F ? val : none);
          a1 = tap<AVG>(a1, kk >= S && kk < L ? val : none);
        }
      }
    }
  }
  if (AVG) {
    const float area = (float)(F * F);
    a0 /= area;
    a1 /= area;
  }
  const long long c = r % C, n = r / C;
  __nv_bfloat16* yp = y + n * ys.n + c * ys.c + (long long)ho * ys.h +
                      (long long)(2 * q) * ys.w;
  if (word_store) {
    *reinterpret_cast<unsigned*>(yp) = repro::mma::pack_bf16(a0, a1);
  } else {
    put(yp, a0);
    if (2 * q + 1 < Wo) put(yp + ys.w, a1);
  }
}

template <int FT, int ST, bool AVG>
void launch_nchw_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int C,
                      int H, int W, int F, int S, int Ho, int Wo, int Q,
                      long long units, Out ys, bool word_store, int xv,
                      cudaStream_t s) {
  const unsigned blocks = (unsigned)((units + kBf16Threads - 1) / kBf16Threads);
  if (xv == 4)
    pool_nchw_bf16_kernel<FT, ST, 4, AVG><<<blocks, kBf16Threads, 0, s>>>(
        x, y, C, H, W, F, S, Ho, Wo, Q, units, ys, word_store);
  else if (xv == 2)
    pool_nchw_bf16_kernel<FT, ST, 2, AVG><<<blocks, kBf16Threads, 0, s>>>(
        x, y, C, H, W, F, S, Ho, Wo, Q, units, ys, word_store);
  else
    pool_nchw_bf16_kernel<FT, ST, 1, AVG><<<blocks, kBf16Threads, 0, s>>>(
        x, y, C, H, W, F, S, Ho, Wo, Q, units, ys, word_store);
}

// the kernel for (F, S): 2/2 and 3/2 at compile time, by the widest load
// that the row's width and x's base allow; else halfwords kRow at a time
template <bool AVG>
void pool_nchw_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int N, int C,
                    int H, int W, int F, int S, int Ho, int Wo,
                    bool word_store, Out ys, cudaStream_t s) {
  const int Q = (Wo + 1) / 2;
  const long long units = (long long)N * C * Ho * Q;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int xv = W % 4 == 0 && xa % 8 == 0 ? 4
                 : W % 2 == 0 && xa % 4 == 0 ? 2 : 1;
  if (F == 2 && S == 2)
    launch_nchw_bf16<2, 2, AVG>(x, y, C, H, W, F, S, Ho, Wo, Q, units, ys,
                                word_store, xv, s);
  else if (F == 3 && S == 2)
    launch_nchw_bf16<3, 2, AVG>(x, y, C, H, W, F, S, Ho, Wo, Q, units, ys,
                                word_store, xv, s);
  else
    pool_nchw_bf16_kernel<0, 0, 1, AVG>
        <<<(unsigned)((units + kBf16Threads - 1) / kBf16Threads),
           kBf16Threads, 0, s>>>(x, y, C, H, W, F, S, Ho, Wo, Q, units, ys,
                                 word_store);
}
#endif

int pool_out(int hw, int F, int S) { return (hw - F) / S + 1; }

}  // namespace

// K3a: x [C, H, W, N] -> y [C, Ho, Wo, N] (dst_nchw = 0) or
// [N, C, Ho, Wo] (dst_nchw = 1), both REPRO_WT (float32, or bf16 in the
// bf16 build, which runs pool_chwn_bf16_kernel).  Returns
// cudaGetLastError().
extern "C" int REPRO_ENTRY(pool_chwn_forward)(const void* x, void* y,
                                             int N, int C, int H, int W,
                                             int F, int S, int avg,
                                             int dst_nchw, void* stream) {
  const int Ho = pool_out(H, F, S), Wo = pool_out(W, F, S);
#if defined(REPRO_VARIANT_BF16)
  if (N > 0 && C > 0 && Ho > 0 && Wo > 0) {
    const long long units = (long long)C * Ho * Wo * N;
    if ((units + kBf16Threads - 1) / kBf16Threads > 2147483647LL)
      return (int)cudaErrorInvalidConfiguration;
    const Out ys = out_strides(N, C, Ho, Wo, dst_nchw != 0);
    // two images a lane where both bases allow a 4-byte word at every even
    // n (the output's only where it runs along n)
    const bool pair = N % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                      (dst_nchw || reinterpret_cast<uintptr_t>(y) % 4 == 0);
    const T* xf = static_cast<const T*>(x);
    T* yf = static_cast<T*>(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (avg)
      pool_chwn_bf16<true>(xf, yf, N, C, H, W, F, S, Ho, Wo, pair, ys, s);
    else
      pool_chwn_bf16<false>(xf, yf, N, C, H, W, F, S, Ho, Wo, pair, ys, s);
  }
  return static_cast<int>(cudaGetLastError());
#else
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
#endif
}

// K3b: x [N, C, H, W] -> y [N, C, Ho, Wo] (dst_nchw = 1) or
// [C, Ho, Wo, N] (dst_nchw = 0), both REPRO_WT (float32, or bf16 in the
// bf16 build, which runs pool_nchw_bf16_kernel).  Returns
// cudaGetLastError().
extern "C" int REPRO_ENTRY(pool_nchw_forward)(const void* x, void* y,
                                             int N, int C, int H, int W,
                                             int F, int S, int avg,
                                             int dst_nchw, void* stream) {
  const int Ho = pool_out(H, F, S), Wo = pool_out(W, F, S);
#if defined(REPRO_VARIANT_BF16)
  if (N > 0 && C > 0 && Ho > 0 && Wo > 0) {
    const long long units = (long long)N * C * Ho * ((Wo + 1) / 2);
    if ((units + kBf16Threads - 1) / kBf16Threads > 2147483647LL)
      return (int)cudaErrorInvalidConfiguration;
    const Out ys = out_strides(N, C, Ho, Wo, dst_nchw != 0);
    // a unit's two outputs as one 4-byte word where y runs along w and
    // every unit's first output starts a word
    const bool word_store = dst_nchw && Wo % 2 == 0 &&
                            reinterpret_cast<uintptr_t>(y) % 4 == 0;
    const T* xf = static_cast<const T*>(x);
    T* yf = static_cast<T*>(y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (avg)
      pool_nchw_bf16<true>(xf, yf, N, C, H, W, F, S, Ho, Wo, word_store, ys,
                           s);
    else
      pool_nchw_bf16<false>(xf, yf, N, C, H, W, F, S, Ho, Wo, word_store,
                            ys, s);
  }
  return static_cast<int>(cudaGetLastError());
#else
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
#endif
}
