// K4: row softmax of a float32 or bf16 [rows, cols] matrix in one kernel,
// and K8: row-wise softmax cross entropy of float32 or bf16 logits, a
// float32 loss[r] = lse(x[r]) - gold[r].
//
// K4 replaces repro/kernels/softmax/softmax.py::softmax_pallas, the
// paper's §V.B fusion of the five softmax steps (max, shift, exp, sum,
// normalize) that a naive GPU implementation runs as five kernels, each
// round-tripping the matrix through device memory.  K8 replaces
// softmax_xent_pallas (body _softmax_xent_kernel): the same row reduction,
// ending in lse - gold instead of a normalized row.
//
// What bounds them on an H100: bytes.  Each element is read once (and for
// K4 written once) against ~5 FLOPs, far below the fp32 ridge of ~20
// FLOP/byte.  At the classifier's shapes ([batch, 10 | 100 | 1000]) the
// matrix is a few hundred KB at most, so the launch and the latency of one
// load dominate: every load a lane makes is issued before any is used, with
// no branch between them (a branch would serialise their latencies).
// Design: the row, or each lane's share of it, is loaded once into
// registers (16-byte loads where cols % 4 == 0 and the bases are 16-byte
// aligned, else 4-byte ones), its max and its sum of exp(x - max) are
// reduced there, exp is computed once, and K4 writes y once.
//   narrow (cols <= 1024): a group of G = 4, 8, 16 or 32 lanes a row and
//     STEPS loads a lane, both from the row's length (its chunks rounded up
//     to a power of 2), several rows a block, the blocks sized so that a
//     small batch still spreads over the SMs; reductions are xor shuffles
//     inside the group, with no __syncthreads.
//   wide (cols <= 16384, Fig. 13's 10000): a block of 128-1024 threads a
//     row, 16 floats a thread at most; a warp's shuffles and one exchange
//     through shared memory for each of the max and the sum (2 barriers).
//   loop (wider rows): a block of 1024 threads a row takes an online max
//     and a rescaled running sum over the row, four loads a fold; K8 ends
//     there (x read once), K4 reads x again to write y (mostly from L2).
// NaN and -inf follow the reference: the max propagates NaN (nan_max), so
// a row that holds a NaN comes out NaN; an all -inf row has max -inf and
// exp(-inf - -inf) = NaN, so it comes out NaN too, and so does K8's loss
// of such a row whatever its label (xent_loss).
//
// bf16 (the variant build, csrc/storage.cuh): the same templates load
// bf16 (4 elements, 8 bytes, where a float32 load takes 16) and compute in
// float32; K4 rounds y once, to nearest even, where it stores it, and K8
// widens the gold logit too and writes a float32 loss, as the reference's
// kernel (x.astype(f32)) does.
//
// K8's gold logit is x[row, label] for a label in [0, cols) and 0
// otherwise: the reference kernel takes it through a one-hot, so a label
// outside the row hits no column and the loss is the bare logsumexp.  The
// row's first lane (or the block's first thread) writes the loss.  Labels
// are int64.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/nan_max.cuh"
#include "../../csrc/storage.cuh"

namespace {

using repro::storage::bf16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowThreads = 128;  // the most threads a narrow block has
constexpr int kNarrowFloats = 32;    // the most row floats a narrow lane holds
constexpr int kWideFloats = 16;      // the most row floats a wide thread holds
constexpr int kLoopThreads = 1024;
constexpr int kLoopLoads = 4;        // loads a loop thread folds at once

// Reductions over G consecutive lanes (G a power of 2, at most 32): the
// xor partners stay inside the group, and every lane ends with the result.
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// (m, s) <- the online pair of the union of (m, s) and (om, os): s is a sum
// of exp(v - m).  A side whose max is the new one keeps its sum unscaled,
// so two -inf maxima never form exp(-inf - -inf); a NaN max stays NaN.
__device__ __forceinline__ void merge(float& m, float& s, float om,
                                      float os) {
  const float nm = nan_max(m, om);
  s = (m == nm ? s : s * expf(m - nm)) + (om == nm ? os : os * expf(om - nm));
  m = nm;
}

template <int G>
__device__ __forceinline__ void group_merge(float& m, float& s) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(kFull, m, off);
    const float os = __shfl_xor_sync(kFull, s, off);
    merge(m, s, om, os);
  }
}

// Fold n values into the online pair: one rescale for the batch, one exp a
// value; a -inf value adds nothing (even where the running max is -inf).
template <int N>
__device__ __forceinline__ void fold(float& m, float& s, const float* v) {
  float bm = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) bm = nan_max(bm, v[k]);
  const float nm = nan_max(m, bm);
  if (m != nm) s *= expf(m - nm);
#pragma unroll
  for (int k = 0; k < N; ++k) s += v[k] == -INFINITY ? 0.f : expf(v[k] - nm);
  m = nm;
}

// W elements from p + c into the floats v (W = 4: one 16-byte float32 or
// 8-byte bf16 load); -inf where the lane is off the row or past its end.
template <int W, typename T>
__device__ __forceinline__ void load(const T* p, int c, int cols, bool live,
                                     float* v) {
  if constexpr (W == 4 && std::is_same<T, float>::value) {
    float4 t = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    if (live && c < cols) t = *reinterpret_cast<const float4*>(p + c);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (W == 4) {
    v[0] = v[1] = v[2] = v[3] = -INFINITY;
    if (live && c < cols) {
      const uint2 t = *reinterpret_cast<const uint2*>(p + c);
      v[0] = repro::storage::lo_bf16(t.x);
      v[1] = repro::storage::hi_bf16(t.x);
      v[2] = repro::storage::lo_bf16(t.y);
      v[3] = repro::storage::hi_bf16(t.y);
    }
  } else {
    v[0] = live && c < cols ? repro::storage::widen(p[c]) : -INFINITY;
  }
}

// W floats into p + c, rounded once to T
template <int W, typename T>
__device__ __forceinline__ void store(T* p, int c, const float* v) {
  if constexpr (W == 4 && std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p + c) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  } else {
    repro::storage::put(p + c, v[0]);
  }
}

// K8's loss from the row's (max, sum of exp(x - max)).  An all -inf row
// (m = -inf) is NaN whatever its label, as in the reference's kernel, where
// x - max is NaN: fold() leaves such a row's sum 0, so it is set here.
template <typename T>
__device__ __forceinline__ float xent_loss(const T* xr, long long label,
                                           int cols, float m, float s) {
  if (m == -INFINITY) return NAN;
  const float gold =
      label >= 0 && label < cols ? repro::storage::widen(xr[label]) : 0.f;
  return (logf(s) + m) - gold;
}

// narrow: G lanes a row, STEPS loads a lane, blockDim.x / G rows a block.
// K4 writes y [rows, cols]; K8 (XENT) writes y [rows], the loss.
template <typename T, typename TY, int G, int STEPS, bool VEC, bool XENT>
__global__ void __launch_bounds__(kNarrowThreads)
narrow_kernel(const T* __restrict__ x, TY* __restrict__ y,
              const long long* __restrict__ labels, int rows, int cols) {
  constexpr int W = VEC ? 4 : 1, N = STEPS * W;
  const int lane = threadIdx.x % G;
  const int row = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool live = row < rows;   // dead lanes still shuffle
  const long long base = (long long)(live ? row : 0) * cols;
  float v[N];
#pragma unroll
  for (int i = 0; i < STEPS; ++i)
    load<W>(x + base, (i * G + lane) * W, cols, live, v + i * W);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) m = nan_max(m, v[i]);
  m = group_max<G>(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // a padded slot is exp(-inf - m) = 0 unless the max is -inf, and then
    // the row is NaN whatever it adds
    v[i] = expf(v[i] - m);
    s += v[i];
  }
  s = group_sum<G>(s);
  if (!live) return;
  if constexpr (XENT) {
    if (lane == 0) y[row] = xent_loss(x + base, labels[row], cols, m, s);
  } else {
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int c = (i * G + lane) * W;
      if (c < cols) {
#pragma unroll
        for (int k = 0; k < W; ++k) v[i * W + k] = v[i * W + k] / s;
        store<W>(y + base, c, v + i * W);
      }
    }
  }
}

// wide: a block of T threads a row.
template <typename E, typename TY, int T, bool VEC, bool XENT>
__global__ void __launch_bounds__(T)
wide_kernel(const E* __restrict__ x, TY* __restrict__ y,
            const long long* __restrict__ labels, int cols) {
  constexpr int W = VEC ? 4 : 1, STEPS = kWideFloats / W;
  __shared__ float red_max[T / 32], red_sum[T / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long base = (long long)blockIdx.x * cols;
  float v[kWideFloats];
#pragma unroll
  for (int i = 0; i < STEPS; ++i)
    load<W>(x + base, (i * T + threadIdx.x) * W, cols, true, v + i * W);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kWideFloats; ++i) m = nan_max(m, v[i]);
  m = group_max<32>(m);
  if (lane == 0) red_max[warp] = m;
  __syncthreads();
  m = group_max<32>(lane < T / 32 ? red_max[lane] : -INFINITY);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    if (i * T * W < cols) {  // uniform: skip the steps no thread has
#pragma unroll
      for (int k = 0; k < W; ++k) {
        v[i * W + k] = expf(v[i * W + k] - m);
        s += v[i * W + k];
      }
    }
  }
  s = group_sum<32>(s);
  if (lane == 0) red_sum[warp] = s;
  __syncthreads();
  s = group_sum<32>(lane < T / 32 ? red_sum[lane] : 0.f);
  if constexpr (XENT) {
    if (threadIdx.x == 0)
      y[blockIdx.x] = xent_loss(x + base, labels[blockIdx.x], cols, m, s);
  } else {
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int c = (i * T + threadIdx.x) * W;
      if (c < cols) {
#pragma unroll
        for (int k = 0; k < W; ++k) v[i * W + k] = v[i * W + k] / s;
        store<W>(y + base, c, v + i * W);
      }
    }
  }
}

// loop: rows wider than a wide block holds.
template <typename T, typename TY, bool VEC, bool XENT>
__global__ void __launch_bounds__(kLoopThreads)
loop_kernel(const T* __restrict__ x, TY* __restrict__ y,
            const long long* __restrict__ labels, int cols) {
  constexpr int W = VEC ? 4 : 1, STRIDE = kLoopThreads * W;
  __shared__ float red_m[kLoopThreads / 32], red_s[kLoopThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long base = (long long)blockIdx.x * cols;
  const T* xr = x + base;
  float m = -INFINITY, s = 0.f;
  for (int c0 = threadIdx.x * W; c0 < cols; c0 += kLoopLoads * STRIDE) {
    float v[kLoopLoads * W];
#pragma unroll
    for (int b = 0; b < kLoopLoads; ++b)
      load<W>(xr, c0 + b * STRIDE, cols, true, v + b * W);
    fold<kLoopLoads * W>(m, s, v);
  }
  group_merge<32>(m, s);
  if (lane == 0) { red_m[warp] = m; red_s[warp] = s; }
  __syncthreads();
  m = red_m[lane];
  s = red_s[lane];
  group_merge<32>(m, s);
  if constexpr (XENT) {
    if (threadIdx.x == 0)
      y[blockIdx.x] = xent_loss(xr, labels[blockIdx.x], cols, m, s);
  } else {
    // exp(x - m) / s: an all -inf row has m = -inf and comes out NaN, and
    // a row with +inf has s = NaN (fold's exp(inf - inf)), as the reference
    for (int c = threadIdx.x * W; c < cols; c += STRIDE) {
      float v[W];
      load<W>(xr, c, cols, true, v);
#pragma unroll
      for (int k = 0; k < W; ++k) v[k] = expf(v[k] - m) / s;
      store<W>(y + base, c, v);
    }
  }
}

// The current card's SM count, read once a card (device indices past
// kMaxCards are read on every call).
constexpr int kMaxCards = 64;
int sm_count() {
  static int counts[kMaxCards];
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxCards && counts[dev] > 0) return counts[dev];
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n < 1) n = 1;
  if (dev < kMaxCards) counts[dev] = n;
  return n;
}

// Rows a narrow block: enough blocks to reach every SM where the batch
// allows it, at least one warp and at most kNarrowThreads threads.
int rows_per_block(int rows, int g) {
  int rpb = rows / sm_count();
  if (rpb < 32 / g) rpb = 32 / g;
  if (rpb > kNarrowThreads / g) rpb = kNarrowThreads / g;
  return rpb;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int G, int STEPS, bool VEC, bool XENT, typename T, typename TY>
void launch_narrow(const T* x, TY* y, const long long* labels, int rows,
                   int cols, cudaStream_t st) {
  const int rpb = rows_per_block(rows, G);
  narrow_kernel<T, TY, G, STEPS, VEC, XENT>
      <<<(rows - 1) / rpb + 1, rpb * G, 0, st>>>(x, y, labels, rows, cols);
}

// The variant for (rows, cols): narrow with the least G, then the least
// STEPS, whose G * STEPS loads cover the row's chunks rounded up to a
// power of 2; wide with the least block that holds the row; loop past it.
template <bool VEC, bool XENT, typename T, typename TY>
void launch(const T* x, TY* y, const long long* labels, int rows, int cols,
            cudaStream_t st) {
  constexpr int W = VEC ? 4 : 1;
  if (cols <= 32 * kNarrowFloats) {
    const int chunks = (cols + W - 1) / W;
    int p = 1;
    while (p < chunks) p *= 2;
    if (p <= 4)
      launch_narrow<4, 1, VEC, XENT>(x, y, labels, rows, cols, st);
    else if (p <= 8)
      launch_narrow<8, 1, VEC, XENT>(x, y, labels, rows, cols, st);
    else if (p <= 16)
      launch_narrow<16, 1, VEC, XENT>(x, y, labels, rows, cols, st);
    else if (p <= 32)
      launch_narrow<32, 1, VEC, XENT>(x, y, labels, rows, cols, st);
    else if (p <= 64)
      launch_narrow<32, 2, VEC, XENT>(x, y, labels, rows, cols, st);
    else if (p <= 128)
      launch_narrow<32, 4, VEC, XENT>(x, y, labels, rows, cols, st);
    else if (p <= 256)
      launch_narrow<32, 8, VEC, XENT>(x, y, labels, rows, cols, st);
    else if constexpr (!VEC) {  // 16-byte chunks stop at 256
      if (p <= 512)
        launch_narrow<32, 16, VEC, XENT>(x, y, labels, rows, cols, st);
      else
        launch_narrow<32, 32, VEC, XENT>(x, y, labels, rows, cols, st);
    }
  } else if (cols <= 128 * kWideFloats) {
    wide_kernel<T, TY, 128, VEC, XENT><<<rows, 128, 0, st>>>(x, y, labels,
                                                              cols);
  } else if (cols <= 256 * kWideFloats) {
    wide_kernel<T, TY, 256, VEC, XENT><<<rows, 256, 0, st>>>(x, y, labels,
                                                              cols);
  } else if (cols <= 512 * kWideFloats) {
    wide_kernel<T, TY, 512, VEC, XENT><<<rows, 512, 0, st>>>(x, y, labels,
                                                              cols);
  } else if (cols <= 1024 * kWideFloats) {
    wide_kernel<T, TY, 1024, VEC, XENT><<<rows, 1024, 0, st>>>(x, y, labels,
                                                                cols);
  } else {
    loop_kernel<T, TY, VEC, XENT><<<rows, kLoopThreads, 0, st>>>(x, y, labels,
                                                                 cols);
  }
}

}  // namespace

// K4: x, y [rows, cols] REPRO_WT (storage.cuh: softmax_forward float32,
// softmax_forward_bf16 bf16; bases aligned to the element; 4-element
// access where cols % 4 == 0 and both bases are 16-byte aligned).  The
// variant is picked here from (rows, cols).
extern "C" int REPRO_ENTRY(softmax_forward)(const void* x, void* y, int rows,
                                            int cols, void* stream) {
  if (rows > 0 && cols > 0) {
    const REPRO_WT* xf = static_cast<const REPRO_WT*>(x);
    REPRO_WT* yf = static_cast<REPRO_WT*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cols % 4 == 0 && aligned16(x) && aligned16(y))
      launch<true, false>(xf, yf, nullptr, rows, cols, st);
    else
      launch<false, false>(xf, yf, nullptr, rows, cols, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8: x [rows, cols] REPRO_WT (softmax_xent_forward float32,
// softmax_xent_forward_bf16 bf16), labels [rows] int64 (any value) -> loss
// [rows] float32.
extern "C" int REPRO_ENTRY(softmax_xent_forward)(const void* x,
                                                 const void* labels,
                                                 void* loss, int rows,
                                                 int cols, void* stream) {
  if (rows > 0 && cols > 0) {
    const REPRO_WT* xf = static_cast<const REPRO_WT*>(x);
    const long long* lab = static_cast<const long long*>(labels);
    float* lf = static_cast<float*>(loss);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cols % 4 == 0 && aligned16(x))
      launch<true, true>(xf, lf, lab, rows, cols, st);
    else
      launch<false, true>(xf, lf, lab, rows, cols, st);
  }
  return static_cast<int>(cudaGetLastError());
}
