// K4: row softmax of a float32 [rows, cols] matrix in one kernel.
//
// Replaces repro/kernels/softmax/softmax.py::softmax_pallas, the paper's
// §V.B fusion of the five softmax steps (max, shift, exp, sum, normalize)
// that a naive GPU implementation runs as five kernels, each round-tripping
// the matrix through device memory.
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once against ~10 FLOPs, far below the fp32 ridge of ~20 FLOP/byte.  At
// the classifier's shapes ([batch, 1000]) the matrix is a few hundred KB,
// so the launch itself dominates.  Design: one block per row; the block's
// threads stride the row (coalesced), reduce the max and then the sum with
// warp shuffles plus one shared-memory pass across warps, and recompute
// exp(x - max) in the normalize pass instead of storing it, so device
// memory sees one read of x (the second read hits L1/L2) and one write.
// The TPU kernel's row-block sizing against a VMEM budget has no
// counterpart here.
//
// K8: row-wise softmax cross entropy, loss[r] = lse(x[r]) - x[r, label[r]].
//
// Replaces repro/kernels/softmax/softmax.py::softmax_xent_pallas (body
// _softmax_xent_kernel).  What bounds it on an H100: bytes (one read of the
// row, ~3 FLOPs an element), and at a classifier's [batch, 1000] the launch.
// Design: one warp per row, eight rows a block; the lanes stride the row
// (coalesced), reduce the max with warp shuffles, then the sum of
// exp(x - max), all in fp32, and lane 0 reads the gold logit by label and
// writes lse - gold.  The max propagates NaN (nan_max) as jnp.max does, so
// a row that holds a NaN gets a NaN loss, as in the reference.  Labels are
// int64 (PyTorch's own); the wrapper checks their range.
#include <cuda_runtime.h>
#include <math.h>

#include "../../csrc/nan_max.cuh"

namespace {

constexpr int kThreads = 256;

template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = IS_MAX ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? scratch[lane] : (IS_MAX ? -INFINITY : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = IS_MAX ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  v = scratch[0];
  __syncthreads();  // scratch is reused by the next reduction
  return v;
}

__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                    int cols) {
  __shared__ float scratch[kThreads / 32];
  const float* xr = x + (long long)blockIdx.x * cols;
  float* yr = y + (long long)blockIdx.x * cols;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < cols; c += kThreads) m = fmaxf(m, xr[c]);
  m = block_reduce<true>(m, scratch);
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) s += expf(xr[c] - m);
  s = block_reduce<false>(s, scratch);
  for (int c = threadIdx.x; c < cols; c += kThreads)
    yr[c] = expf(xr[c] - m) / s;
}

constexpr int kXentWarps = 8;

__global__ void __launch_bounds__(32 * kXentWarps)
softmax_xent_kernel(const float* __restrict__ x,
                    const long long* __restrict__ labels,
                    float* __restrict__ loss, int rows, int cols) {
  const int row = blockIdx.x * kXentWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + (long long)row * cols;
  float m = -INFINITY;
  for (int c = lane; c < cols; c += 32) m = nan_max(m, xr[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += expf(xr[c] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) loss[row] = (logf(s) + m) - xr[labels[row]];
}

}  // namespace

// K8: x [rows, cols] f32, labels [rows] int64 in [0, cols) -> loss [rows].
extern "C" int softmax_xent_forward(const void* x, const void* labels,
                                    void* loss, int rows, int cols,
                                    void* stream) {
  if (rows > 0 && cols > 0)
    softmax_xent_kernel<<<(rows + kXentWarps - 1) / kXentWarps,
                          32 * kXentWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const long long*>(labels),
        static_cast<float*>(loss), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int softmax_forward(const void* x, void* y, int rows, int cols,
                               void* stream) {
  if (rows > 0 && cols > 0)
    softmax_rows_kernel<<<rows, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(y), cols);
  return static_cast<int>(cudaGetLastError());
}
