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
#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace

extern "C" int softmax_forward(const void* x, void* y, int rows, int cols,
                               void* stream) {
  if (rows > 0 && cols > 0)
    softmax_rows_kernel<<<rows, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(y), cols);
  return static_cast<int>(cudaGetLastError());
}
