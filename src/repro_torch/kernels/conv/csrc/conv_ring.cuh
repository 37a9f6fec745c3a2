// The ring-of-stages pieces the warp-specialised NCHW convs share: K2
// (conv_nchw.cu) and the conv -> conv stack K5b (conv_stack_nchw.cu).
// One producer warpgroup fills a ring of NS stages by cp.async and two
// consumer warpgroups multiply, passing each stage on named barriers.
#pragma once

#include <cuda_runtime.h>

#include "../../csrc/mma.cuh"
#include "../../csrc/storage.cuh"

namespace repro {
namespace ring {

// named barriers (0 is __syncthreads): FULL and EMPTY of each ring stage,
// one of the consumers alone and one of the producers alone
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
template <int NS>
__device__ __forceinline__ int empty_bar(int s) { return 1 + NS + s; }
template <int NS>
__device__ __forceinline__ int cons_bar() { return 1 + 2 * NS; }
template <int NS>
__device__ __forceinline__ int prod_bar() { return 2 + 2 * NS; }

// 4 elements from src into 4 floats at dst (cp.async for float32; a
// widening register load for a narrow storage type, storage.cuh), zero past
// the first `valid` (4 at once where vec and all 4 are valid); `any` is a
// readable address for the zero-filled copies
template <typename T>
__device__ __forceinline__ void copy_quad(float* dst, const T* src,
                                          const T* any, int valid, bool vec) {
  if (vec && valid >= 4) {
    storage::copy4(dst, src, true);
  } else if (valid <= 0) {
    storage::copy4(dst, any, false);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      storage::copy1(dst + j, j < valid ? src + j : any, j < valid);
  }
}

// the smallest v >= n with v % 32 == 8: the channels of a box in shared
// memory 8 banks apart, so a tile of 8 columns along a row reads 32 banks
inline int rows8(int n) { return n + ((8 - n % 32) + 32) % 32; }

}  // namespace ring
}  // namespace repro
