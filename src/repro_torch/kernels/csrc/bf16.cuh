// Element conversions of the kernels that take float32 or bf16 (K10, K11,
// K12): every element becomes fp32 on load, and a result is stored in the
// output's type.
#pragma once

#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace repro
