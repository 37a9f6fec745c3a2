// Element conversions of the kernels that take float32 or bf16: a result
// summed in fp32 is stored in the output's type (K10's split-K combine).
#pragma once

#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace repro
