// Storage dtypes of the serving path's kernels: the conv kernels K1
// (conv/csrc/conv_chwn.cu), K2 (conv/csrc/conv_nchw.cu) and the stacks K5a
// (conv/csrc/conv_stack_chwn.cu) and K5b (conv/csrc/conv_stack_nchw.cu)
// load float32, bf16 or int8 x and float32 or bf16 w, the softmax K4
// (softmax/csrc/softmax.cu) float32 or bf16.  Every one of them sums in float32 and
// rounds once, to nearest even, where it stores (put).
//
// A narrow source is compiled again for each storage variant
// (kernels/_build.py: VARIANTS) with one of the flags below, which set the
// x type (REPRO_XT), the w and output type (REPRO_WT) and the suffix of the
// entry points (REPRO_ENTRY); without a flag the source builds its float32
// entries.
//
// cp.async copies whole 4-, 8- or 16-byte words and has no widening form,
// so a narrow element reaches a float32 shared-memory ring through
// registers: copy4/copy2/copy1 move 4, 2 or 1 consecutive elements into as
// many floats, by one cp.async for float32 (the kernels' existing copies)
// and by one register load of 4 * sizeof(T), 2 * sizeof(T) or sizeof(T)
// bytes, widened, then one shared store, for bf16 and int8.  The alignment
// a float32 quad needs (its first element a multiple of 4 from a
// 16-byte-aligned base) is what a narrow quad needs too, so the kernels'
// 16-byte conditions stand as they are.  Where w is bf16, K1, K2 and K5a
// keep bf16 rings instead (16-byte cp.async of 8 elements; bf16_bits and
// bf16x8 for what arrives through registers) and multiply on the bf16
// tensor cores, as the bf16 builds of K5b and K6 do; so does K1 on int8
// x with float32 w, its w cut into three bf16 parts (split3); their notes
// say how.  The stacks' int8 builds copy x's bytes by cp.async and widen
// them in shared memory (conv_stack_nchw.cu, conv_stack_chwn.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

#if defined(REPRO_VARIANT_BF16)
#define REPRO_VARIANT 1
#define REPRO_XT __nv_bfloat16
#define REPRO_WT __nv_bfloat16
#define REPRO_ENTRY(name) name##_bf16
#elif defined(REPRO_VARIANT_I8F32)
#define REPRO_VARIANT 1
#define REPRO_XT int8_t
#define REPRO_WT float
#define REPRO_ENTRY(name) name##_i8f32
#elif defined(REPRO_VARIANT_I8BF16)
#define REPRO_VARIANT 1
#define REPRO_XT int8_t
#define REPRO_WT __nv_bfloat16
#define REPRO_ENTRY(name) name##_i8bf16
#else
#define REPRO_XT float
#define REPRO_WT float
#define REPRO_ENTRY(name) name
#endif

namespace repro {
namespace storage {

using bf16 = __nv_bfloat16;

// a bf16 or int8 value is exact in TF32 (8 significand bits; |q| <= 127):
// its 3xTF32 small part is zero, so the products that read it drop out
template <typename T>
constexpr bool kExactTf32 = !std::is_same<T, float>::value;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

// one element through the read-only cache, widened
template <typename T>
__device__ __forceinline__ float ld(const T* p) {
  return widen(__ldg(p));
}

// a float32 result stored in the output's type: bf16 rounds to nearest even
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the bf16 halves of a 32-bit word (element 0 in the low half) as floats
__device__ __forceinline__ float lo_bf16(unsigned r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned r) {
  return __uint_as_float(r & 0xffff0000u);
}
// byte i of a 32-bit word as a signed int8, as a float
__device__ __forceinline__ float i8_at(int r, int i) {
  return static_cast<float>(
      static_cast<int>(static_cast<unsigned>(r) << (24 - 8 * i)) >> 24);
}

// 4 consecutive narrow elements, widened, by one load of 4 * sizeof(T)
// bytes (src aligned to it)
__device__ __forceinline__ float4 ld4(const bf16* src) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(src));
  return make_float4(lo_bf16(r.x), hi_bf16(r.x), lo_bf16(r.y), hi_bf16(r.y));
}
__device__ __forceinline__ float4 ld4(const int8_t* src) {
  const int r = __ldg(reinterpret_cast<const int*>(src));
  return make_float4(i8_at(r, 0), i8_at(r, 1), i8_at(r, 2), i8_at(r, 3));
}

// one element's bits where ok, else the bits of 0
__device__ __forceinline__ unsigned raw1(const bf16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
}
__device__ __forceinline__ unsigned raw1(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned char*>(p)) : 0u;
}

// The bf16 bits of one element where ok, else 0: a bf16 as it is, an int8
// widened (exact, |q| <= 127), for the narrow builds' bf16 rings (K1, K2,
// K5a)
__device__ __forceinline__ unsigned bf16_bits(const bf16* p, bool ok) {
  return raw1(p, ok);
}
__device__ __forceinline__ unsigned bf16_bits(const int8_t* p, bool ok) {
  return ok ? __float_as_uint(static_cast<float>(__ldg(p))) >> 16 : 0u;
}
// 4 int8 (bytes of w, element 0 lowest) as 4 bf16, two to a word
__device__ __forceinline__ uint2 bf16x4(unsigned w) {
  auto two = [](unsigned v, int i) {
    return (__float_as_uint(i8_at(static_cast<int>(v), 2 * i)) >> 16) |
           (__float_as_uint(i8_at(static_cast<int>(v), 2 * i + 1)) &
            0xffff0000u);
  };
  return make_uint2(two(w, 0), two(w, 1));
}
// 8 int8 (bytes of r, element 0 lowest) as 8 bf16, two to a word
__device__ __forceinline__ uint4 bf16x8(uint2 r) {
  auto two = [](unsigned w, int i) {
    return (__float_as_uint(i8_at(static_cast<int>(w), 2 * i)) >> 16) |
           (__float_as_uint(i8_at(static_cast<int>(w), 2 * i + 1)) &
            0xffff0000u);
  };
  return make_uint4(two(r.x, 0), two(r.x, 1), two(r.y, 0), two(r.y, 1));
}

// two bf16 bits into one fragment register, lo in the low half (K2's and
// K5b's bf16 builds)
__device__ __forceinline__ unsigned pack2(unsigned short lo,
                                          unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// 8 bf16 from src into a 16-byte chunk of a bf16 ring (K2, K5a, K5b): by
// cp.async where run (all 8 there, src 16-byte aligned), zeros where n <=
// 0, else element by element (the first n of the 8)
__device__ __forceinline__ void chunk8(bf16* dst, const bf16* src, int n,
                                       bool run) {
  if (n <= 0) {
    mma::cp16(dst, src, false);
  } else if (run) {
    mma::cp16(dst, src, true);
  } else {
    unsigned v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = bf16_bits(src + j, j < n);
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                   v[4] | (v[5] << 16), v[6] | (v[7] << 16));
  }
}

// (x0, x1) as three bf16 pairs (element 0 in the low half) that sum to them
// exactly: hi, the rest md, the rest lo (8 significand bits each cover the
// float32's 24).  K5a's and K5b's bf16 conv2 multiply the float32 mid so.
__device__ __forceinline__ void split3(float x0, float x1, unsigned& hi,
                                       unsigned& md, unsigned& lo) {
  hi = mma::pack_bf16(x0, x1);
  const float r0 = x0 - lo_bf16(hi), r1 = x1 - hi_bf16(hi);
  md = mma::pack_bf16(r0, r1);
  lo = mma::pack_bf16(r0 - lo_bf16(md), r1 - hi_bf16(md));
}

// 4 consecutive elements into 4 floats (dst 16-byte aligned); ok == false
// writes zeros and reads nothing
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  mma::cp16(dst, src, ok);
}
template <typename T>
__device__ __forceinline__ void copy4(float* dst, const T* src, bool ok) {
  *reinterpret_cast<float4*>(dst) =
      ok ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// 2 consecutive elements into 2 floats (dst 8-byte aligned)
__device__ __forceinline__ void copy2(float* dst, const float* src,
                                      bool ok) {
  mma::cp8(dst, src, ok);
}
__device__ __forceinline__ void copy2(float* dst, const int8_t* src,
                                      bool ok) {
  float2 v = make_float2(0.f, 0.f);
  if (ok) {
    const int r = __ldg(reinterpret_cast<const short*>(src));
    v = make_float2(i8_at(r, 0), i8_at(r, 1));
  }
  *reinterpret_cast<float2*>(dst) = v;
}

// one element into one float
__device__ __forceinline__ void copy1(float* dst, const float* src,
                                      bool ok) {
  mma::cp4(dst, src, ok);
}
template <typename T>
__device__ __forceinline__ void copy1(float* dst, const T* src, bool ok) {
  *dst = ok ? ld(src) : 0.f;
}

// 3xTF32's split of an A or B operand value: a value of an exact type
// (kExactTf32) is its own TF32 big part and its small part is never read
template <bool EXACT>
__device__ __forceinline__ void split(float v, unsigned& big,
                                      unsigned& small) {
  if constexpr (EXACT) {
    big = __float_as_uint(v);
    small = 0u;
  } else {
    mma::split_tf32(v, big, small);
  }
}

}  // namespace storage
}  // namespace repro
