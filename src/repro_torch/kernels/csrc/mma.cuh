// The tensor-core and async-copy helpers of the port's Hopper kernels:
// the weight gradient K6 (conv/csrc/wgrad.cu), flash attention K11
// (flash_attention/csrc/flash_attention.cu), the direct CHWN conv K1
// (conv/csrc/conv_chwn.cu), the bf16 build of the CHWN stack K5a
// (conv/csrc/conv_stack_chwn.cu), the NCHW conv K2 (conv/csrc/conv_nchw.cu),
// the NCHW conv -> conv stack K5b
// (conv/csrc/conv_stack_nchw.cu), the tiled matmul K10
// (matmul/csrc/matmul.cu) and the fused unembed + cross entropy K12
// (crossentropy/csrc/crossentropy.cu).  The bf16 products run in K1's
// narrow builds, K5a's, K5b's and K6's bf16 builds, K10, K11 and K12.
//
// - cp.async copies global -> shared (16, 8 or 4 bytes, with zero fill),
//   committed and waited on in groups;
// - fp32 accuracy from the TF32 tensor cores (3xTF32): split_tf32 cuts a
//   float into big + small, and mma_tf32 is one m16n8k8 TF32 product;
// - bf16 on the tensor cores: ldmatrix (plain and transposed) and the
//   m16n8k16 bf16 product, with the XOR swizzle that keeps ldmatrix free
//   of bank conflicts;
// - named barriers for warp-specialised blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace mma {

// ---- cp.async -------------------------------------------------------------

// 16 bytes global -> shared; ok == false writes 16 zero bytes (src unread)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
// 8 bytes global -> shared; ok == false writes 8 zero bytes
__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}
// 4 bytes global -> shared; ok == false writes 4 zero bytes
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- 3xTF32 ---------------------------------------------------------------

// v = big + small: big is v rounded to TF32 (10 mantissa bits) to nearest
// with ties away from zero (half an ulp added to the magnitude, the low 13
// bits cleared: what cvt.rna.tf32.f32 computes, in two integer ops, since
// the cvt also tests for NaN), small the exact rest, which mma reads
// truncated to TF32.  small * small is below fp32's rounding, so
// a_small*b_big + a_big*b_small + a_big*b_big is a product in fp32
// accuracy: three TF32 products per fp32 one.
__device__ __forceinline__ void split_tf32(float v, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// d = a . b + c on one m16n8k8 TF32 tile, fp32 accumulation.  Fragments
// (g = lane / 4, t = lane % 4): a0 A[g][t], a1 A[g+8][t], a2 A[g][t+4],
// a3 A[g+8][t+4]; b0 B[t][g], b1 B[t+4][g]; d0 D[g][2t], d1 D[g][2t+1],
// d2 D[g+8][2t], d3 D[g+8][2t+1].  The tensor core truncates as it
// accumulates: callers flush a chain into fp32 registers every 32 terms.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// ---- bf16 -----------------------------------------------------------------

// element offset of 16-byte chunk c of row r in a [rows][DT] bf16 tile
// whose chunk index is XORed with r mod 8: ldmatrix's 8 row addresses of
// one 8 x 8 matrix then fall in 8 different bank groups (rows of 64
// elements: the 128-byte swizzle of wgmma's shared-memory descriptors)
template <int DT>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DT + ((c ^ (r & 7)) << 3);
}
// the same for rows of 32 bf16 (64 bytes, 4 chunks), two rows to a
// 128-byte line: chunk c of row r XORed with (r / 2) mod 4, so the 8 rows of
// an 8 x 8 matrix again fall in 8 bank groups (wgmma's 64-byte swizzle)
__device__ __forceinline__ int swz32(int r, int c) {
  return r * 32 + ((c ^ ((r >> 1) & 3)) << 3);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a * b, the first product of a chain (no C operand to zero first)
__device__ __forceinline__ void mma_bf16_z(float (&d)[4],
                                           const unsigned (&a)[4],
                                           unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---- named barriers -------------------------------------------------------

// barrier `id` over `n` threads: arrive without waiting, or wait
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

}  // namespace mma
}  // namespace repro
