// One 128 x 128 output tile of C = A @ B in fp32 on the CUDA cores, shared
// by the tiled matmul K10 (matmul/csrc/matmul.cu) and the fused unembed +
// cross entropy K12 (crossentropy/csrc/crossentropy.cu).
//
// A is [M, K] and B is [K, N], each addressed through two element strides,
// so a transposed view (the matrix-expansion conv's ``w.reshape(Co, -1).T``,
// K12's ``table`` read as tableᵀ) needs no copy.  Elements are float or
// bf16 and become fp32 on load; the sum is fp32 throughout, so an fp32
// product matches an exact-f32 reference (tensor cores would round fp32
// inputs through TF32).  A block of 256 threads stages BK = 8 deep slices
// of A and B through shared memory; each thread keeps an 8 x 8 register
// tile and reads its operands as float4 (four shared-memory loads feed 64
// FMAs), and fetches the next slice into registers while the current one is
// multiplied.  Ragged M, N and K are zero-filled on load, so K = 27 (a 3x3
// conv over RGB) runs three slices and a masked fourth, with no padding
// copy.  Which dim of an operand is contiguous picks the load order (the
// KFAST template flags), so a warp's loads run along it either way.
//
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows row_of(ty, i) and
// columns col_of(tx, j), i, j < 8, of the tile.
#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace repro {
namespace gemm {

constexpr int kThreads = 256;
constexpr int BM = 128;   // tile rows
constexpr int BN = 128;   // tile columns
constexpr int BK = 8;     // reduction slice
constexpr int kPerThread = BM * BK / kThreads;  // = BN * BK / kThreads = 4

__device__ __forceinline__ int row_of(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int col_of(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// An operand: element (o, k) at p[o * s_o + k * s_k], o < n_o, k < K.
// For A, o is the row m; for B, o is the column n.
template <typename T>
struct Operand {
  const T* p;
  long long s_o, s_k;
  int n_o;
};

// Element e of a 128 x 8 slice: (o, kk), with the contiguous dim fastest.
template <bool KFAST>
__device__ __forceinline__ void slot(int e, int& o, int& kk) {
  o = KFAST ? e / BK : e % BM;
  kk = KFAST ? e % BK : e / BM;
}

template <typename T, bool KFAST>
__device__ __forceinline__ void load_slice(const Operand<T>& op, int o0,
                                           int k0, int K,
                                           float (&r)[kPerThread]) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    int o, kk;
    slot<KFAST>(threadIdx.x + i * kThreads, o, kk);
    const int oo = o0 + o, k = k0 + kk;
    r[i] = (oo < op.n_o && k < K)
               ? to_f32(op.p[(long long)oo * op.s_o + (long long)k * op.s_k])
               : 0.f;
  }
}

template <bool KFAST>
__device__ __forceinline__ void store_slice(float (*sm)[BM + 4],
                                            const float (&r)[kPerThread]) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    int o, kk;
    slot<KFAST>(threadIdx.x + i * kThreads, o, kk);
    sm[kk][o] = r[i];
  }
}

// acc[i][j] = sum_k A[m0 + row_of(ty, i), k] * B[k, n0 + col_of(tx, j)]
// (0 outside the matrices).  Every thread of the block must call it.
template <typename T, bool A_KFAST, bool B_KFAST>
__device__ __forceinline__ void tile(const Operand<T>& A,
                                     const Operand<T>& B, int K, int m0,
                                     int n0, float (&acc)[8][8]) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ra[kPerThread], rb[kPerThread];
  load_slice<T, A_KFAST>(A, m0, 0, K, ra);
  load_slice<T, B_KFAST>(B, n0, 0, K, rb);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_slice<A_KFAST>(As, ra);
    store_slice<B_KFAST>(Bs, rb);
    __syncthreads();
    if (k0 + BK < K) {  // the next slice is in flight during the FMAs
      load_slice<T, A_KFAST>(A, m0, k0 + BK, K, ra);
      load_slice<T, B_KFAST>(B, n0, k0 + BK, K, rb);
    }
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[q][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[q][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[q][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[q][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace gemm
}  // namespace repro
