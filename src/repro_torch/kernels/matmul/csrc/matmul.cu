// K10: the tiled matmul out[M, N] = x[M, K] @ y[K, N], fp32 accumulation,
// out in x's dtype (float32 or bf16).
//
// Replaces repro/kernels/matmul/matmul.py::matmul_pallas (body
// _matmul_kernel): a (M/bm, N/bn, K/bk) grid that the TPU walks in order,
// carrying the sum in an f32 VMEM scratch from one K step to the next and
// flushing it on the last, on operands its wrapper pads to 128-multiples.
// Here a block owns one 128 x 128 output tile and runs the whole K loop
// itself (gemm_tile.cuh), so nothing carries over between blocks and no
// padded copy is made: ragged edges are masked on load and on store.
//
// What bounds it on an H100: operations for the matrix-expansion conv's
// layers with a large K (2*M*N*K FMA operations, K up to 4608 in Table 1),
// bytes for the thin ones (K = 27: the patch matrix is read once for 54
// operations an element).  Design: the 8 x 8 register tile of K1/K2
// (conv_common.cuh) over shared-memory slices; x and y come with two
// strides each, so the baseline's transposed weight view needs no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/gemm_tile.cuh"

namespace {

using namespace repro::gemm;

template <typename T>
struct MatmulArgs {
  Operand<T> x;   // rows m
  Operand<T> y;   // columns n
  T* out;         // [M, N], contiguous
  int M, N, K;
};

template <typename T, bool X_KFAST, bool Y_KFAST>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const MatmulArgs<T> a) {
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
  tile<T, X_KFAST, Y_KFAST>(a.x, a.y, a.K, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + row_of(ty, i);
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + col_of(tx, j);
      if (n < a.N)
        repro::store_f32(a.out + (long long)m * a.N + n, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           long long sxm, long long sxk, long long syk, long long syn,
           cudaStream_t st) {
  MatmulArgs<T> a;
  a.x = Operand<T>{static_cast<const T*>(x), sxm, sxk, M};
  a.y = Operand<T>{static_cast<const T*>(y), syn, syk, N};
  a.out = static_cast<T*>(out);
  a.M = M; a.N = N; a.K = K;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // load along whichever dim of each operand is contiguous
  const bool xk = sxk == 1, yk = syk == 1 && syn != 1;
  if (xk && yk)
    matmul_kernel<T, true, true><<<grid, kThreads, 0, st>>>(a);
  else if (xk)
    matmul_kernel<T, true, false><<<grid, kThreads, 0, st>>>(a);
  else if (yk)
    matmul_kernel<T, false, true><<<grid, kThreads, 0, st>>>(a);
  else
    matmul_kernel<T, false, false><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] at x[m * sxm + k * sxk]; y [K, N] at y[k * syk + n * syn]; out
// [M, N] contiguous, of x's dtype.  bf16 != 0: all three are bf16, else
// float32.  Returns cudaGetLastError().
extern "C" int matmul_forward(const void* x, const void* y, void* out, int M,
                              int N, int K, long long sxm, long long sxk,
                              long long syk, long long syn, int bf16,
                              void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, y, out, M, N, K, sxm, sxk, syk, syn, st);
  return launch<float>(x, y, out, M, N, K, sxm, sxk, syk, syn, st);
}
