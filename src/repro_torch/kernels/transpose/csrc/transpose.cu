// K9a/K9b: tiled transpose [B, M, N] -> [B, N, M] of 32-bit words.
//
// Replaces repro/kernels/transpose/transpose.py::transpose2d_pallas (K9a,
// B = 1) and ::transpose2d_batched_pallas (K9b): the paper's §IV.C fast
// layout transform.  Every CHWN <-> NCHW re-layout collapses to one 2-D
// transpose ([C*H*W, N] <-> [N, C*H*W]); a 3-axis permutation such as
// NCHW -> NHWC to a batched one.
//
// What bounds it on an H100: bytes.  It reads each element once and writes
// it once and computes nothing.  Design, the paper's: a block stages a
// 32 x 32 tile in shared memory, padded to 33 columns so that the
// transposed read of a column touches 32 different banks; a warp reads one
// tile row (128 contiguous bytes of x) and writes one tile row of y (128
// contiguous bytes), so both sides are coalesced.  The ragged edges of M
// and N are bound-checked in the kernel (the TPU version padded the array
// to its block multiple instead).  All tiles of all batches are numbered
// along gridDim.x, which reaches 2^31 - 1: a [C*H*W, N] matrix of VGG16's
// conv1_1 output has 100352 row tiles, beyond gridDim.y's 65535.  It copies
// bits, so any 4-byte dtype is the same kernel.
//
// Two-byte elements (bf16): the bf16 build (-DREPRO_VARIANT_BF16,
// csrc/storage.cuh) defines transpose_forward_bf16, the same kernel over
// 16-bit words.  Its tile rows are padded to 34 halfwords (68 bytes, 17
// banks): lane t of a transposed read takes the halfword at byte 68 t +
// 2 i, in bank 17 t + i/2 mod 32, a different bank for each of the 32
// lanes since 17 is odd (33 halfwords would put lanes 0 and 31 in one
// bank at odd i).  A warp's row of the tile is then 64 bytes of x and of
// y, half a 128-byte line, still one contiguous run each.
#include <cuda_runtime.h>

#include <type_traits>

#include "../../csrc/storage.cuh"  // REPRO_WT, REPRO_ENTRY

namespace {

// the element's bits: 4 bytes in the float32 build, 2 in the bf16 one
using Word = std::conditional<sizeof(REPRO_WT) == 2, unsigned short,
                              unsigned>::type;
// tile row padding in elements: 33 floats, 34 halfwords (above)
constexpr int kPad = sizeof(Word) == 2 ? 2 : 1;

constexpr int kTile = 32;
constexpr int kRows = 8;  // block is kTile x kRows threads

__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const Word* __restrict__ x, Word* __restrict__ y, int M,
                 int N, int tiles_m, int tiles_n) {
  __shared__ Word tile[kTile][kTile + kPad];
  long long t = blockIdx.x;
  const int tn = (int)(t % tiles_n);
  t /= tiles_n;
  const int tm = (int)(t % tiles_m);
  const long long b = t / tiles_m;
  const long long off = b * M * N;
  const int m0 = tm * kTile, n0 = tn * kTile;

  const int n = n0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int m = m0 + i;
    if (m < M && n < N) tile[i][threadIdx.x] = x[off + (long long)m * N + n];
  }
  __syncthreads();
  const int m = m0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int nn = n0 + i;
    if (nn < N && m < M) y[off + (long long)nn * M + m] = tile[threadIdx.x][i];
  }
}

}  // namespace

// x [B, M, N] -> y [B, N, M], elements of sizeof(REPRO_WT) bytes (4 in the
// float32 build, 2 in the bf16 one).  Returns cudaGetLastError().
extern "C" int REPRO_ENTRY(transpose_forward)(const void* x, void* y, int B,
                                              int M, int N, void* stream) {
  if (B > 0 && M > 0 && N > 0) {
    const int tiles_m = (M + kTile - 1) / kTile;
    const int tiles_n = (N + kTile - 1) / kTile;
    const long long blocks = (long long)B * tiles_m * tiles_n;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    transpose_kernel<<<(unsigned)blocks, dim3(kTile, kRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Word*>(x), static_cast<Word*>(y), M, N,
        tiles_m, tiles_n);
  }
  return static_cast<int>(cudaGetLastError());
}
