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
// csrc/storage.cuh) defines transpose_forward_bf16, a kernel of its own
// (transpose_bf16_kernel, below); the float32 build keeps the kernel above.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/storage.cuh"  // REPRO_ENTRY

#if !defined(REPRO_VARIANT_BF16)
namespace {

using Word = unsigned;   // the element's bits
constexpr int kPad = 1;  // tile row padding in elements: 33 floats

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

// x [B, M, N] -> y [B, N, M], elements of 4 bytes.  Returns cudaGetLastError().
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
#else  // the bf16 build
// K9a/K9b bf16: the same transpose in bf16 bytes.
//
// What bounds it: bytes, as above, but an element is 2 bytes, so the
// float32 design moved by halfwords (64 bytes a warp instruction) spends
// its time on instructions and latency, not on bytes.  The main path's
// launches are ResNet-18's residual re-layouts, [32, X] -> [X, 32]: every
// output row is 64 bytes, and a tile that takes all 32 of M writes one
// contiguous run.
//
// Design.  A block of 256 threads owns a TM x TN tile: TM = 32 where M <=
// 32, else 64 (K9b's M 64 whole; larger M in 64-row tiles), TN = 256 or
// 128, 16 KB either way.  A unit of a thread is a pair of x rows (m, m + 1)
// by 8 columns: two 16-byte loads where N % 8 == 0 and x is 16-byte
// aligned, else four 4-byte words (N even) or eight halfwords, every load
// of the thread's two units issued before any is used; a warp's load
// instruction reads 128 contiguous bytes of each of 8 rows.  __byte_perm
// pairs element j of row m with element j of row m + 1 into one 32-bit
// word: two consecutive elements of y's row n + j.  Shared memory holds
// the tile as y rows of TM / 2 such words with no padding; 16-byte chunks
// of a row are XOR-swizzled by the row (k9_bf16_word in ops.py mirrors
// it), so that both a warp's 32 word stores (8 rows apart in n, 4 pairs
// in m) and a quarter warp's 16-byte reads of whole chunks hit 32
// different banks (where TM = 32 two rows share the 32 banks, so a
// thread also stores its 8 words in an order that alternates the row's
// parity with its unit's).  After one barrier each thread reads 16-byte
// chunks (8 elements of a y row) and stores them by 16-byte stores (M % 8
// == 0 and y 16-byte aligned), else by 4-byte words or halfwords: a warp
// stores 512 contiguous bytes of y where TM is all of M.  The ragged edges
// of M and N are checked in the kernel; tiles are numbered along
// gridDim.x.  Bits are copied: the result is exact.
namespace {

constexpr int kBThreads = 256;
constexpr int kBUnits = 2;  // (row pair, 8 columns) units a thread

template <int TM>
struct BTile {
  static constexpr int kPairs = TM / 2;  // 32-bit words of a tile row of y
  static constexpr int kChunks = TM / 8;  // 16-byte chunks of it
  // thread groups along n: 2 where TM = 32, 1 where TM = 64
  static constexpr int kGroups = kBThreads / (8 * kPairs);
  static constexpr int TN = 64 * kGroups * kBUnits;
  // 32-bit word of shared memory holding pair p (elements 2p, 2p + 1 of
  // the tile's M) of tile row r (element r of its N)
  __device__ __forceinline__ static int word(int r, int p) {
    const int s = TM == 64 ? (r >> 3) & 7 : (r >> 4) & 3;
    return r * kPairs + 4 * ((p >> 2) ^ s) + (p & 3);
  }
};

// 8 consecutive elements of a row (n0 its first, N its length) as 4 words
// (element 0 in the low half of word 0), zeros past N or where !row; XV:
// the loads' width in bytes (16 where N % 8 == 0 and x is 16-byte aligned,
// 4 where N is even and x 4-byte aligned, else 2)
template <int XV>
__device__ __forceinline__ uint4 load8(const unsigned short* p, int n0, int N,
                                       bool row) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (XV == 16) {
    if (row && n0 < N) v = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (XV == 4) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    if (row && n0 < N) v.x = __ldg(q);
    if (row && n0 + 2 < N) v.y = __ldg(q + 1);
    if (row && n0 + 4 < N) v.z = __ldg(q + 2);
    if (row && n0 + 6 < N) v.w = __ldg(q + 3);
  } else {
    unsigned h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      h[j] = row && n0 + j < N ? __ldg(p + j) : 0u;
    v = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                   h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
  return v;
}

template <int TM, int XV>
__global__ void __launch_bounds__(kBThreads)
transpose_bf16_kernel(const unsigned short* __restrict__ x,
                      unsigned short* __restrict__ y, int M, int N,
                      int tiles_m, int tiles_n, int yv) {
  using T = BTile<TM>;
  __shared__ __align__(16) unsigned tile[T::TN * T::kPairs];
  long long t = blockIdx.x;
  const int tn = static_cast<int>(t % tiles_n);
  t /= tiles_n;
  const int tm = static_cast<int>(t % tiles_m);
  const long long b = t / tiles_m;
  const int m0 = tm * TM, n0 = tn * T::TN;
  const int tid = threadIdx.x;
  const int lane8 = tid & 7, p = (tid >> 3) % T::kPairs;
  const int grp = (tid >> 3) / T::kPairs;
  const int m = m0 + 2 * p;
  const unsigned short* xb = x + (b * M + m) * static_cast<long long>(N);

  // every load first: rows m and m + 1 of each unit's 8 columns
  uint4 lo[kBUnits], hi[kBUnits];
#pragma unroll
  for (int u = 0; u < kBUnits; ++u) {
    const int n = n0 + 8 * (lane8 + 8 * (grp + T::kGroups * u));
    lo[u] = load8<XV>(xb + n, n, N, m < M);
    hi[u] = load8<XV>(xb + N + n, n, N, m + 1 < M);
  }
  // (row m, row m + 1) of column n + j as one word of y's row n + j
#pragma unroll
  for (int u = 0; u < kBUnits; ++u) {
    const int nc = lane8 + 8 * (grp + T::kGroups * u);  // the tile's chunk
    const unsigned a[4] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w};
    const unsigned c[4] = {hi[u].x, hi[u].y, hi[u].z, hi[u].w};
    unsigned wd[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wd[2 * i] = __byte_perm(a[i], c[i], 0x5410);
      wd[2 * i + 1] = __byte_perm(a[i], c[i], 0x7632);
    }
    // TM = 32: odd chunks store their rows in the order j ^ 1, so that a
    // warp's store touches rows of both parities
    const bool swap = TM == 32 && (nc & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = swap ? j ^ 1 : j;
      tile[T::word(8 * nc + jj, p)] = swap ? wd[j ^ 1] : wd[j];
    }
  }
  __syncthreads();
  // 16-byte chunks of y rows: chunk c of tile row r is y[n0 + r][m0 + 8c ..]
  constexpr int kReads = T::TN * T::kChunks / kBThreads;
#pragma unroll
  for (int i = 0; i < kReads; ++i) {
    const int e = tid + kBThreads * i;
    const int r = e / T::kChunks, c = e % T::kChunks;
    const int n = n0 + r, mc = m0 + 8 * c;
    if (n >= N || mc >= M) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(&tile[T::word(r, 4 * c)]);
    unsigned short* d = y + (b * N + n) * static_cast<long long>(M) + mc;
    if (yv == 16) {
      *reinterpret_cast<uint4*>(d) = v;
    } else if (yv == 4) {
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (mc + 2 * q < M) reinterpret_cast<unsigned*>(d)[q] = w[q];
    } else {
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (mc + j < M)
          d[j] = static_cast<unsigned short>(w[j >> 1] >> (16 * (j & 1)));
    }
  }
}

template <int TM>
cudaError_t launch_bf16(const unsigned short* x, unsigned short* y, int B,
                        int M, int N, int xv, int yv, cudaStream_t st) {
  const int tiles_m = (M + TM - 1) / TM;
  const int tiles_n = (N + BTile<TM>::TN - 1) / BTile<TM>::TN;
  const long long blocks = static_cast<long long>(B) * tiles_m * tiles_n;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const unsigned g = static_cast<unsigned>(blocks);
  if (xv == 16)
    transpose_bf16_kernel<TM, 16><<<g, kBThreads, 0, st>>>(
        x, y, M, N, tiles_m, tiles_n, yv);
  else if (xv == 4)
    transpose_bf16_kernel<TM, 4><<<g, kBThreads, 0, st>>>(
        x, y, M, N, tiles_m, tiles_n, yv);
  else
    transpose_bf16_kernel<TM, 2><<<g, kBThreads, 0, st>>>(
        x, y, M, N, tiles_m, tiles_n, yv);
  return cudaGetLastError();
}

}  // namespace

// x [B, M, N] -> y [B, N, M] of bf16 (any 2-byte elements: bits are
// copied).  The access widths follow ops.k9_bf16_widths.  Returns
// cudaGetLastError().
extern "C" int REPRO_ENTRY(transpose_forward)(const void* x, void* y, int B,
                                              int M, int N, void* stream) {
  if (B > 0 && M > 0 && N > 0) {
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
    const int xv = N % 8 == 0 && xa % 16 == 0 ? 16
                   : N % 2 == 0 && xa % 4 == 0 ? 4 : 2;
    const int yv = M % 8 == 0 && ya % 16 == 0 ? 16
                   : M % 2 == 0 && ya % 4 == 0 ? 4 : 2;
    const auto* xs = static_cast<const unsigned short*>(x);
    auto* ys = static_cast<unsigned short*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = M <= 32 ? launch_bf16<32>(xs, ys, B, M, N, xv, yv, st)
                                  : launch_bf16<64>(xs, ys, B, M, N, xv, yv, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
