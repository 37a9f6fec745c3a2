// K11: attention with an online softmax, out = softmax(q kᵀ / sqrt(D)) v
// over q [BH, Sq, D], k and v [BH, Sk, D], optionally causal; fp32 compute,
// out in q's dtype (float32 or bf16).
//
// Replaces repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (body _flash_kernel): per (batch-head, q block)
// the running max m, normalizer l and an f32 accumulator live in VMEM
// scratch over a KV grid axis that the TPU walks in order, so the
// [Sq, Sk] score matrix never reaches device memory.  Its causal mask is
// the kernel's own, top-left: key kpos is kept where kpos <= qpos, both
// counted from 0 (which for Sq != Sk is not the bottom-right mask of
// repro/kernels/flash_attention/ref.py); KV blocks past the q block's
// last row are skipped; the output divides by max(l, 1e-30).
//
// What bounds it on an H100: operations.  4 * Sq * Sk * D FMA-operations a
// head (half of them under a causal mask) against (2 Sk + 2 Sq) * D
// elements moved.  Design: one block of 128 threads per (bh, 64-row q
// tile), the KV loop inside the block.  The q tile stays in shared memory;
// each 64-key K and V tile is staged through shared memory, the 64 x 64
// score tile is computed in registers (a thread owns 4 rows x 8 keys), the
// row max and sum are reduced across the 8 threads that share a row with
// warp shuffles, and the probabilities go through shared memory into the
// P @ V product, whose [64, D] fp32 accumulator stays in registers (4 rows
// x D/8 columns a thread).  The head dim is padded to DT = 64, 128 or 256
// in shared memory (zeros), so any D <= 256 runs; ragged Sq and Sk are
// masked (keys past Sk get probability 0, rows past Sq are not written),
// where the reference's wrapper halves its block until it divides S.
// Causal q tiles are numbered from the last, so the blocks with the most
// KV tiles start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "../../csrc/bf16.cuh"

namespace {

using repro::store_f32;
using repro::to_f32;

constexpr int kThreads = 128;
constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per tile
constexpr int PSTR = BKV + 2;  // probability row stride (bank spread)
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int BH, Sq, Sk, D, causal;
  float scale;
};

template <int DT>
constexpr int smem_bytes() {
  return 4 * ((BQ + 2 * BKV) * (DT + 4) + BQ * PSTR);
}

// rows [r0, r0 + rows) of a [S, D] matrix into a [rows][DT + 4] tile,
// zero past S and past D
template <typename T, int DT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, int D) {
  constexpr int STR = DT + 4;
  for (int e = threadIdx.x; e < BKV * DT; e += kThreads) {
    const int r = e / DT, d = e - r * DT;
    const int row = r0 + r;
    dst[r * STR + d] =
        (row < S && d < D) ? to_f32(src[(long long)row * D + d]) : 0.f;
  }
}

__device__ __forceinline__ float row_reduce_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float row_reduce_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads) flash_kernel(const FlashArgs a) {
  constexpr int STR = DT + 4;
  constexpr int NJ = DT / 32;  // float4 accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][STR]
  float* Ks = Qs + BQ * STR;        // [BKV][STR]
  float* Vs = Ks + BKV * STR;       // [BKV][STR]
  float* Ps = Vs + BKV * STR;       // [BQ][PSTR]

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;  // keys tx + 8j; rows ty*4 + i
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt = a.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + (long long)bh * a.Sq * a.D;
  const T* k = static_cast<const T*>(a.k) + (long long)bh * a.Sk * a.D;
  const T* v = static_cast<const T*>(a.v) + (long long)bh * a.Sk * a.D;

  load_tile<T, DT>(Qs, q, q0, a.Sq, a.D);  // BQ == BKV rows

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  // causal: keys past the tile's last row are masked for every row
  const int k_end = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    __syncthreads();  // the previous tile's P @ V is done with Vs and Ps
    load_tile<T, DT>(Ks, k, k0, a.Sk, a.D);
    load_tile<T, DT>(Vs, v, k0, a.Sk, a.D);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DT; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * STR + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[(tx + 8 * j) * STR + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool keep[8];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        keep[j] = kpos < a.Sk && (!a.causal || kpos <= qpos);
        s[i][j] = keep[j] ? s[i][j] * a.scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        Ps[(ty * 4 + i) * PSTR + tx + 8 * j] = p;
      }
      l[i] = l[i] * alpha + row_reduce_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PSTR + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[kk * STR + tx * 4 + 32 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(p[i], vv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(p[i], vv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(p[i], vv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(p[i], vv.w, acc[i][j][3]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out) + (long long)bh * a.Sq * a.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = tx * 4 + 32 * j + c;
        if (d < a.D)
          store_f32(out + (long long)row * a.D + d, acc[i][j][c] * inv);
      }
  }
}

template <typename T, int DT>
int launch(const FlashArgs& a, cudaStream_t st) {
  auto kernel = flash_kernel<T, DT>;
  constexpr int bytes = smem_bytes<DT>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.BH);
  kernel<<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const FlashArgs& a, cudaStream_t st) {
  if (a.D <= 64) return launch<T, 64>(a, st);
  if (a.D <= 128) return launch<T, 128>(a, st);
  return launch<T, 256>(a, st);
}

}  // namespace

// q [BH, Sq, D], k and v [BH, Sk, D], out [BH, Sq, D], all contiguous and
// of one dtype (bf16 != 0: bfloat16, else float32); 1 <= D <= 256.
// Returns cudaGetLastError().
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* out, int BH,
                                       int Sq, int Sk, int D, int causal,
                                       float scale, int bf16, void* stream) {
  if (D < 1 || D > 256 || Sk < 1 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  FlashArgs a{q, k, v, out, BH, Sq, Sk, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
}
