// K11: attention with an online softmax, out = softmax(q kᵀ / sqrt(D)) v
// over q [BH, Sq, D], k and v [BH, Sk, D], optionally causal; out in q's
// dtype (float32 or bf16).
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
// elements moved.  One block of 128 threads per (bh, q tile), the KV loop
// inside the block; keys past Sk get probability 0 and zero-filled
// K and V rows (0 * garbage could be NaN), and a masked entry is 0 even
// while the row max is still the -1e30 start, where exp(s - m) would be 1;
// rows past Sq are not written; causal q tiles are numbered from the last,
// so the blocks with the most KV tiles start first; the head dim is padded
// with zeros to a DT = 64, 128 or 256 tile, so any D <= 256 runs.
//
// bf16 inputs (flash_bf16_kernel) run both products on the tensor cores:
// mma.sync m16n8k16 bf16 x bf16 with fp32 accumulation, two 16-row m
// tiles a warp (128 query rows a block; one tile and 64 rows at D 256,
// where two would not fit the registers), so each K and V fragment loaded
// feeds two products.  q, K and V tiles sit in shared memory in 16-byte
// chunks whose index is XORed with the row (mod 8), so ldmatrix reads 8
// rows without bank conflicts; K and V are double-buffered by cp.async,
// the next tile in flight while this one multiplies, one barrier a tile.
// S = q Kᵀ stays in the mma accumulators; the online softmax runs on them,
// its row max and sum reduced over the 4 lanes that share a row; P is
// rounded to bf16 in registers, where the accumulator layout of S is the
// A-operand layout of P @ V, and V's B operand comes from ldmatrix.trans.
// Rounding P to bf16 is the one difference from the reference, which
// multiplies p @ v in f32 (its tolerance, 8 * BF16_EPS, holds).
//
// fp32 inputs (flash_f32_kernel) stay on the CUDA cores (TF32 would not
// hold the 1e-4 tolerance): a thread owns 4 rows x 8 keys of the 64 x 64
// score tile; P stays in registers, and P @ V fetches each probability
// from the lane that holds it by a warp shuffle; K and V are single
// tiles, each loaded by cp.async while the other product runs, so three
// shared tiles (q, K, V) fit two blocks an SM at D 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/mma.cuh"

namespace {

using namespace repro::mma;

constexpr int kThreads = 128;
constexpr int BQ = 64;             // query rows per block
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int BH, Sq, Sk, D, causal;
  float scale;
  int vec;  // rows 16-byte aligned: cp.async 16 bytes, else element loads
};

template <int ROWS = BQ>
__device__ __forceinline__ int first_q_tile(const FlashArgs& a) {
  const int nq = (a.Sq + ROWS - 1) / ROWS;
  return (a.causal ? nq - 1 - blockIdx.x : blockIdx.x) * ROWS;
}

// =========================== fp32: CUDA cores ============================

constexpr int BKV = 64;  // keys per tile (fp32 kernel)

template <int DT>
__host__ __device__ constexpr int f32_smem_bytes() {
  return 4 * 3 * BQ * (DT + 4);
}

// rows [r0, r0 + 64) of a [S, D] fp32 matrix into a [64][DT + 4] tile by
// cp.async, zero past S and past D
template <int DT>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         int r0, int S, int D, bool vec) {
  constexpr int STR = DT + 4;
  if (vec) {
    for (int e = threadIdx.x; e < 64 * DT / 4; e += kThreads) {
      const int r = e / (DT / 4), d = (e - r * (DT / 4)) * 4;
      const bool ok = r0 + r < S && d < D;
      cp16(dst + r * STR + d, ok ? src + (long long)(r0 + r) * D + d : src,
           ok);
    }
  } else {
    for (int e = threadIdx.x; e < 64 * DT; e += kThreads) {
      const int r = e / DT, d = e - r * DT;
      const bool ok = r0 + r < S && d < D;
      cp4(dst + r * STR + d, ok ? src + (long long)(r0 + r) * D + d : src,
          ok);
    }
  }
}

__device__ __forceinline__ float row_reduce_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float row_reduce_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32_kernel(const FlashArgs a) {
  constexpr int STR = DT + 4;
  constexpr int NJ = DT / 32;  // float4 accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;           // [BQ][STR]
  float* Ks = Qs + BQ * STR;  // [BKV][STR]
  float* Vs = Ks + BKV * STR;  // [BKV][STR]

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid % 8, ty = tid / 8;  // keys tx + 8j; rows ty*4 + i
  const int q0 = first_q_tile(a);
  const int bh = blockIdx.y;
  const float* q = static_cast<const float*>(a.q) + (long long)bh * a.Sq * a.D;
  const float* k = static_cast<const float*>(a.k) + (long long)bh * a.Sk * a.D;
  const float* v = static_cast<const float*>(a.v) + (long long)bh * a.Sk * a.D;
  const bool vec = a.vec;

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
  load_f32<DT>(Qs, q, q0, a.Sq, a.D, vec);
  load_f32<DT>(Ks, k, 0, a.Sk, a.D, vec);
  cp_commit();
  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    const bool more = k0 + BKV < k_end;
    cp_wait<0>();
    __syncthreads();  // K (and q) landed; the last P @ V is done with Vs
    load_f32<DT>(Vs, v, k0, a.Sk, a.D, vec);
    cp_commit();

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
    __syncthreads();  // every warp is done with Ks
    if (more) {
      load_f32<DT>(Ks, k, k0 + BKV, a.Sk, a.D, vec);
      cp_commit();
    }

    // the online softmax; s becomes P (unnormalized), kept in registers
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
      const float m_new = fmaxf(m[i], row_reduce_max8(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += s[i][j];
      }
      l[i] = l[i] * alpha + row_reduce_sum8(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= alpha;
    }
    if (more)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();  // V landed

    // P @ V: key 8 jj + t of this thread's rows lives in lane (row group
    // base + t) as s[i][jj]
    const int base = lane & ~7;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int kk = 8 * jj + t;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = __shfl_sync(0xffffffffu, s[i][jj], base + t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[kk * STR + tx * 4 + 32 * j]);
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
  }

  float* out = static_cast<float*>(a.out) + (long long)bh * a.Sq * a.D;
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
        if (d < a.D) out[(long long)row * a.D + d] = acc[i][j][c] * inv;
      }
  }
}

// ========================= bf16: tensor cores ============================

template <int DT>
__host__ __device__ constexpr int bkv_bf16() {
  return DT <= 128 ? 64 : 32;
}

template <int DT>
__host__ __device__ constexpr int mtiles_bf16() {
  return DT <= 128 ? 2 : 1;  // 16-row m tiles a warp
}

template <int DT>
__host__ __device__ constexpr int bq_bf16() {
  return 64 * mtiles_bf16<DT>();
}

template <int DT>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return 2 * DT * (bq_bf16<DT>() + 4 * bkv_bf16<DT>());  // q, 2 K, 2 V
}

// rows [r0, r0 + rows) of a [S, D] bf16 matrix into a swizzled
// [rows][DT] tile, zero past S and past D: cp.async 16-byte chunks where
// rows are 16-byte aligned, else element loads (visible after the next
// barrier, as the copies are)
template <int DT>
__device__ __forceinline__ void load_bf16(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int S, int D, bool vec) {
  constexpr int CH = DT / 8;
  for (int e = threadIdx.x; e < rows * CH; e += kThreads) {
    const int r = e / CH, c = e - r * CH;
    const int row = r0 + r, d0 = c * 8;
    __nv_bfloat16* p = dst + swz<DT>(r, c);
    if (vec) {
      const bool ok = row < S && d0 < D;
      cp16(p, ok ? src + (long long)row * D + d0 : src, ok);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x)
        p[x] = (row < S && d0 + x < D) ? src[(long long)row * D + d0 + x]
                                       : __float2bfloat16(0.f);
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
flash_bf16_kernel(const FlashArgs a) {
  constexpr int KV = bkv_bf16<DT>();  // keys a tile
  constexpr int MT = mtiles_bf16<DT>();  // 16-row m tiles a warp
  constexpr int BQB = bq_bf16<DT>();  // q rows a block
  constexpr int NB = KV / 8;          // 8-key blocks of S
  constexpr int ND = DT / 8;          // 8-column blocks of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQB * DT;     // [2][KV][DT]
  __nv_bfloat16* Vs = Ks + 2 * KV * DT;  // [2][KV][DT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row, column pair
  const int q0 = first_q_tile<BQB>(a);
  const int bh = blockIdx.y;
  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(a.q) + (long long)bh * a.Sq * a.D;
  const bf* k = static_cast<const bf*>(a.k) + (long long)bh * a.Sk * a.D;
  const bf* v = static_cast<const bf*>(a.v) + (long long)bh * a.Sk * a.D;
  const bool vec = a.vec;
  const float sl2 = a.scale * kLog2e;  // exp(x) = exp2(x * log2 e)

  float o[MT][ND][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[mt][j][c] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  const int k_end = a.causal ? min(a.Sk, q0 + BQB) : a.Sk;
  const int ntiles = (k_end + KV - 1) / KV;
  load_bf16<DT>(Qs, q, q0, BQB, a.Sq, a.D, vec);
  load_bf16<DT>(Ks, k, 0, KV, a.Sk, a.D, vec);
  load_bf16<DT>(Vs, v, 0, KV, a.Sk, a.D, vec);
  cp_commit();
  const int r_w = warp * 16 * MT;  // this warp's first q row in the tile

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * KV, buf = it & 1;
    cp_wait<0>();
    __syncthreads();  // tile it landed; tile it-1's buffers are free
    if (it + 1 < ntiles) {
      load_bf16<DT>(Ks + (buf ^ 1) * KV * DT, k, k0 + KV, KV, a.Sk, a.D, vec);
      load_bf16<DT>(Vs + (buf ^ 1) * KV * DT, v, k0 + KV, KV, a.Sk, a.D, vec);
      cp_commit();
    }
    const bf* Kt = Ks + buf * KV * DT;
    const bf* Vt = Vs + buf * KV * DT;

    // S = q Kᵀ for this warp's MT x 16 rows x KV keys; each K fragment
    // feeds every m tile
    float s[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][j][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DT / 16; ++ks) {
      unsigned qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(qa[mt], Qs + swz<DT>(r_w + 16 * mt + (lane & 7) +
                                         ((lane >> 3) & 1) * 8,
                                     2 * ks + (lane >> 4)));
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        unsigned kb[4];
        ldsm_x4(kb, Kt + swz<DT>(nb * 8 + (lane & 7) + (lane >> 4) * 8,
                                 2 * ks + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][nb], qa[mt], kb[0], kb[1]);
          mma_bf16(s[mt][nb + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // the online softmax on the accumulators: lane holds rows g and
      // g + 8 of m tile mt, keys 8 nb + 2 t4 + {0, 1}
      const int qpos0 = q0 + r_w + 16 * mt + g, qpos1 = qpos0 + 8;
      float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kpos = k0 + nb * 8 + 2 * t4 + (c & 1);
          const int qpos = c < 2 ? qpos0 : qpos1;
          const bool keep = kpos < a.Sk && (!a.causal || kpos <= qpos);
          s[mt][nb][c] = keep ? s[mt][nb][c] * sl2 : -INFINITY;
          rmax[c >> 1] = fmaxf(rmax[c >> 1], s[mt][nb][c]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 1));
        rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 2));
        const float m_new = fmaxf(m[mt][h], rmax[h]);
        alpha[h] = exp2f(m[mt][h] - m_new);
        m[mt][h] = m_new;
      }
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // a masked entry is -inf: exp2 gives exactly 0, also while m
          // is still the -1e30 start
          s[mt][nb][c] = exp2f(s[mt][nb][c] - m[mt][c >> 1]);
          rsum[c >> 1] += s[mt][nb][c];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
        rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
        l[mt][h] = l[mt][h] * alpha[h] + rsum[h];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[mt][j][0] *= alpha[0];
        o[mt][j][1] *= alpha[0];
        o[mt][j][2] *= alpha[1];
        o[mt][j][3] *= alpha[1];
      }
    }

    // O += P V: P's A operand for keys 16 kk .. 16 kk + 15 is the S
    // accumulators of key blocks 2 kk and 2 kk + 1, rounded to bf16; each
    // V fragment feeds every m tile
#pragma unroll
    for (int kk = 0; kk < KV / 16; ++kk) {
      unsigned pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        unsigned vb[4];
        ldsm_x4_t(vb, Vt + swz<DT>(16 * kk + (lane & 7) +
                                       ((lane >> 3) & 1) * 8,
                                   nd + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][nd], pa[mt], vb[0], vb[1]);
          mma_bf16(o[mt][nd + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  bf* out = static_cast<bf*>(a.out) + (long long)bh * a.Sq * a.D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r_w + 16 * mt + g + 8 * h;
      if (row >= a.Sq) continue;
      const float inv = 1.f / fmaxf(l[mt][h], 1e-30f);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = nd * 8 + 2 * t4 + c;
          if (d < a.D)
            out[(long long)row * a.D + d] =
                __float2bfloat16(o[mt][nd][2 * h + c] * inv);
        }
    }
}

template <typename Kernel>
int launch_kernel(Kernel kernel, int bytes, int rows, const FlashArgs& a,
                  cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // refused: leave no error for the next launch
    return static_cast<int>(e);
  }
  const dim3 grid((a.Sq + rows - 1) / rows, a.BH);
  kernel<<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int launch(const FlashArgs& a, bool bf16, cudaStream_t st) {
  return bf16 ? launch_kernel(flash_bf16_kernel<DT>, bf16_smem_bytes<DT>(),
                              bq_bf16<DT>(), a, st)
              : launch_kernel(flash_f32_kernel<DT>, f32_smem_bytes<DT>(), BQ,
                              a, st);
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
  const int row_align = bf16 ? 8 : 4;  // elements in 16 bytes
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  FlashArgs a{q, k, v, out, BH, Sq, Sk, D, causal, scale,
              aligned && D % row_align == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(a, bf16, st);
  if (D <= 128) return launch<128>(a, bf16, st);
  return launch<256>(a, bf16, st);
}
