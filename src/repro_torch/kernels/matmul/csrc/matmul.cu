// K10: the tiled matmul out[M, N] = x[M, K] @ y[K, N], fp32 accumulation,
// out in x's dtype (float32 or bf16).
//
// Replaces repro/kernels/matmul/matmul.py::matmul_pallas (body
// _matmul_kernel): a (M/bm, N/bn, K/bk) grid that the TPU walks in order,
// carrying the sum in an f32 VMEM scratch from one K step to the next and
// flushing it on the last, on operands its wrapper pads to 128-multiples.
// Here blocks run in parallel and in no order: a block owns one output tile
// and one contiguous range of K (split-K), so nothing carries over between
// blocks; with more than one split each block writes its partial tile to a
// workspace [splits, M, N] and a second launch adds the partials in split
// order (the same bits on every run, no atomics).  No padded copy is made:
// ragged M, N and K are zero-filled on load and masked on store.
//
// What bounds it on an H100: operations for the matrix-expansion conv's
// layers with a large K (2*M*N*K, K up to 4608 in Table 1), bytes for the
// thin ones (K = 25, 27: the patch matrix is read once and the output
// written once, for 54 operations a read element).
//
// fp32 (mm_f32_kernel): fp32 accuracy from the TF32 tensor cores by the
// 3xTF32 split of K6 (csrc/mma.cuh), each 32-deep slice summed from zero in
// the mma registers and added to fp32 registers (the tensor core truncates
// as it accumulates).  512 threads: two producer warpgroups only copy, two
// consumer warpgroups only multiply (a warp that issues cp.async stalls its
// mma), passing a 3-stage ring of 32-deep slices on named barriers, as K6.
// Both operands are staged reduction-major, [m][k] and [n][k] rows of 40
// floats, so fragments are float2 loads free of bank conflicts: the main
// path's operands (the patch matrix, and the weights' w.reshape(Co, -1).T
// view) are both contiguous along k, and 16-byte copies fill the rows where
// a row is 16-byte aligned; other strides and unaligned rows (K = 25, 27)
// take 4-byte copies with zero fill.  Block tiles 128 x 128, 128 x 64 or
// 64 x 64, 8 consumer warps of 32 rows each.
//
// bf16 (mm_bf16_kernel): mma.sync m16n8k16 from ldmatrix on a 4-stage
// cp.async ring of 128-byte rows (64 bf16 of k) whose 16-byte chunks are
// XOR-swizzled with the row, as K12; bf16 products are exact in fp32, so
// the mma registers accumulate over the whole range.  Rows that are not
// contiguous and 16-byte aligned along k are filled element by element.
//
// The wrapper (ops.matmul_tiling) picks the tile and the splits so the
// blocks fill the 132 SMs in whole waves, and counts the launches of one
// call as one K10 call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/bf16.cuh"
#include "../../csrc/mma.cuh"

namespace {

using namespace repro::mma;

struct MatArgs {
  const void* x;  // element (m, k) at x[m * sxm + k * sxk]
  const void* y;  // element (k, n) at y[k * syk + n * syn]
  void* out;      // [M, N] contiguous, x's dtype; or the fp32 workspace
  int M, N, K;
  long long sxm, sxk, syk, syn;
  int k_per_split;  // a multiple of the slice depth
  int vec_x, vec_y;  // rows contiguous along k and 16-byte aligned
};

// ---- fp32 on the tensor cores (3xTF32) -----------------------------------

constexpr int kConsumers = 256;  // two warpgroups: the mma
constexpr int kProducers = 256;  // two warpgroups: the copies
constexpr int kThreads = kConsumers + kProducers;
constexpr int kConsumerRegs = 168;  // setmaxnreg, as K6
constexpr int kProducerRegs = 80;
constexpr int BK = 32;      // reduction slice, the flush length
constexpr int kStages = 3;  // cp.async ring depth
constexpr int kRow = BK + 8;  // shared row stride in floats

__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + kStages + s; }

template <int BM, int BN>
constexpr int f32_smem_bytes() {
  return kStages * (BM + BN) * kRow * static_cast<int>(sizeof(float));
}

// dst: out, or the workspace [splits, M, N] with more than one split
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
mm_f32_kernel(const MatArgs a, float* dst) {
  constexpr int WM = BM / 32;   // consumer warps along m, 32 rows each
  constexpr int WN = 8 / WM;    // consumer warps along n
  constexpr int WTN = BN / WN;  // columns per consumer warp
  constexpr int NT = WTN / 8;   // m16n8 tiles per consumer warp
  constexpr int ROWS = BM + BN;
  constexpr int PASS = kProducers / (BK / 4);  // rows staged at once
  static_assert(WM * WN == 8 && NT >= 2 && ROWS % PASS == 0 &&
                BM % PASS == 0, "tile");
  extern __shared__ __align__(16) float smem[];  // [kStages][ROWS][kRow]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  const int nsl = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  if (tid >= kConsumers) {
    // ---- the producer warpgroups: the copies of every slice ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    // chunk q (k 4q..4q+3 of a slice) of rows row0 + PASS i; rows [0, BM)
    // are x's (m), the rest y's (n)
    const int q = pt % (BK / 4), row0 = pt / (BK / 4);
    const float* X = static_cast<const float*>(a.x);
    const float* Y = static_cast<const float*>(a.y);
    auto stage = [&](int sl) {
      float* base = smem + (sl % kStages) * ROWS * kRow + 4 * q;
      const int k = kb + sl * BK + 4 * q;
#pragma unroll
      for (int i = 0; i < ROWS / PASS; ++i) {
        const int r = row0 + PASS * i;
        const bool isx = PASS * i < BM;
        const int o = isx ? m0 + r : n0 + (r - BM);
        const float* p = isx ? X : Y;
        float* d = base + r * kRow;
        if (o >= (isx ? a.M : a.N) || k >= ke) {
          cp16(d, p, false);
          continue;
        }
        const long long so = isx ? a.sxm : a.syn, sk = isx ? a.sxk : a.syk;
        const float* src = p + o * so + k * sk;
        if ((isx ? a.vec_x : a.vec_y) && k + 3 < ke) {
          cp16(d, src, true);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cp4(d + j, k + j < ke ? src + j * sk : p, k + j < ke);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nsl) stage(s);
      cp_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      cp_wait<kStages - 2>();  // slice sl has landed: announce it
      bar_arrive(full_bar(sl % kStages), kThreads);
      const int nx = sl + kStages - 1;
      if (nx < nsl) {
        if (nx >= kStages) bar_sync(empty_bar(nx % kStages), kThreads);
        stage(nx);
      }
      cp_commit();
    }
    return;
  }

  // ---- the consumer warpgroups: the products and the stores ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int nvalid = a.N - n0 - wn * WTN;  // columns of this warp in range
  float total[2][NT][4];
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  for (int sl = 0; sl < nsl; ++sl) {
    const int buf = sl % kStages;
    bar_sync(full_bar(buf), kThreads);
    const float* As = smem + buf * ROWS * kRow;
    const float* Bs = As + BM * kRow;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned abig[2][4], asmall[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4), a3 (row
        // g+8, k t+4): k t is physical column 2t, k t+4 is 2t+1
        const float* pa = As + (wm * 32 + mt * 16 + gq) * kRow + kk + 2 * tq;
        const float2 lo = *reinterpret_cast<const float2*>(pa);
        const float2 hi = *reinterpret_cast<const float2*>(pa + 8 * kRow);
        split_tf32(lo.x, abig[mt][0], asmall[mt][0]);
        split_tf32(hi.x, abig[mt][1], asmall[mt][1]);
        split_tf32(lo.y, abig[mt][2], asmall[mt][2]);
        split_tf32(hi.y, abig[mt][3], asmall[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt * 8 >= nvalid) continue;  // past the last column
        const float2 bv = *reinterpret_cast<const float2*>(
            Bs + (wn * WTN + nt * 8 + gq) * kRow + kk + 2 * tq);
        unsigned b0big, b0small, b1big, b1small;
        split_tf32(bv.x, b0big, b0small);
        split_tf32(bv.y, b1big, b1small);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (kk == 0)
            mma_tf32(acc[mt][nt], asmall[mt], b0big, b1big, zero);
          else
            mma_tf32(acc[mt][nt], asmall[mt], b0big, b1big, acc[mt][nt]);
          mma_tf32(acc[mt][nt], abig[mt], b0small, b1small, acc[mt][nt]);
          mma_tf32(acc[mt][nt], abig[mt], b0big, b1big, acc[mt][nt]);
        }
      }
    }
    // the stage is free for the producers (they wait only for the stages
    // they refill)
    if (sl + kStages < nsl) bar_arrive(empty_bar(buf), kThreads);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt * 8 >= nvalid) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][nt][e] += acc[mt][nt][e];
      }
  }

  // c0 (row g, col 2t), c1 (row g, 2t+1), c2 (row g+8, 2t), c3 (g+8, 2t+1):
  // a float2 a row where both columns are in range and N is even
  const bool pair = (a.N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mt * 16 + gq + 8 * h;
      if (m >= a.M) continue;
      float* row = dst + (static_cast<long long>(blockIdx.z) * a.M + m) * a.N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * WTN + nt * 8 + 2 * tq;
        const float v0 = total[mt][nt][2 * h], v1 = total[mt][nt][2 * h + 1];
        if (pair && n + 1 < a.N) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < a.N) row[n] = v0;
          if (n + 1 < a.N) row[n + 1] = v1;
        }
      }
    }
}

// ---- bf16 on the tensor cores (m16n8k16) ----------------------------------

constexpr int kBfThreads = 256;   // 8 warps
constexpr int kRowBytes = 128;    // bytes of k each row of a stage holds
constexpr int kBfStages = 4;      // cp.async ring depth
constexpr int kBfK = kRowBytes / 2;  // k of a stage

template <int BM, int BN>
constexpr int bf16_smem_bytes() {
  return kBfStages * (BM + BN) * kRowBytes;
}

// byte offset of 16-byte chunk c of row r in a [rows][128 bytes] tile
__device__ __forceinline__ int swz128(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

template <int BM, int BN>
__global__ void __launch_bounds__(kBfThreads, 1)
mm_bf16_kernel(const MatArgs a, float* ws) {
  constexpr int WM = BM / 32, WN = 8 / WM, WTN = BN / WN, NT = WTN / 8;
  constexpr int STAGE = (BM + BN) * kRowBytes;
  static_assert(WM * WN == 8 && NT % 2 == 0, "tile");
  extern __shared__ __align__(128) unsigned char smem_b[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * a.k_per_split;
  const int ke = min(a.K, kb + a.k_per_split);
  const int nsl = ke > kb ? (ke - kb + kBfK - 1) / kBfK : 0;
  const unsigned short* X = static_cast<const unsigned short*>(a.x);
  const unsigned short* Y = static_cast<const unsigned short*>(a.y);

  // stage sl: rows [0, BM) of x from m0, [BM, BM + BN) of y from n0, k from
  // kb + sl * 64; zero past M, N and the split's end
  auto load = [&](int sl) {
    unsigned char* dst = smem_b + (sl % kBfStages) * STAGE;
    const int k0 = kb + sl * kBfK;
    for (int e = tid; e < (BM + BN) * 8; e += kBfThreads) {
      const int r = e >> 3, c = e & 7;
      const bool isx = r < BM;
      const int o = isx ? m0 + r : n0 + (r - BM);
      const bool orow = o < (isx ? a.M : a.N);
      const unsigned short* p = isx ? X : Y;
      const long long so = isx ? a.sxm : a.syn, sk = isx ? a.sxk : a.syk;
      const int k = k0 + 8 * c;
      unsigned char* d = dst + swz128(r, c);
      if (isx ? a.vec_x : a.vec_y) {
        const bool ok = orow && k + 7 < ke;
        if (ok || !orow || k >= ke) {
          cp16(d, ok ? p + o * so + k : p, ok);
          continue;
        }
      }
      // element loads (visible after the barrier that precedes the
      // stage's use): strided rows, unaligned rows, the ragged k end
#pragma unroll
      for (int j = 0; j < 8; ++j)
        reinterpret_cast<unsigned short*>(d)[j] =
            orow && k + j < ke ? p[o * so + (k + j) * sk]
                               : static_cast<unsigned short>(0);
    }
  };

#pragma unroll
  for (int s = 0; s < kBfStages - 1; ++s) {
    if (s < nsl) load(s);
    cp_commit();
  }
  float total[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;
  const int nvalid = a.N - n0 - wn * WTN;

  for (int sl = 0; sl < nsl; ++sl) {
    cp_wait<kBfStages - 2>();
    __syncthreads();  // stage sl landed; stage sl - 1's buffer is free
    if (sl + kBfStages - 1 < nsl) load(sl + kBfStages - 1);
    cp_commit();
    const unsigned char* As = smem_b + (sl % kBfStages) * STAGE;
    const unsigned char* Bs = As + BM * kRowBytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 16 k a step
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], As + swz128(wm * 32 + mt * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    2 * ks + (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        if (nt * 8 >= nvalid) continue;  // past the last column
        unsigned bf[4];
        ldsm_x4(bf, Bs + swz128(wn * WTN + nt * 8 + (lane & 7) +
                                    (lane >> 4) * 8,
                                2 * ks + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(total[mt][nt], af[mt], bf[0], bf[1]);
          mma_bf16(total[mt][nt + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // one split: bf16 out; several: fp32 partials into the workspace
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
      if (m >= a.M) continue;
      const long long row = static_cast<long long>(m) * a.N;
      float* part = ws ? ws + static_cast<long long>(blockIdx.z) * a.M * a.N
                       : nullptr;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * WTN + nt * 8 + 2 * tq + j;
          if (n >= a.N) continue;
          const float v = total[mt][nt][2 * h + j];
          if (part)
            part[row + n] = v;
          else
            static_cast<__nv_bfloat16*>(a.out)[row + n] =
                __float2bfloat16(v);
        }
      }
    }
}

// out[i] = the split partials summed in split order
template <typename T>
__global__ void __launch_bounds__(256)
mm_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                  int splits, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[sp * n + i];
  repro::store_f32(out + i, s);
}

template <int BM, int BN>
cudaError_t launch_tile(const MatArgs& a, bool bf16, int splits, float* dst,
                        cudaStream_t st) {
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, splits);
  if (bf16) {
    constexpr int smem = bf16_smem_bytes<BM, BN>();
    const cudaError_t e = cudaFuncSetAttribute(
        mm_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    mm_bf16_kernel<BM, BN><<<grid, kBfThreads, smem, st>>>(a, dst);
  } else {
    constexpr int smem = f32_smem_bytes<BM, BN>();
    const cudaError_t e = cudaFuncSetAttribute(
        mm_f32_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    mm_f32_kernel<BM, BN><<<grid, kThreads, smem, st>>>(a, dst);
  }
  return cudaGetLastError();
}

}  // namespace

// x [M, K] at x[m * sxm + k * sxk]; y [K, N] at y[k * syk + n * syn]; out
// [M, N] contiguous, of x's dtype.  bf16 != 0: all three are bf16, else
// float32.  The block tile is bm x bn (128 x 128, 128 x 64 or 64 x 64);
// split s reduces k in [s * k_per_split, (s + 1) * k_per_split)
// (k_per_split a multiple of 32 for fp32, of 64 for bf16); ws [splits, M,
// N] fp32 when splits > 1, else unused.  Returns cudaGetLastError().
extern "C" int matmul_forward(const void* x, const void* y, void* out,
                              void* ws, int M, int N, int K, long long sxm,
                              long long sxk, long long syk, long long syn,
                              int bf16, int bm, int bn, int k_per_split,
                              int splits, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const int depth = bf16 ? kBfK : BK;
  if (K < 0 || splits < 1 || k_per_split < depth ||
      k_per_split % depth != 0 || (splits > 1 && ws == nullptr) ||
      (N + bn - 1) / bn > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  MatArgs a;
  a.x = x;
  a.y = y;
  a.out = out;
  a.M = M; a.N = N; a.K = K;
  a.sxm = sxm; a.sxk = sxk; a.syk = syk; a.syn = syn;
  a.k_per_split = k_per_split;
  const int es = bf16 ? 2 : 4;
  a.vec_x = sxk == 1 && (sxm * es) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_y = syk == 1 && (syn * es) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(y) % 16 == 0;
  float* dst = splits > 1 ? static_cast<float*>(ws)
                          : (bf16 ? nullptr : static_cast<float*>(out));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bm == 128 && bn == 128)
    e = launch_tile<128, 128>(a, bf16, splits, dst, st);
  else if (bm == 128 && bn == 64)
    e = launch_tile<128, 64>(a, bf16, splits, dst, st);
  else if (bm == 64 && bn == 64)
    e = launch_tile<64, 64>(a, bf16, splits, dst, st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(M) * N;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (bf16)
    mm_combine_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out),
        splits, n);
  else
    mm_combine_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<float*>(out), splits, n);
  return static_cast<int>(cudaGetLastError());
}
