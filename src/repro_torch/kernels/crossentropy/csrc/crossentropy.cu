// K12: fused unembed + cross entropy.  For each token t, the logits
// z[t, v] = h[t] . table[v] (softcapped to cap * tanh(z / cap) when a cap
// is given) are reduced on chip to loss[t] = logsumexp_v z[t, v] -
// z[t, label[t]]; the [T, V] logits never reach device memory.  h [T, D]
// and table [V, D] are float32 or bf16, the loss is float32.
//
// Replaces repro/kernels/crossentropy/crossentropy.py::xent_pallas (body
// _xent_kernel): per token block, a vocab grid axis that the TPU walks in
// order folds each [bt, bv] logits tile into an online (max, sum, gold)
// triple in VMEM scratch; softcap comes before the pad-column mask; the
// loss is m + log(max(s, 1e-30)) - gold.  A label outside [0, V) hits no
// column and contributes gold 0 (the loss is the bare logsumexp), which
// is what that kernel gives for every out-of-range label its block padding
// does not catch.
//
// What bounds it on an H100: operations (2*T*V*D, 4.46 TFLOP for qwen2-7b's
// head at 4096 tokens): 989 TFLOP/s for bf16 on the tensor cores, 67 for
// fp32 on the CUDA cores, or 495 / 3 for fp32 accuracy on the TF32 tensor
// cores.
//
// Design.  A block's logits tile is 128 tokens x 128 vocab rows, computed
// on the tensor cores by 8 warps, each a 32 x 64 piece (two m16 tiles by
// eight n8 tiles).  h and table rows are both contiguous along D, the
// reduction, as mma's row.col operands want: a stage holds 128 bytes of
// each of the 256 rows (64 bf16 or 32 fp32 of D), in 16-byte chunks whose
// index is XORed with the row (mod 8), so ldmatrix reads 8 rows without
// bank conflicts; a 4-stage cp.async ring streams the stages over D (and
// on into the next vocab tile), one barrier a stage.  ldmatrix reads the
// same fragments for both types: an 8 x 8 b16 matrix is an 8 x 4 fp32 one,
// whose lanes hold exactly the m16n8k8 TF32 fragments.
//   bf16: mma.sync m16n8k16, bf16 x bf16 with fp32 accumulation.
//   fp32: 3xTF32 as K6 (csrc/mma.cuh): each value split into big (rounded
//   to TF32) and small, three m16n8k8 products a term.
// The tensor core truncates as it accumulates, so fp32's 3xTF32 products
// of each stage start from zero in the mma registers and are added to fp32
// registers; bf16's products are exact in fp32 and accumulate over the
// whole of D in the mma registers (a chain of D / 16 steps).
// The online (m, s, gold) update runs on the finished tile in registers:
// a row's max and sum are reduced over the 4 lanes that hold it by
// shfl.xor 1, 2, and its max over the two warps that share it through
// shared memory in a fixed order, so both keep the same m; each warp keeps
// its own s over its columns, and the two are added at the end.
//
// Blocks run in parallel and in no order, so the vocab axis is split:
// block (t tile, split) walks a contiguous range of vocab tiles and writes
// its partial triple to a workspace [3, splits, T]; a second launch
// combines each token's partials in split order (max, rescaled sum, gold
// sum) and writes the loss.  Two runs are the same bit for bit (no
// atomics).  The wrapper picks the split (ops.xent_splits) and counts the
// two launches as one K12 call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/mma.cuh"

namespace {

using namespace repro::mma;

constexpr int kThreads = 256;       // 8 warps: 4 along tokens x 2 along V
constexpr int BT = 128;             // tokens of a tile
constexpr int BV = 128;             // vocab rows of a tile
constexpr int kRowBytes = 128;      // bytes of each row a stage holds
constexpr int kStages = 4;          // cp.async ring depth
constexpr int kStageBytes = (BT + BV) * kRowBytes;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

struct XentArgs {
  const unsigned char* h;      // [T, D] rows of D * esize bytes
  const unsigned char* table;  // [V, D]
  const long long* labels;
  float* ws;                   // [3, splits, T]: m, s, gold
  int T, V, D;
  int tiles_per_split, splits;
  float softcap;               // <= 0: none
  int vec;                     // rows 16-byte aligned: cp.async 16 bytes
};

// byte offset of 16-byte chunk c of row r in a [rows][128 bytes] tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// stage `sl` of the block's walk (vocab tile sl / kst, D bytes [db,
// db + 128) with db = (sl % kst) * 128) into `dst`: BT rows of h from t0,
// BV rows of table from v0, zero past T, V and D
template <int ES>
__device__ __forceinline__ void load_stage(const XentArgs& a,
                                           unsigned char* dst, int t0,
                                           int v0, int db) {
  const long long row_bytes = static_cast<long long>(a.D) * ES;
  for (int e = threadIdx.x; e < (BT + BV) * 8; e += kThreads) {
    const int r = e >> 3, c = e & 7;
    const bool is_h = r < BT;
    const int row = is_h ? t0 + r : v0 + (r - BT);
    const int nrows = is_h ? a.T : a.V;
    const unsigned char* base = is_h ? a.h : a.table;
    const int b0 = db + 16 * c;  // byte of D where the chunk starts
    unsigned char* d = dst + swz(r, c);
    if (a.vec) {
      const bool ok = row < nrows && b0 < row_bytes;
      cp16(d, ok ? base + row * row_bytes + b0 : base, ok);
    } else {
      // element loads (visible after the barrier that precedes the stage's
      // use): rows whose bytes are not 16-byte aligned
#pragma unroll
      for (int x = 0; x < 16; x += ES) {
        const bool ok = row < nrows && b0 + x < row_bytes;
        if (ES == 4)
          *reinterpret_cast<float*>(d + x) =
              ok ? *reinterpret_cast<const float*>(base + row * row_bytes +
                                                   b0 + x)
                 : 0.f;
        else
          *reinterpret_cast<unsigned short*>(d + x) =
              ok ? *reinterpret_cast<const unsigned short*>(
                       base + row * row_bytes + b0 + x)
                 : static_cast<unsigned short>(0);
      }
    }
  }
}

// the sum over the 4 lanes that share an accumulator row (xor butterfly,
// so the 4 copies agree bit for bit), and the max
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ES: element bytes (2: bf16 on m16n8k16; 4: fp32 by 3xTF32 on m16n8k8)
template <int ES>
__global__ void __launch_bounds__(kThreads, 1)
xent_partial_kernel(const XentArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][2][BT];  // [tile parity][warp along V][row]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // rows 32 wm.., columns 64 wn..
  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int nvt = (a.V + BV - 1) / BV;
  const int vt_begin = split * a.tiles_per_split;
  const int ntiles = min(nvt, vt_begin + a.tiles_per_split) - vt_begin;
  const int kst = (a.D * ES + kRowBytes - 1) / kRowBytes;  // stages a tile
  const int nsl = ntiles * kst;

  // this thread's rows: r(mt, h) = 32 wm + 16 mt + g + 8 h
  float m[2][2], s[2][2], gold[2][2];
  long long lab[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm * 32 + mt * 16 + g + 8 * h;
      m[mt][h] = kNegInf;
      s[mt][h] = 0.f;
      gold[mt][h] = 0.f;
      lab[mt][h] = t < a.T ? a.labels[t] : -1;
    }

  auto stage_ptr = [&](int sl) { return smem + (sl % kStages) * kStageBytes; };
  auto load = [&](int sl) {
    const int vt = vt_begin + sl / kst;
    load_stage<ES>(a, stage_ptr(sl), t0, vt * BV, (sl % kst) * kRowBytes);
  };

#pragma unroll
  for (int s0 = 0; s0 < kStages - 1; ++s0) {
    if (s0 < nsl) load(s0);
    cp_commit();
  }

  float total[2][8][4], acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  for (int sl = 0; sl < nsl; ++sl) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage sl landed; stage sl - 1's buffer is free
    if (sl + kStages - 1 < nsl) load(sl + kStages - 1);
    cp_commit();

    const unsigned char* As = stage_ptr(sl);
    const unsigned char* Bs = As + BT * kRowBytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 32 bytes of D a step
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], As + swz(wm * 32 + mt * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8,
                                 2 * ks + (lane >> 4)));
      if (ES == 2) {
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          unsigned bf[4];
          ldsm_x4(bf, Bs + swz(wn * 64 + nt * 8 + (lane & 7) +
                                   (lane >> 4) * 8,
                               2 * ks + ((lane >> 3) & 1)));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(total[mt][nt], af[mt], bf[0], bf[1]);
            mma_bf16(total[mt][nt + 1], af[mt], bf[2], bf[3]);
          }
        }
      } else {
        unsigned abig[2][4], asmall[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(af[mt][e]), abig[mt][e],
                       asmall[mt][e]);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          unsigned bf[4], bbig[4], bsmall[4];
          ldsm_x4(bf, Bs + swz(wn * 64 + nt * 8 + (lane & 7) +
                                   (lane >> 4) * 8,
                               2 * ks + ((lane >> 3) & 1)));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(bf[e]), bbig[e], bsmall[e]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {  // n tiles nt, nt + 1
              float (&c)[4] = acc[mt][nt + p];
              if (ks == 0)
                mma_tf32(c, asmall[mt], bbig[2 * p], bbig[2 * p + 1], zero);
              else
                mma_tf32(c, asmall[mt], bbig[2 * p], bbig[2 * p + 1], c);
              mma_tf32(c, abig[mt], bsmall[2 * p], bsmall[2 * p + 1], c);
              mma_tf32(c, abig[mt], bbig[2 * p], bbig[2 * p + 1], c);
            }
          }
        }
      }
    }
    if (ES == 4) {  // fp32: flush the stage's 3xTF32 chain
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) total[mt][nt][e] += acc[mt][nt][e];
    }

    if ((sl + 1) % kst != 0) continue;
    // ---- the vocab tile is done: fold it into (m, s, gold) ----
    const int vt = sl / kst, v0 = (vt_begin + vt) * BV;
    float (*rmax)[BT] = red[vt & 1];
    float tmax[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int v = v0 + wn * 64 + nt * 8 + 2 * tq + j;
            float z = total[mt][nt][2 * h + j];
            if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
            z = v < a.V ? z : kNegInf;  // mask the columns past V
            if (v == lab[mt][h] && v < a.V) gold[mt][h] += z;
            total[mt][nt][2 * h + j] = z;
            mx = fmaxf(mx, z);
          }
        tmax[mt][h] = quad_max(mx);
        if (tq == 0) rmax[wn][wm * 32 + mt * 16 + g + 8 * h] = tmax[mt][h];
      }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        const float m_new = fmaxf(m[mt][h], fmaxf(rmax[0][r], rmax[1][r]));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            sum += expf(total[mt][nt][2 * h + j] - m_new);
        s[mt][h] = s[mt][h] * expf(m[mt][h] - m_new) + quad_sum(sum);
        m[mt][h] = m_new;
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;
  }

  // the two warps of a row: s and gold added in a fixed order
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float gq = quad_sum(gold[mt][h]);
      if (tq == 0) {
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        red[0][wn][r] = s[mt][h];
        red[1][wn][r] = gq;
      }
    }
  __syncthreads();
  if (wn != 0 || tq != 0) return;
  const long long plane = static_cast<long long>(a.splits) * a.T;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + mt * 16 + g + 8 * h, t = t0 + r;
      if (t >= a.T) continue;
      const long long o = static_cast<long long>(split) * a.T + t;
      a.ws[o] = m[mt][h];
      a.ws[plane + o] = red[0][0][r] + red[0][1][r];
      a.ws[2 * plane + o] = red[1][0][r] + red[1][1][r];
    }
}

// loss[t] from the splits' partials, combined in split order
__global__ void __launch_bounds__(256)
xent_combine_kernel(const float* __restrict__ ws, float* __restrict__ loss,
                    int T, int splits) {
  const int t = blockIdx.x * 256 + threadIdx.x;
  if (t >= T) return;
  const long long plane = (long long)splits * T;
  float m = kNegInf;
  for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, ws[(long long)sp * T + t]);
  float s = 0.f, g = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const long long o = (long long)sp * T + t;
    s += ws[plane + o] * expf(ws[o] - m);
    g += ws[2 * plane + o];
  }
  loss[t] = m + logf(fmaxf(s, 1e-30f)) - g;
}

template <int ES>
cudaError_t launch(const XentArgs& a, float* loss, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      xent_partial_kernel<ES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + BT - 1) / BT, a.splits);
  xent_partial_kernel<ES><<<grid, kThreads, kSmemBytes, st>>>(a);
  xent_combine_kernel<<<(a.T + 255) / 256, 256, 0, st>>>(a.ws, loss, a.T,
                                                         a.splits);
  return cudaGetLastError();
}

}  // namespace

// h [T, D], table [V, D] contiguous, of one dtype (bf16 != 0: bfloat16,
// else float32); labels [T] int64; ws [3, splits, T] float32; loss [T]
// float32.  Split s covers the vocab tiles [s * tiles_per_split,
// (s + 1) * tiles_per_split) of 128 rows; softcap <= 0 means none.
// Returns cudaGetLastError().
extern "C" int xent_forward(const void* h, const void* table,
                            const void* labels, void* ws, void* loss, int T,
                            int V, int D, float softcap, int tiles_per_split,
                            int splits, int bf16, void* stream) {
  if (V < 1 || D < 1 || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split * BV < V ||
      (long long)(splits - 1) * tiles_per_split * BV >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  XentArgs a;
  a.h = static_cast<const unsigned char*>(h);
  a.table = static_cast<const unsigned char*>(table);
  a.labels = static_cast<const long long*>(labels);
  a.ws = static_cast<float*>(ws);
  a.T = T; a.V = V; a.D = D;
  a.tiles_per_split = tiles_per_split;
  a.splits = splits;
  a.softcap = softcap;
  const int es = bf16 ? 2 : 4;
  a.vec = (reinterpret_cast<uintptr_t>(h) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
          (static_cast<long long>(D) * es) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(loss);
  return static_cast<int>(bf16 ? launch<2>(a, out, st)
                               : launch<4>(a, out, st));
}
