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
// head at 4096 tokens).  Design: the logits tile is one 128-token x
// 128-vocab tile of the fp32 GEMM that K10 runs (gemm_tile.cuh), with
// tableᵀ read through its strides.  Blocks run in parallel and in no order,
// so the vocab axis is split: block (t tile, split) walks its contiguous
// range of vocab tiles and keeps the running (m, s, gold) of its 128 rows
// in registers, each row's tile max, exp-sum and gold logit reduced across
// the 16 threads that share the row with warp shuffles (xor butterflies,
// so the 16 copies agree bit for bit).  It writes its partial triple to a
// workspace [3, splits, T]; a second launch combines each token's partials
// in split order (max, rescaled sum, gold sum) and writes the loss.  Two
// runs are the same bit for bit (no atomics), and even a token count of
// 1024 (gemma2-27b's case, 8 token tiles) fills the 132 SMs many times
// over.  The wrapper counts the two launches as one K12 call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "../../csrc/gemm_tile.cuh"

namespace {

using namespace repro::gemm;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

template <typename E>
struct XentArgs {
  Operand<E> h;       // rows t
  Operand<E> table;   // columns v (tableᵀ)
  const long long* labels;
  float* ws;          // [3, splits, T]: m, s, gold
  int T, V, D;
  int tiles_per_split, splits;
  float softcap;      // <= 0: none
};

// xor butterfly over the 16 threads of a half warp that share a row
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
xent_partial_kernel(const XentArgs<E> a) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int nvt = (a.V + BN - 1) / BN;
  const int vt_begin = split * a.tiles_per_split;
  const int vt_end = min(nvt, vt_begin + a.tiles_per_split);

  float m[8], s[8], g[8];
  long long lab[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    s[i] = 0.f;
    g[i] = 0.f;
    const int t = t0 + row_of(ty, i);
    lab[i] = t < a.T ? a.labels[t] : -1;
  }

  float z[8][8];
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * BN;
    tile<E, true, true>(a.h, a.table, a.D, t0, v0, z);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float zmax = kNegInf, gold = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int v = v0 + col_of(tx, j);
        float zz = z[i][j];
        if (a.softcap > 0.f) zz = a.softcap * tanhf(zz / a.softcap);
        zz = v < a.V ? zz : kNegInf;  // mask the columns past V
        if (v == lab[i] && v < a.V) gold = zz;
        z[i][j] = zz;
        zmax = fmaxf(zmax, zz);
      }
      const float m_new = fmaxf(m[i], half_max(zmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(z[i][j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + half_sum(sum);
      g[i] += half_sum(gold);
      m[i] = m_new;
    }
  }

  if (tx != 0) return;
  const long long plane = (long long)a.splits * a.T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + row_of(ty, i);
    if (t >= a.T) continue;
    const long long o = (long long)split * a.T + t;
    a.ws[o] = m[i];
    a.ws[plane + o] = s[i];
    a.ws[2 * plane + o] = g[i];
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

template <typename E>
int launch(const void* h, const void* table, const long long* labels,
           float* ws, float* loss, int Tn, int V, int D, float softcap,
           int tiles_per_split, int splits, cudaStream_t st) {
  XentArgs<E> a;
  a.h = Operand<E>{static_cast<const E*>(h), D, 1, Tn};
  a.table = Operand<E>{static_cast<const E*>(table), D, 1, V};
  a.labels = labels;
  a.ws = ws;
  a.T = Tn; a.V = V; a.D = D;
  a.tiles_per_split = tiles_per_split;
  a.splits = splits;
  a.softcap = softcap;
  const dim3 grid((Tn + BM - 1) / BM, splits);
  xent_partial_kernel<E><<<grid, kThreads, 0, st>>>(a);
  xent_combine_kernel<<<(Tn + 255) / 256, 256, 0, st>>>(ws, loss, Tn,
                                                         splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h [T, D], table [V, D] contiguous, of one dtype (bf16 != 0: bfloat16,
// else float32); labels [T] int64; ws [3, splits, T] float32; loss [T]
// float32.  Split s covers the vocab tiles [s * tiles_per_split,
// (s + 1) * tiles_per_split) of 128 columns; softcap <= 0 means none.
// Returns cudaGetLastError().
extern "C" int xent_forward(const void* h, const void* table,
                            const void* labels, void* ws, void* loss, int T,
                            int V, int D, float softcap, int tiles_per_split,
                            int splits, int bf16, void* stream) {
  if (V < 1 || D < 1 || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split * BN < V)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* lab = static_cast<const long long*>(labels);
  float* w = static_cast<float*>(ws);
  float* out = static_cast<float*>(loss);
  if (bf16)
    return launch<__nv_bfloat16>(h, table, lab, w, out, T, V, D, softcap,
                                 tiles_per_split, splits, st);
  return launch<float>(h, table, lab, w, out, T, V, D, softcap,
                       tiles_per_split, splits, st);
}
