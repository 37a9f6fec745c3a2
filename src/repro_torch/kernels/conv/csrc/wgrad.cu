// K6: the conv weight gradient, dw[co, ci, dy, dx] = sum over the output
// positions p = (n, oh, ow) of g[n, co, oh, ow] * x[n, ci, oh*S - pad + dy,
// ow*S - pad + dx] (zero where the window hangs over the padding).
//
// Replaces repro/kernels/conv/backward.py::wgrad_pallas (body
// _wgrad_kernel), which accumulates the [Co, Ci, F, F] result in VMEM
// scratch over an (N, row-block) grid that the TPU walks in order.
//
// What bounds it on an H100: operations.  It is a GEMM dw[Co, K] =
// G[Co, P] . X^[P, K] with K = Ci*F*F (k = (ci, dy, dx)), a reduction over
// the P = N*Ho*Wo output positions, and X^ the virtual im2col matrix:
// 2*Co*K*P FLOPs against a few bytes per position.  fp32 FMA on the CUDA
// cores peaks at 67 TFLOP/s; the tensor cores do 495 TFLOP/s in TF32.
//
// Arithmetic: fp32 accuracy from the tensor cores by the 3xTF32 split.
// Each operand v is split into big = v rounded to TF32 (to nearest, ties
// away: what cvt.rna.tf32.f32 computes, here in two integer ops, since the
// cvt also tests for NaN) and small = v - big (exact in fp32; the tensor
// core reads its top 19 bits), and every product is a_small*b_big +
// a_big*b_small + a_big*b_big on mma.sync m16n8k8 (the small*small term is
// below fp32's rounding): three TF32 products per fp32 one.  The tensor
// cores accumulate with truncation, so a long chain of mma accumulations
// drifts; each 32-position slice is therefore accumulated from zero in the
// mma registers and then added to an fp32 register total with
// round-to-nearest adds.
//
// Operands: in both layouts the positions of one co in g, and of one tap
// in x, run along the reduction (n fastest when x is CHWN, or when g is
// CHWN and x is NCHW at a stride; else ow fastest), so G is staged as
// [co][positions] and X^ as [k][positions], both reduction-major as mma's
// .row.col wants.  X^ exists only as addresses: a per-block table of k
// offsets into x.  Every tensor is read through its four element strides,
// so each (x_layout, g_layout) pair is a stride choice.
//
// Design.  A block owns a BM (co) x BN (k) tile of dw (128 x 128, or 64
// rows where Co <= 64 and 32 or 64 columns where K <= 32 or 64) and one
// range of output positions (split-K: blocks run in parallel and in no
// order, so nothing carries over between them as the TPU grid's scratch
// does), reduced in 32-position slices through a 3-stage shared-memory
// ring.  The block's warps are specialised.  Two producer warpgroups
// only copy: a thread stages one 4-position chunk of a slice in each of
// its rows by cp.async, one 16-byte copy where the 4 positions are
// contiguous, in range and 16-byte aligned (g rows along ow or n; x rows
// at stride 1, or along n), else four 4-byte copies with zero fill for
// the padding halo and the ragged row ends (Wo = 55, 27, 13, 7; stride 2
// and 4).  Two consumer warpgroups only multiply (8 warps, each a 32 x
// BN/WN piece).  Named barriers pass each stage between them: FULL when
// its slice has landed, EMPTY when it was multiplied; a producer
// announces a slice as soon as it lands and only then refills, so the
// consumers wait for data, never for the copy instructions.  The roles
// are apart because copy instructions stall their warp behind the memory
// system: a warp that also multiplies would wait with them.  setmaxnreg
// gives the consumers 168 registers (two slices' accumulators) and the
// producers 80.  Shared rows
// are 40 floats: 16-byte aligned for the copies, and the float2 fragment
// loads (physical columns 2t, 2t+1 feed mma columns t and t+4 of A and B
// alike) are free of bank conflicts.  Each block writes its partial tile
// to a workspace [splits, Co, K]; a second launch sums the partials in
// split order, so the result is the same bit for bit on every run (no
// float atomics).  With one split the first launch writes dw itself.  The
// wrapper (backward.py::wgrad_tiling) picks the tile and the splits and
// counts the two launches as one K6 call.
//
// Storage dtypes (csrc/storage.cuh): the bf16 build (-DREPRO_VARIANT_BF16)
// defines wgrad_forward_bf16 over bf16 x and g, and runs a kernel of its
// own on the bf16 tensor cores (wgrad_bf16_kernel below, whose note says
// how); dw stays float32 in both builds, as the reference's out_shape
// (backward.py, float32 whatever the inputs), and the caller rounds it to
// w's dtype.  The float32 kernel is the 3xTF32 one above.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/mma.cuh"
#include "../../csrc/storage.cuh"
#include "conv_common.cuh"  // Strides, layout_strides

namespace {

using namespace repro::mma;
using repro::storage::bf16;
using T = REPRO_XT;  // the storage type of x and g (dw is float32)

constexpr int kConsumers = 256;     // two warpgroups: the mma
constexpr int kProducers = 256;     // two warpgroups: the copies
constexpr int kThreads = kConsumers + kProducers;
// registers of a thread of each role (setmaxnreg): 512 x 128 at launch,
// then 256 x 168 + 256 x 80 <= the block's 65536
constexpr int kConsumerRegs = 168;
constexpr int kProducerRegs = 80;
constexpr int kBP = 32;             // positions per reduction slice
constexpr int kStages = 3;          // cp.async ring depth
constexpr int kRow = kBP + 8;       // shared row stride in floats
constexpr int kNoRow = -(1 << 28);  // k past Ci*F*F: every bound check fails

template <typename E>
struct WgradArgs {
  const E* x;
  const E* g;
  float* out;     // [splits, Co, K] partials, or dw [Co, K] for one split
  int N, Ci, H, W, Co, F, S, pad, Ho, Wo, K, P;  // K = Ci*F*F, P = N*Ho*Wo
  int p_per_split;
  int n_fastest;  // position order: n fastest, else ow fastest
  int vec;        // x and g 16-byte aligned: 16-byte copies allowed
  int runs;       // bf16: x and g CHWN, n fastest, N % 8 == 0 (16-byte runs)
  repro::Strides xs, gs;
};

template <int BM, int BN>
constexpr int smem_bytes() {
  return kStages * (BM + BN) * kRow * static_cast<int>(sizeof(float));
}

// stage s of the ring: FULL (its slice landed) and EMPTY (its slice was
// multiplied) barriers; barrier 0 is __syncthreads
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + kStages + s; }

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_partial_kernel(const WgradArgs<float> a) {
  constexpr int WM = BM / 32;   // consumer warps along co, 32 rows each
  constexpr int WN = 8 / WM;    // consumer warps along k
  constexpr int WTN = BN / WN;  // k columns per consumer warp
  constexpr int NT = WTN / 8;   // m16n8 tiles per consumer warp along k
  constexpr int ROWS = BM + BN;
  constexpr int CHUNKS = kBP / 4;         // 4-position chunks of a row
  constexpr int PASS = kProducers / CHUNKS;  // rows staged at once
  constexpr int RPT = ROWS / PASS;      // rows a producer thread stages
  static_assert(WM * WN == 8 && NT >= 1 && ROWS % PASS == 0, "tile");

  extern __shared__ __align__(16) float smem[];  // [kStages][ROWS][kRow]
  __shared__ int koff[BN], kdy[BN], kdx[BN];      // x offset and tap of k

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BN, co0 = blockIdx.y * BM;
  const int p_begin = blockIdx.z * a.p_per_split;
  const int p_end = min(a.P, p_begin + a.p_per_split);
  const int nslices = (p_end - p_begin + kBP - 1) / kBP;

  for (int c = tid; c < BN; c += kThreads) {
    const int k = k0 + c;
    const int ff = a.F * a.F;
    const int ci = k / ff, r = k - ci * ff, dy = r / a.F, dx = r - dy * a.F;
    const bool ok = k < a.K;
    koff[c] = ok ? ci * a.xs.c + dy * a.xs.h + dx * a.xs.w : 0;
    kdy[c] = ok ? dy : kNoRow;
    kdx[c] = dx;
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer warpgroups: the copies of every slice ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // this thread copies chunk q (positions 4q..4q+3 of a slice) of rows
    // row0 + PASS i; rows [0, BM) are G (co), the rest X^ (k)
    const int pt = tid - kConsumers;
    const int q = pt % CHUNKS, row0 = pt / CHUNKS;
    // (n, oh, ow) of the thread's first position in the next slice
    int pn, poh, pow_;
    {
      const int p = p_begin + 4 * q;
      if (a.n_fastest) {
        pn = p % a.N;
        const int r = p / a.N;
        pow_ = r % a.Wo;
        poh = r / a.Wo;
      } else {
        pow_ = p % a.Wo;
        const int r = p / a.Wo;
        poh = r % a.Ho;
        pn = r / a.Ho;
      }
    }
    // float32: cp.async straight into the ring, kStages - 1 slices in
    // flight
    auto stage = [&](int sl) {
      const int buf = sl % kStages;
      const int pf = p_begin + sl * kBP + 4 * q;
      int n = pn, oh = poh, ow = pow_;
      int gb[4], xb[4], ih[4], iw[4];
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = pf + j < p_end;
        gb[j] = n * a.gs.n + oh * a.gs.h + ow * a.gs.w;
        ih[j] = oh * a.S - a.pad;
        iw[j] = ow * a.S - a.pad;
        xb[j] = n * a.xs.n + ih[j] * a.xs.h + iw[j] * a.xs.w;
        if (a.n_fastest) {
          if (++n == a.N) {
            n = 0;
            if (++ow == a.Wo) {
              ow = 0;
              ++oh;
            }
          }
        } else if (++ow == a.Wo) {
          ow = 0;
          if (++oh == a.Ho) {
            oh = 0;
            ++n;
          }
        }
      }
      if (a.n_fastest) {  // on to the next slice: kBP positions further
        pn += kBP;
        while (pn >= a.N) {
          pn -= a.N;
          if (++pow_ == a.Wo) {
            pow_ = 0;
            ++poh;
          }
        }
      } else {
        pow_ += kBP;
        while (pow_ >= a.Wo) {
          pow_ -= a.Wo;
          if (++poh == a.Ho) {
            poh = 0;
            ++pn;
          }
        }
      }
      const bool gcont = a.vec && ok[3] && gb[1] == gb[0] + 1 &&
                         gb[2] == gb[0] + 2 && gb[3] == gb[0] + 3;
      const bool xcont = a.vec && ok[3] && xb[1] == xb[0] + 1 &&
                         xb[2] == xb[0] + 2 && xb[3] == xb[0] + 3;
      float* base = smem + buf * ROWS * kRow + 4 * q;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + PASS * i;
        float* d = base + r * kRow;
        if (PASS * i < BM) {  // a row of G
          const int co = co0 + r;
          if (co >= a.Co) {
            cp16(d, a.g, false);
            continue;
          }
          const int co_off = co * a.gs.c;
          if (gcont && ((gb[0] + co_off) & 3) == 0) {
            cp16(d, a.g + gb[0] + co_off, true);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cp4(d + j, ok[j] ? a.g + gb[j] + co_off : a.g, ok[j]);
          }
        } else {  // a row of X^
          const int c = r - BM;
          const int dy = kdy[c], dx = kdx[c], ko = koff[c];
          bool v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = ok[j] &&
                   static_cast<unsigned>(ih[j] + dy) <
                       static_cast<unsigned>(a.H) &&
                   static_cast<unsigned>(iw[j] + dx) <
                       static_cast<unsigned>(a.W);
          if (xcont && v[0] && v[1] && v[2] && v[3] &&
              ((xb[0] + ko) & 3) == 0) {
            cp16(d, a.x + xb[0] + ko, true);
          } else if (!(v[0] || v[1] || v[2] || v[3])) {
            cp16(d, a.x, false);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cp4(d + j, v[j] ? a.x + xb[j] + ko : a.x, v[j]);
          }
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nslices) stage(s);
      cp_commit();
    }
    for (int sl = 0; sl < nslices; ++sl) {
      cp_wait<kStages - 2>();  // slice sl has landed: announce it
      bar_arrive(full_bar(sl % kStages), kThreads);
      // refill the stage of slice sl - 1 once the consumers are done with it
      const int nx = sl + kStages - 1;
      if (nx < nslices) {
        if (nx >= kStages) bar_sync(empty_bar(nx % kStages), kThreads);
        stage(nx);
      }
      cp_commit();
    }
    return;
  }

  // ---- the consumer warpgroups: the products ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma group, thread in group
  const int wm = warp % WM, wn = warp / WM;
  float total[2][NT][4];  // fp32 sums over the slices
  float acc[2][NT][4];    // one slice's products, in the mma accumulators
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  for (int sl = 0; sl < nslices; ++sl) {
    const int buf = sl % kStages;
    bar_sync(full_bar(buf), kThreads);
    const float* As = smem + buf * ROWS * kRow;
    const float* Bs = As + BM * kRow;
#pragma unroll
    for (int kk = 0; kk < kBP; kk += 8) {
      unsigned abig[2][4], asmall[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* pa = As + (wm * 32 + mt * 16 + gq) * kRow + kk + 2 * tq;
        const float2 lo = *reinterpret_cast<const float2*>(pa);
        const float2 hi = *reinterpret_cast<const float2*>(pa + 8 * kRow);
        // a0 (row g, col t), a1 (row g+8, col t), a2 (row g, col t+4),
        // a3 (row g+8, col t+4): col t is physical 2t, col t+4 is 2t+1
        split_tf32(lo.x, abig[mt][0], asmall[mt][0]);
        split_tf32(hi.x, abig[mt][1], asmall[mt][1]);
        split_tf32(lo.y, abig[mt][2], asmall[mt][2]);
        split_tf32(hi.y, abig[mt][3], asmall[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
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
    // the stage is free for the producer (it waits only for the stages it
    // refills, so the last kStages slices announce nothing)
    if (sl + kStages < nslices) bar_arrive(empty_bar(buf), kThreads);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][nt][e] += acc[mt][nt][e];
  }

  float* out = a.out + static_cast<long long>(blockIdx.z) * a.Co * a.K;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = k0 + wn * WTN + nt * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // c0 (row g, col 2t), c1 (row g, 2t+1), c2 (row g+8, 2t), c3 (g+8)
        const int co = co0 + wm * 32 + mt * 16 + gq + (e >= 2 ? 8 : 0);
        const int k = col + (e & 1);
        if (co < a.Co && k < a.K)
          out[static_cast<long long>(co) * a.K + k] = total[mt][nt][e];
      }
    }
  }
}

// dw[i] = sum of the split partials in split order
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                    int splits, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[(long long)sp * n + i];
  dw[i] = s;
}

// ---- the bf16 build: one bf16 product a term ------------------------------
//
// Instantiated only by the bf16 build (launch_partial below).  The tile,
// the split-K partials and their sum in split order, the warp roles and
// the named barriers are the float32 kernel's; the ring and the products
// differ.
//
// What bounds it: operations by design, at the bf16 tensor cores' 989
// TFLOP/s: a product of two bf16 values is exact in fp32, so a term is ONE
// m16n8k16 bf16 product (the float32 kernel's 3xTF32 takes three TF32
// m16n8k8 ones at half the rate and half the depth), and a 32-position
// slice is two k16 steps.  On the card the copies bound it instead, and
// then mma.sync's own rate: timed apart (tools/storage_variants.py
// --timing-only), on VGG16's CHWN launches producers that copy alone and
// consumers that multiply alone take about the same time, and the
// consumers run near mma.sync's rate (wgmma is the next step); on
// ResNet-18's NCHW launches the producers take over twice the consumers'.
//
// Design.  G [co][positions] and X^ [k][positions] are both
// reduction-major, so each is K-major in its mma role and plain ldmatrix
// forms the m16n8k16 A (G) and B (X^) fragments.  A stage holds a 32-deep
// slice of both as bf16 rows of 64 bytes, their four 16-byte chunks
// XOR-swizzled by (row / 2) mod 4 (mma::swz32, wgmma's 64-byte swizzle),
// so ldmatrix reads without bank conflicts; the ring has 4 stages (of 6
// and 7 timed, 4 was fastest).  The producers run one of two paths, each
// its own instantiation, so neither holds the other's registers:
//   RUNS (x and g CHWN, n fastest, N % 8 == 0: VGG16's bf16 plan): every
//     8-position chunk is a run of n, whole, in range or not, 16-byte
//     aligned; a thread copies one chunk of each of its rows by 16-byte
//     cp.async straight into the ring, each row's offset and tap found
//     once per block, so a slice costs a few adds a row;
//   otherwise (NCHW operands, ResNet-18's plan; strided gathers; the
//     halo; Wo = 55, 28, 14, 7; stride 2): a thread loads a 4-position
//     chunk of each of its rows as halfwords with zero fill, one slice
//     ahead into registers, and stores it when the consumers free the
//     stage, so the loads fly while it waits.  Every load is issued
//     before any is used, predicated, with no branch between them: an
//     8-byte load where aligned, chosen by a branch per row, made each
//     row's loads wait for the row before, and ran 1.4x slower; so did
//     aligned words funnel-shifted (lanes diverge over three cases).
// The producers take 88 registers (the rest of the block's beside the
// consumers' 168).  The consumers sum each slice from zero in the mma
// registers (two k16 steps) and add it to fp32 registers, as the float32
// kernel does.  Positions run n fastest where x or g is CHWN (a run of n
// in each CHWN operand), else ow fastest.
constexpr int kNBP = 32;      // positions per slice: two k16 steps
constexpr int kNStages = 4;   // ring depth
// the producers' registers: the rest of the block's 65536 beside the
// consumers' 168 (the element path holds a slice's loads in flight)
constexpr int kNProducerRegs = 88;

template <int BM, int BN>
constexpr int bf16_smem_bytes() {
  return kNStages * (BM + BN) * kNBP * static_cast<int>(sizeof(bf16));
}
static_assert(bf16_smem_bytes<128, 128>() <= 232448,
              "the bf16 ring fits a block's shared memory at every tile");

// the bf16 ring's FULL and EMPTY barriers of stage s
__device__ __forceinline__ int nfull_bar(int s) { return 1 + s; }
__device__ __forceinline__ int nempty_bar(int s) {
  return 1 + kNStages + s;
}

template <int BM, int BN, bool RUNS>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_bf16_kernel(const WgradArgs<bf16> a) {
  constexpr int WM = BM / 32;   // consumer warps along co, 32 rows each
  constexpr int WN = 8 / WM;    // consumer warps along k
  constexpr int WTN = BN / WN;  // k columns per consumer warp
  constexpr int NT = WTN / 8;   // m16n8 tiles per consumer warp along k
  constexpr int ROWS = BM + BN;
  constexpr int KS = kNBP / 16;            // k16 steps of a slice
  static_assert(WM * WN == 8 && NT >= 1 && BM % 64 == 0 && ROWS % 32 == 0,
                "tile");

  extern __shared__ __align__(128) unsigned char wg_smem[];
  // [kNStages][ROWS][kNBP] bf16 bits: rows [0, BM) G, the rest X^
  unsigned short* ring = reinterpret_cast<unsigned short*>(wg_smem);
  __shared__ int koff[BN], kdy[BN], kdx[BN];  // x offset and tap of k

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BN, co0 = blockIdx.y * BM;
  const int p_begin = blockIdx.z * a.p_per_split;
  const int p_end = min(a.P, p_begin + a.p_per_split);
  const int nslices = (p_end - p_begin + kNBP - 1) / kNBP;

  for (int c = tid; c < BN; c += kThreads) {
    const int k = k0 + c;
    const int ff = a.F * a.F;
    const int ci = k / ff, r = k - ci * ff, dy = r / a.F, dx = r - dy * a.F;
    const bool ok = k < a.K;
    koff[c] = ok ? ci * a.xs.c + dy * a.xs.h + dx * a.xs.w : 0;
    kdy[c] = ok ? dy : kNoRow;
    kdx[c] = dx;
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer warpgroups: the copies of every slice ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kNProducerRegs));
    const int pt = tid - kConsumers;
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(a.x);
    const unsigned short* gb = reinterpret_cast<const unsigned short*>(a.g);
    // (n, oh, ow) of position p, and on by kNBP positions in the walk order
    auto decode = [&](int p, int& n, int& oh, int& ow) {
      if (a.n_fastest) {
        n = p % a.N;
        const int r = p / a.N;
        ow = r % a.Wo;
        oh = r / a.Wo;
      } else {
        ow = p % a.Wo;
        const int r = p / a.Wo;
        oh = r % a.Ho;
        n = r / a.Ho;
      }
    };
    auto advance = [&](int& n, int& oh, int& ow) {
      if (a.n_fastest) {
        n += kNBP;
        while (n >= a.N) {
          n -= a.N;
          if (++ow == a.Wo) {
            ow = 0;
            ++oh;
          }
        }
      } else {
        ow += kNBP;
        while (ow >= a.Wo) {
          ow -= a.Wo;
          if (++oh == a.Ho) {
            oh = 0;
            ++n;
          }
        }
      }
    };
    if constexpr (RUNS) {
      // x and g CHWN, n fastest, N % 8 == 0: every 8-position chunk is a
      // run of n, whole, in range or not, 16-byte aligned.  The thread
      // copies chunk q of rows row0 + 64 i by cp.async straight into the
      // ring, each row's offset found once
      constexpr int RR = (ROWS + 63) / 64;  // rows of this thread
      const int q = pt & 3, row0 = pt >> 2;
      int base[RR], rdy[RR], rdx[RR];  // a row's offset, its tap (X^)
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const int r = min(row0 + 64 * i, ROWS - 1);
        if (r < BM) {
          const int co = co0 + r;
          base[i] = co < a.Co ? co * a.gs.c : -1;
          rdy[i] = rdx[i] = 0;
        } else {
          base[i] = koff[r - BM];
          rdy[i] = kdy[r - BM];
          rdx[i] = kdx[r - BM];
        }
      }
      int n, oh, ow;  // the chunk's first position in the next slice
      decode(p_begin + 8 * q, n, oh, ow);
      auto stage = [&](int sl) {
        unsigned short* st = ring + (sl % kNStages) * ROWS * kNBP;
        const bool pok = p_begin + sl * kNBP + 8 * q < p_end;
        const int g0 = n * a.gs.n + oh * a.gs.h + ow * a.gs.w;
        const int ih0 = oh * a.S - a.pad, iw0 = ow * a.S - a.pad;
        const int x0 = n * a.xs.n + ih0 * a.xs.h + iw0 * a.xs.w;
        advance(n, oh, ow);
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          const int r = row0 + 64 * i;
          if (r >= ROWS) break;  // BN 32: the last 64 rows are 32
          unsigned short* d = st + swz32(r, q);
          if (64 * i < BM) {  // a row of G (BM is a multiple of 64)
            const bool ok = pok && base[i] >= 0;
            cp16(d, ok ? gb + g0 + base[i] : gb, ok);
          } else {
            const bool ok = pok &&
                            static_cast<unsigned>(ih0 + rdy[i]) <
                                static_cast<unsigned>(a.H) &&
                            static_cast<unsigned>(iw0 + rdx[i]) <
                                static_cast<unsigned>(a.W);
            cp16(d, ok ? xb + x0 + base[i] : xb, ok);
          }
        }
      };
#pragma unroll
      for (int s = 0; s < kNStages - 1; ++s) {
        if (s < nslices) stage(s);
        cp_commit();
      }
      for (int sl = 0; sl < nslices; ++sl) {
        cp_wait<kNStages - 2>();  // slice sl has landed: announce it
        bar_arrive(nfull_bar(sl % kNStages), kThreads);
        const int nx = sl + kNStages - 1;
        if (nx < nslices) {
          if (nx >= kNStages) bar_sync(nempty_bar(nx % kNStages), kThreads);
          stage(nx);
        }
        cp_commit();
      }
    } else {
      // anything else: the thread stages chunk q (positions 4q .. 4q + 3
      // of a slice) of rows row0 + 32 i, loaded one slice ahead into
      // registers as raw bits (one 8-byte load where the 4 are contiguous,
      // in range and 8-byte aligned, else element by element with zero
      // fill: the halo, ragged rows, strided gathers) and stored when the
      // consumers free the stage, so the loads fly while it waits
      constexpr int RE = ROWS / 32;  // rows of this thread
      const int q = pt & 7, row0 = pt >> 3;
      int pn, poh, pow_;  // the chunk's first position in the next slice
      decode(p_begin + 4 * q, pn, poh, pow_);
      uint2 raw[RE];
      auto fetch = [&](int sl) {
        const int nvalid = min(4, p_end - (p_begin + sl * kNBP + 4 * q));
        int gpos[4], ih[4], iw[4], xpos[4];
        {
          int n = pn, oh = poh, ow = pow_;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            gpos[j] = n * a.gs.n + oh * a.gs.h + ow * a.gs.w;
            ih[j] = oh * a.S - a.pad;
            iw[j] = ow * a.S - a.pad;
            xpos[j] = n * a.xs.n + ih[j] * a.xs.h + iw[j] * a.xs.w;
            if (a.n_fastest) {
              if (++n == a.N) {
                n = 0;
                if (++ow == a.Wo) {
                  ow = 0;
                  ++oh;
                }
              }
            } else if (++ow == a.Wo) {
              ow = 0;
              if (++oh == a.Ho) {
                oh = 0;
                ++n;
              }
            }
          }
        }
        advance(pn, poh, pow_);
        // every load first, predicated, no branch between them (a branch
        // would make each row's loads wait for the row before), then the
        // packing
        unsigned e[RE][4];
#pragma unroll
        for (int i = 0; i < RE; ++i) {
          const int r = row0 + 32 * i;
          if (32 * i < BM) {  // a row of G (BM is a multiple of 32)
            const int co = co0 + r;
            const int cof = co * a.gs.c;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              e[i][j] = co < a.Co && j < nvalid ? __ldg(gb + gpos[j] + cof)
                                                : 0u;
          } else {  // a row of X^
            const int c = r - BM;
            const int dy = kdy[c], dx = kdx[c], ko = koff[c];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              e[i][j] = j < nvalid &&
                                static_cast<unsigned>(ih[j] + dy) <
                                    static_cast<unsigned>(a.H) &&
                                static_cast<unsigned>(iw[j] + dx) <
                                    static_cast<unsigned>(a.W)
                            ? __ldg(xb + xpos[j] + ko)
                            : 0u;
          }
        }
#pragma unroll
        for (int i = 0; i < RE; ++i)
          raw[i] = make_uint2(e[i][0] | (e[i][1] << 16),
                              e[i][2] | (e[i][3] << 16));
      };
      // the fetched slice into stage buf: a 4-position chunk is half of a
      // 16-byte ring chunk
      auto store = [&](int buf) {
        unsigned short* st = ring + buf * ROWS * kNBP;
#pragma unroll
        for (int i = 0; i < RE; ++i)
          *reinterpret_cast<uint2*>(st + swz32(row0 + 32 * i, q >> 1) +
                                    4 * (q & 1)) = raw[i];
      };
      if (nslices > 0) fetch(0);
#pragma unroll
      for (int s = 0; s < kNStages - 1; ++s) {
        if (s < nslices) {
          store(s);
          if (s + 1 < nslices) fetch(s + 1);
        }
      }
      for (int sl = 0; sl < nslices; ++sl) {
        bar_arrive(nfull_bar(sl % kNStages), kThreads);  // slice sl stored
        const int nx = sl + kNStages - 1;
        if (nx < nslices) {
          if (nx >= kNStages) bar_sync(nempty_bar(nx % kNStages), kThreads);
          store(nx % kNStages);
          if (nx + 1 < nslices) fetch(nx + 1);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: the products ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma group, thread in group
  const int wm = warp % WM, wn = warp / WM;
  constexpr int NB = NT >= 2 ? NT / 2 : 1;  // B ldmatrix loads a k16 step
  int aoff[KS][2], boff[KS][NB];  // this lane's swizzled ldmatrix offsets
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      aoff[ks][mt] = swz32(wm * 32 + mt * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8,
                           2 * ks + (lane >> 4));
#pragma unroll
    for (int np = 0; np < NB; ++np)
      boff[ks][np] = swz32(BM + wn * WTN + np * 16 + (lane & 7) +
                               (NT >= 2 ? (lane >> 4) * 8 : 0),
                           2 * ks + ((lane >> 3) & 1));
  }
  float total[2][NT][4];  // fp32 sums over the slices
  float acc[2][NT][4];    // one slice's products, in the mma accumulators
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;

  for (int sl = 0; sl < nslices; ++sl) {
    const int buf = sl % kNStages;
    bar_sync(nfull_bar(buf), kThreads);
    const unsigned short* st = ring + buf * ROWS * kNBP;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], st + aoff[ks][mt]);
      if constexpr (NT >= 2) {
#pragma unroll
        for (int np = 0; np < NB; ++np) {
          unsigned bq[4];
          ldsm_x4(bq, st + boff[ks][np]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (ks == 0) {
              mma_bf16_z(acc[mt][2 * np], af[mt], bq[0], bq[1]);
              mma_bf16_z(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
            } else {
              mma_bf16(acc[mt][2 * np], af[mt], bq[0], bq[1]);
              mma_bf16(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
            }
          }
        }
      } else {
        unsigned bq[2];
        ldsm_x2(bq, st + boff[ks][0]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (ks == 0)
            mma_bf16_z(acc[mt][0], af[mt], bq[0], bq[1]);
          else
            mma_bf16(acc[mt][0], af[mt], bq[0], bq[1]);
        }
      }
    }
    // the stage is free for the producer (it waits only for the stages it
    // refills, so the last kNStages slices announce nothing)
    if (sl + kNStages < nslices) bar_arrive(nempty_bar(buf), kThreads);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][nt][e] += acc[mt][nt][e];
  }

  float* out = a.out + static_cast<long long>(blockIdx.z) * a.Co * a.K;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = k0 + wn * WTN + nt * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // c0 (row g, col 2t), c1 (row g, 2t+1), c2 (row g+8, 2t), c3 (g+8)
        const int co = co0 + wm * 32 + mt * 16 + gq + (e >= 2 ? 8 : 0);
        const int k = col + (e & 1);
        if (co < a.Co && k < a.K)
          out[static_cast<long long>(co) * a.K + k] = total[mt][nt][e];
      }
    }
  }
}

// the float32 build's 3xTF32 kernel, or the bf16 build's own
template <int BM, int BN>
cudaError_t launch_partial(const WgradArgs<T>& a, int splits,
                           cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int smem =
      kBf16 ? bf16_smem_bytes<BM, BN>() : smem_bytes<BM, BN>();
  void (*kernel)(const WgradArgs<T>);
  if constexpr (kBf16)
    kernel = a.runs ? wgrad_bf16_kernel<BM, BN, true>
                    : wgrad_bf16_kernel<BM, BN, false>;
  else
    kernel = wgrad_partial_kernel<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.K + BN - 1) / BN, (a.Co + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bn(const WgradArgs<T>& a, int bn, int splits,
                      cudaStream_t st) {
  switch (bn) {
    case 32: return launch_partial<BM, 32>(a, splits, st);
    case 64: return launch_partial<BM, 64>(a, splits, st);
    case 128: return launch_partial<BM, 128>(a, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [N,Ci,H,W] (x_nchw) or [Ci,H,W,N]; g [N,Co,Ho,Wo] (g_nchw) or
// [Co,Ho,Wo,N], both REPRO_XT (float32, or bf16 in the bf16 build); dw
// float32 [Co, Ci*F*F] (canonical [Co,Ci,F,F]); ws float32 [splits, Co,
// Ci*F*F] when splits > 1 (else unused).  The block tile is bm x bn (bm 64
// or 128, bn 32, 64 or 128); split s reduces the output positions
// [s * p_per_split, (s + 1) * p_per_split), p_per_split a multiple of 32.
// Returns cudaGetLastError().
extern "C" int REPRO_ENTRY(wgrad_forward)(
    const void* x, const void* g, void* ws, void* dw, int N, int Ci, int H,
    int W, int Co, int F, int S, int pad, int x_nchw, int g_nchw, int bm,
    int bn, int p_per_split, int splits, void* stream) {
  WgradArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.g = static_cast<const T*>(g);
  a.out = static_cast<float*>(splits > 1 ? ws : dw);
  a.N = N; a.Ci = Ci; a.H = H; a.W = W; a.Co = Co; a.F = F; a.S = S;
  a.pad = pad;
  a.Ho = (H + 2 * pad - F) / S + 1;
  a.Wo = (W + 2 * pad - F) / S + 1;
  a.K = Ci * F * F;
  a.P = N * a.Ho * a.Wo;
  a.p_per_split = p_per_split;
  // n fastest where x is CHWN, and where g is CHWN and x's rows are
  // strided: then g's rows copy by 16 bytes (x's take 4 either way).  The
  // bf16 build: wherever either is CHWN (a 16-byte run is 8 positions, so
  // a run of ow in x at stride 1 is aligned for one tap in eight at best)
  a.n_fastest = std::is_same<T, bf16>::value ? !x_nchw || !g_nchw
                                             : !x_nchw || (!g_nchw && S > 1);
  a.vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  a.xs = repro::layout_strides(x_nchw, N, Ci, H, W);
  a.gs = repro::layout_strides(g_nchw, N, Co, a.Ho, a.Wo);
  a.runs = a.vec && !x_nchw && !g_nchw && N % 8 == 0;
  if (a.K <= 0 || Co <= 0 || a.P <= 0 || splits < 1 || p_per_split < kBP ||
      p_per_split % kBP != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bm == 64)
    e = launch_bn<64>(a, bn, splits, st);
  else if (bm == 128)
    e = launch_bn<128>(a, bn, splits, st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits > 1) {
    const int n = Co * a.K;
    wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<float*>(dw), splits, n);
  }
  return static_cast<int>(cudaGetLastError());
}
