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
// defines wgrad_forward_bf16 over bf16 x and g; dw stays float32 in both
// builds, as the reference's out_shape (backward.py, float32 whatever the
// inputs), and the caller rounds it to w's dtype.  No cp.async widens, so
// the producers load a bf16 slice into registers as raw bits (one 8-byte
// load for 4 contiguous aligned positions, else element by element), one
// slice ahead of the stage it fills, and widen and store it when the
// consumers free that stage: the loads fly while the producer waits, as
// cp.async's do in float32.  A bf16 value is exact in
// TF32 and a product of two of them exact in float32, so the bf16 build
// runs ONE TF32 product a term (big * big; both small parts are zero), on
// the same 32-position chains flushed into float32 registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma.cuh"
#include "../../csrc/storage.cuh"
#include "conv_common.cuh"  // Strides, layout_strides

namespace {

using namespace repro::mma;
using repro::storage::kExactTf32;
using repro::storage::split;
#ifdef REPRO_VARIANT
using repro::storage::load_raw4;
using repro::storage::pack_raw4;
using repro::storage::raw1;
using repro::storage::widen4;
#endif
using T = REPRO_XT;  // the storage type of x and g (dw is float32)
constexpr bool kExact = kExactTf32<T>;  // one TF32 product a term

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

struct WgradArgs {
  const T* x;
  const T* g;
  float* out;     // [splits, Co, K] partials, or dw [Co, K] for one split
  int N, Ci, H, W, Co, F, S, pad, Ho, Wo, K, P;  // K = Ci*F*F, P = N*Ho*Wo
  int p_per_split;
  int n_fastest;  // position order: n fastest, else ow fastest
  int vec;        // x and g 16-byte aligned: 16-byte copies allowed
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
wgrad_partial_kernel(const WgradArgs a) {
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
#ifndef REPRO_VARIANT
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
#else
    // the thread's 4 positions of slice sl (called for sl = 0, 1, ... in
    // turn: it steps (pn, poh, pow_) on to the next slice) and whether
    // they run contiguously in g and in x
    struct Pos {
      int gb[4], xb[4], ih[4], iw[4];
      bool ok[4], gcont, xcont;
    };
    auto positions = [&](int sl) {
      Pos P;
      const int pf = p_begin + sl * kBP + 4 * q;
      int n = pn, oh = poh, ow = pow_;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        P.ok[j] = pf + j < p_end;
        P.gb[j] = n * a.gs.n + oh * a.gs.h + ow * a.gs.w;
        P.ih[j] = oh * a.S - a.pad;
        P.iw[j] = ow * a.S - a.pad;
        P.xb[j] = n * a.xs.n + P.ih[j] * a.xs.h + P.iw[j] * a.xs.w;
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
      P.gcont = a.vec && P.ok[3] && P.gb[1] == P.gb[0] + 1 &&
                P.gb[2] == P.gb[0] + 2 && P.gb[3] == P.gb[0] + 3;
      P.xcont = a.vec && P.ok[3] && P.xb[1] == P.xb[0] + 1 &&
                P.xb[2] == P.xb[0] + 2 && P.xb[3] == P.xb[0] + 3;
      return P;
    };
    // the sources of the thread's chunk in each of its RPT rows: quad(i,
    // src, ok) where the 4 elements are contiguous and aligned (or all
    // zero: ok false), else each(i, j, src, ok) element by element
    auto rows = [&](const Pos& P, auto&& quad, auto&& each) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + PASS * i;
        if (PASS * i < BM) {  // a row of G
          const int co = co0 + r;
          if (co >= a.Co) {
            quad(i, a.g, false);
            continue;
          }
          const int co_off = co * a.gs.c;
          if (P.gcont && ((P.gb[0] + co_off) & 3) == 0) {
            quad(i, a.g + P.gb[0] + co_off, true);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              each(i, j, P.ok[j] ? a.g + P.gb[j] + co_off : a.g, P.ok[j]);
          }
        } else {  // a row of X^
          const int c = r - BM;
          const int dy = kdy[c], dx = kdx[c], ko = koff[c];
          bool v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = P.ok[j] &&
                   static_cast<unsigned>(P.ih[j] + dy) <
                       static_cast<unsigned>(a.H) &&
                   static_cast<unsigned>(P.iw[j] + dx) <
                       static_cast<unsigned>(a.W);
          if (P.xcont && v[0] && v[1] && v[2] && v[3] &&
              ((P.xb[0] + ko) & 3) == 0) {
            quad(i, a.x + P.xb[0] + ko, true);
          } else if (!(v[0] || v[1] || v[2] || v[3])) {
            quad(i, a.x, false);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              each(i, j, v[j] ? a.x + P.xb[j] + ko : a.x, v[j]);
          }
        }
      }
    };
    // row i of the thread's chunk in stage buf
    auto dst = [&](int buf, int i) {
      return smem + (buf * ROWS + row0 + PASS * i) * kRow + 4 * q;
    };
    {
      // bf16: no cp.async widens, so a slice's loads go to registers as raw
      // bits, issued one slice ahead: they are in flight while the
      // producer waits for the stage they will fill, then widened and
      // stored
      using Raw = repro::storage::Raw4<T>;
      Raw raw[RPT];
      auto fetch = [&](int sl) {
        rows(positions(sl),
             [&](int i, const T* src, bool ok) {
               if (ok)
                 load_raw4(raw[i], src);
               else
                 pack_raw4(raw[i], 0u, 0u, 0u, 0u);
             },
             [&](int i, int j, const T* src, bool ok) {
               // the 4 elements of row i arrive as j = 0, 1, 2, 3
               const unsigned e = raw1(src, ok);
               if (j == 0) pack_raw4(raw[i], e, 0u, 0u, 0u);
               else if (j == 1) raw[i].b.x |= e << 16;
               else if (j == 2) raw[i].b.y = e;
               else raw[i].b.y |= e << 16;
             });
      };
      auto store = [&](int buf) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          *reinterpret_cast<float4*>(dst(buf, i)) = widen4(raw[i]);
      };
      if (nslices > 0) fetch(0);
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nslices) {
          store(s);
          if (s + 1 < nslices) fetch(s + 1);
        }
      }
      for (int sl = 0; sl < nslices; ++sl) {
        bar_arrive(full_bar(sl % kStages), kThreads);  // slice sl stored
        const int nx = sl + kStages - 1;
        if (nx < nslices) {
          if (nx >= kStages) bar_sync(empty_bar(nx % kStages), kThreads);
          store(nx % kStages);
          if (nx + 1 < nslices) fetch(nx + 1);
        }
      }
    }
#endif
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
        split<kExact>(lo.x, abig[mt][0], asmall[mt][0]);
        split<kExact>(hi.x, abig[mt][1], asmall[mt][1]);
        split<kExact>(lo.y, abig[mt][2], asmall[mt][2]);
        split<kExact>(hi.y, abig[mt][3], asmall[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(
            Bs + (wn * WTN + nt * 8 + gq) * kRow + kk + 2 * tq);
        unsigned b0big, b0small, b1big, b1small;
        split<kExact>(bv.x, b0big, b0small);
        split<kExact>(bv.y, b1big, b1small);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (kExact) {  // big * big is the whole product
            if (kk == 0)
              mma_tf32(acc[mt][nt], abig[mt], b0big, b1big, zero);
            else
              mma_tf32(acc[mt][nt], abig[mt], b0big, b1big, acc[mt][nt]);
          } else {
            if (kk == 0)
              mma_tf32(acc[mt][nt], asmall[mt], b0big, b1big, zero);
            else
              mma_tf32(acc[mt][nt], asmall[mt], b0big, b1big, acc[mt][nt]);
            mma_tf32(acc[mt][nt], abig[mt], b0small, b1small, acc[mt][nt]);
            mma_tf32(acc[mt][nt], abig[mt], b0big, b1big, acc[mt][nt]);
          }
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

template <int BM, int BN>
cudaError_t launch_partial(const WgradArgs& a, int splits, cudaStream_t st) {
  constexpr int smem = smem_bytes<BM, BN>();
  const cudaError_t e = cudaFuncSetAttribute(
      wgrad_partial_kernel<BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.K + BN - 1) / BN, (a.Co + BM - 1) / BM, splits);
  wgrad_partial_kernel<BM, BN><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bn(const WgradArgs& a, int bn, int splits,
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
  WgradArgs a;
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
  // strided: then g's rows copy by 16 bytes (x's take 4 either way)
  a.n_fastest = !x_nchw || (!g_nchw && S > 1);
  a.vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  a.xs = repro::layout_strides(x_nchw, N, Ci, H, W);
  a.gs = repro::layout_strides(g_nchw, N, Co, a.Ho, a.Wo);
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
