// K5b: the conv -> conv stack on the per-sample NCHW engine, in one kernel.
//
// Replaces repro/kernels/conv/stack.py::conv_stack_nchw_pallas (body
// _stack_nchw_kernel): the same function as K5a (conv1 [+bias1] [+ReLU] ->
// conv2 with the bias/residual/ReLU/pool epilogue, the mid activation kept
// on chip) with canonical weights w1 [Cm,Ci,F1,F1], w2 [Co,Cm,F2,F2].  x is
// [N,Ci,H,W] or [Ci,H,W,N]; y is [N,Co,Ho',Wo'] or [Co,Ho',Wo',N]; the
// residual is read in its own layout (ResNet-18's CHWN skip from a K1
// projection folds into this NCHW stack).  Mid positions outside [0, Ho1)
// x [0, Wo1) are conv2's zero padding: never computed, read as 0.
//
// What bounds it on an H100: operations.  VGG16's three stacks and
// ResNet-18's five do 2*(Cm*K1 + Co*K2) FLOPs a conv2 output (K1 = Ci*F1^2,
// K2 = Cm*F2^2) against a few bytes; the mid tensor (411 MB for VGG16
// conv1_1 at batch 32) is what the stack keeps out of device memory.  fp32
// FMA on the CUDA cores peaks at 67 TFLOP/s, the TF32 tensor cores at 495.
//
// Arithmetic: fp32 accuracy from the tensor cores by the 3xTF32 split of
// K6 (csrc/mma.cuh), in both implicit GEMMs; each chain of at most 32
// reduction terms is summed from zero in the mma registers and added to
// fp32 registers (the tensor core truncates as it accumulates).  The mid
// slab holds the fp32 conv1 outputs, and conv2 splits them again as it
// loads its fragments (storing them split, a (big, small) pair a value,
// doubled the slab and ran 1.8 % slower on the card: PERF.md, "Tried").
//
// Design.  A block owns BM output channels (64, 128 or 256; BN = 16384/BM
// GEMM columns) by a rectangle of conv2 outputs: NB images x OH x OW (with a
// pool, the outputs under UTH x UTW pooled outputs, computed once per
// block).  The reduction over conv2's Cm runs in chunks of 32 mid channels:
//   phase A: conv1 for the chunk over the block's mid box (the rectangle
//     plus its F2 - 1 halo, clipped to the real mid extent), an implicit
//     GEMM [32 x box positions] over K1, in 8-position mma tiles (no
//     rounding of the box beyond 8), passes of 256 positions; bias1 and
//     ReLU, then into a shared slab [32][RSTR] that holds the unclipped box
//     with zeros outside the real extent;
//   phase B: conv2's terms of the chunk from the slab into the output
//     registers.
// Both GEMMs step their reduction as (8 input channels) x (one tap): an
// mma k index is a channel, its tap fixed for the step, so an operand tile
// is never expanded into im2col form.  A phase-A stage holds the w1 slice
// ([32][ga 8 F1^2], contiguous along k in w1) and the x box ([ga 8][NB x
// XH x XW], contiguous along w in NCHW) of ga 8-channel groups of Ci (as
// many as fit the slot a phase-B stage needs), and reads a tap as a
// shifted window of the box; a phase-B stage holds the w2 slice ([BM][8
// F2^2]) of 8 mid channels and reads a tap as a shifted window of the
// slab.  Weight rows are 8 ga F^2 + 4 floats (4 mod 8), so the scalar
// fragment loads (row g, column t F^2 + tap) hit 32 banks; box and slab
// channels are 8 mod 32 floats apart, so a tile of 8 positions along a row
// (column g, channel t) does too.  3x3 convs get their own instantiation
// with the taps unrolled.
//
// 384 threads, K1's split: one producer warpgroup only copies (cp.async:
// 16 bytes where 4 box columns are in range and aligned, the weight rows
// where K is a multiple of 4; 4 bytes with zero fill at the halo, for a
// stride-2 conv1 or a CHWN source), two consumer warpgroups only multiply,
// passing a ring of stages (3; 2 at BM 256) on named barriers, FULL when a
// stage landed and EMPTY when it was used.  One producer warpgroup, not
// K1's two: at 384 threads a thread has 168 registers (at 512, 128, and
// the consumers, which hold conv2's sums and a chain of them beside
// conv1's, spilled); setmaxnreg moves the producer's spare ones to the
// consumers.  Phase A's 8 warps each take the 32 mid channels by 4
// 8-position tiles (dealt round-robin), phase B's are BM/32 x 8/(BM/32),
// each 32 channels by 8 column tiles dealt round-robin.  After the last
// chunk the sums go through shared memory for the epilogue (bias2 ->
// residual -> ReLU -> max (nan_max) or avg pool), stored along w.  Conv1
// is recomputed on each block's halo and once per BM-wide slice of Co;
// ops.stack_tiling picks the tile and prices the FLOPs the blocks execute,
// which the kernel adds to ``stats`` when given.
//
// Storage dtypes (csrc/storage.cuh): the bf16 build (-DREPRO_VARIANT_BF16)
// defines conv_stack_nchw_forward_bf16 over bf16 x, w1, b1, w2, b2,
// residual and y, and runs a kernel of its own on the bf16 tensor cores
// (conv_stack_nchw_bf16_kernel below, whose note says how and what bounds
// it): bf16 rings stepping 16 channels at one tap, one bf16 product a
// conv1 term and three a conv2 term.  The mid slab stays float32, as in
// K5a's bf16 build and the reference (stack.py keeps its mid in f32), and
// y is rounded once where it is stored.  The int8 builds take int8 x
// (quantized per channel, its scale folded into w1, as the reference's
// stack takes it) and keep their float twin's tiles, x widened in shared
// memory, each in a kernel of its own (whose note says how): int8->fp32
// (conv_stack_nchw_i8f32_kernel) behind the float32 twin's consumers,
// where an int8 value is exact in TF32 and conv1 keeps fp32 accuracy;
// int8->bf16 (conv_stack_nchw_i8bf16_kernel) behind the bf16 twin's, exact
// as |q| <= 127 fits bf16's 8-bit significand.  Both copy the int8 bytes
// by cp.async into the stage and widen them there.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/mma.cuh"
#include "../../csrc/nan_max.cuh"
#include "../../csrc/storage.cuh"
#include "conv_stack_common.cuh"  // StackArgs, Tile, make_tile, mid_span
#include "conv_ring.cuh"          // ring barriers, copy_quad, rows8

namespace {

using namespace repro::mma;
using namespace repro::ring;
using repro::storage::bf16;
using repro::storage::bf16x4;
using repro::storage::bf16x8;
using repro::storage::chunk8;
using repro::storage::copy1;
using repro::storage::copy4;
using repro::storage::ld;
using repro::storage::pack2;
using repro::storage::put;
using repro::storage::kExactTf32;
using repro::storage::split;
using repro::storage::split3;
using T = REPRO_WT;  // the storage type of w, bias, residual and y
using X = REPRO_XT;  // x's: T's, or int8 (the mid: float32)
using repro::stack::StackArgs;
using repro::stack::Tile;

constexpr int kConsumers = 256;  // two warpgroups: the mma
constexpr int kProducers = 128;  // one warpgroup: the copies
constexpr int kThreads = kConsumers + kProducers;
// registers of a thread of each role (setmaxnreg): 384 x 168 at launch,
// then 256 x 224 + 128 x 56, the same 64512
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;
constexpr int kCM = 32;            // mid channels of a chunk
constexpr int kPassTiles = 32;     // 8-position tiles of a conv1 pass
constexpr int kTile = 16384;       // BM * BN
constexpr int kSmemMax = 232448;   // 227 KB, what an H100 block may use

template <typename E, typename XT = E>
struct K5bArgs {
  StackArgs<E, XT> s;
  int FF1, FF2;          // taps of conv1 and conv2
  int SA1, SA2;          // weight slice row strides: 8 ga F1^2 + 4, 8 F2^2 + 4
  int XSTR;              // x box channel stride (8 mod 32)
  int STAGE;             // floats of a ring stage
  int ga;                // 8-channel groups of Ci a phase-A stage holds
  int a_stages, chunks;  // phase-A stages a pass; 32-channel chunks of Cm
  int vec_x, vec_w1, vec_w2;  // 16-byte copies allowed (vec_x of the bf16
                              // builds: layout_bf16's box mode)
  unsigned long long* stats;  // executed FLOPs, or null
};

// a block's rectangle: conv2 outputs, its unclipped mid box and x box
struct Box {
  int OH, OW, oh0, ow0;   // conv2 outputs of the rectangle, the first one
  int RH, RW;             // the unclipped mid box of an image
  int dh, dw;             // the clipped box's offset in it
  int PA, ntA, passes;    // clipped box positions, their 8-tiles, passes
  int C, ntB;             // conv2 columns (NB x OH x OW), their 8-tiles
  int XH, XW, ih0, iw0, sh;  // x box of an image: rows, columns (a
                             // multiple of 4), origin (iw0 aligned down to
                             // 4) and the first column's shift in it
};

template <typename A>
__device__ __forceinline__ Box make_box(const A& a, const Tile& t) {
  const auto& s = a.s;
  Box b;
  const bool pool = s.pF > 0;
  b.oh0 = pool ? t.uh0 * s.pS : t.uh0;
  b.ow0 = pool ? t.uw0 * s.pS : t.uw0;
  b.OH = pool ? (t.UTHc - 1) * s.pS + s.pF : t.UTHc;
  b.OW = pool ? (t.UTWc - 1) * s.pS + s.pF : t.UTWc;
  b.RH = (b.OH - 1) * s.S2 + s.F2;
  b.RW = (b.OW - 1) * s.S2 + s.F2;
  const int mh_u = b.oh0 * s.S2 - s.P2, mw_u = b.ow0 * s.S2 - s.P2;
  b.dh = t.mh_lo - mh_u;
  b.dw = t.mw_lo - mw_u;
  b.PA = t.NBc * t.MHc * t.MWc;
  b.ntA = (b.PA + 7) / 8;
  b.passes = (b.ntA + kPassTiles - 1) / kPassTiles;
  b.C = t.NBc * b.OH * b.OW;
  b.ntB = (b.C + 7) / 8;
  const int iws = mw_u * s.S1 - s.P1;
  b.ih0 = mh_u * s.S1 - s.P1;
  b.iw0 = iws & ~3;
  b.sh = iws - b.iw0;
  b.XH = (b.RH - 1) * s.S1 + s.F1;
  b.XW = (b.sh + (b.RW - 1) * s.S1 + s.F1 + 3) & ~3;
  return b;
}

// stage s of the block's walk: (chunk, phase A pass and 8-channel group of
// Ci, or phase B 8-channel group of the chunk)
struct StageId {
  int chunk, pass, oct, q;  // oct: the first 8-channel group; q >= 0: B
};
template <typename XT>
__device__ __forceinline__ StageId stage_id(const K5bArgs<float, XT>& a,
                                            const Box& b, int sl) {
  const int na = b.passes * a.a_stages, per = na + kCM / 8;
  StageId id;
  id.chunk = sl / per;
  const int r = sl - id.chunk * per;
  if (r < na) {
    id.pass = r / a.a_stages;
    id.oct = (r - id.pass * a.a_stages) * a.ga;
    id.q = -1;
  } else {
    id.pass = id.oct = 0;
    id.q = r - na;
  }
  return id;
}

// The consumer warpgroups of the float32 builds (the float32 kernel and the
// int8->fp32 one): both GEMMs from the ring's float32 stages (3xTF32) and
// the epilogue.  x of an exact type (kExactTf32: int8) is its own TF32 big
// part, so conv1 drops the product of its small part, which is zero.
template <typename XT, int BM, bool POOL, int F1T, int F2T>
__device__ __forceinline__ void consumers_f32(const K5bArgs<float, XT>& a,
                                              const Tile& t, const Box& b,
                                              int nsl) {
  constexpr int NS = BM == 256 ? 2 : 3;  // ring stages
  constexpr int BN = kTile / BM;
  constexpr int WM = BM / 32;   // phase B warps along Co, 32 rows each
  constexpr int WN = 8 / WM;    // phase B warps along the columns
  constexpr int TS = BN + 8;    // epilogue tile row stride
  extern __shared__ __align__(16) float smem[];  // ring, then the slab
  const StackArgs<float, XT>& s = a.s;
  const int co0 = blockIdx.y * BM;
  float* slab = smem + (NS * a.STAGE > BM * TS ? NS * a.STAGE : BM * TS);
  const int tid = threadIdx.x;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;      // phase B
  const int RS = a.s.RSTR;
  // the taps: compile-time for 3x3 convs (the loops unroll), else the
  // arguments'
  const int F1 = F1T ? F1T : s.F1, F2 = F2T ? F2T : s.F2;
  const int FF1 = F1 * F1, FF2 = F2 * F2;
  const int SA1 = a.SA1, SA2 = 8 * FF2 + 4;
  constexpr int U1 = F1T ? F1T * F1T : 1, U2 = F2T ? F2T * F2T : 1;
  for (int e = tid; e < kCM * RS; e += kConsumers)
    slab[e] = 0.f;

  // phase B: the slab offset of column g of each of this warp's column
  // tiles (ct = nt * WN + wn); past the last column, the last one
  int boff[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = min((nt * WN + wn) * 8 + g, b.C - 1);
    const int nl = c / (b.OH * b.OW), r = c - nl * b.OH * b.OW;
    const int ohl = r / b.OW, owl = r - ohl * b.OW;
    boff[nt] = nl * b.RH * b.RW + ohl * s.S2 * b.RW + owl * s.S2;
  }
  const int ntw = (b.ntB - wn + WN - 1) / WN;  // this warp's column tiles

  float totB[2][8][4], accB[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) totB[mt][nt][e] = 0.f;

  int sl = 0;
  for (int ch = 0; ch < a.chunks; ++ch) {
    const int cm0 = ch * kCM;
    // ---- phase A: conv1 of mid channels cm0 .. cm0 + 31 ----
    for (int p = 0; p < b.passes; ++p) {
      // this warp's tiles of the clipped box: jt = p * 32 + j * 8 + warp
      const int nj = min(4, max(0, (b.ntA - p * kPassTiles - warp + 7) / 8));
      int xoff[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos =
            min((p * kPassTiles + j * 8 + warp) * 8 + g, b.PA - 1);
        const int nl = pos / (t.MHc * t.MWc), r = pos - nl * t.MHc * t.MWc;
        const int mh = r / t.MWc, mw = r - mh * t.MWc;
        xoff[j] = nl * b.XH * b.XW + (mh + b.dh) * s.S1 * b.XW +
                  (mw + b.dw) * s.S1 + b.sh;
      }
      float totA[2][4][4], accA[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) totA[mt][j][e] = 0.f;
      for (int o = 0; o < a.a_stages; ++o, ++sl) {
        const int buf = sl % NS;
        bar_sync(full_bar(buf), kThreads);
        for (int o2 = 0; o2 < a.ga; ++o2) {
          const float* W1s = smem + buf * a.STAGE + g * SA1 + o2 * 8 * FF1;
          const float* Xs =
              smem + buf * a.STAGE + kCM * SA1 + (o2 * 8 + tq) * a.XSTR;
#pragma unroll U1
          for (int r = 0; r < FF1; ++r) {
            if ((r & 3) == 0) {  // a chain of 4 taps (32 terms) from zero
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                  for (int e = 0; e < 4; ++e) accA[mt][j][e] = 0.f;
            }
            // a0 (row g, k t), a1 (row g + 8, k t), a2 (g, t + 4), a3
            // (g + 8, t + 4): k is input channel o2 * 8 + k at tap r
            unsigned abig[2][4], asmall[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const float* pa = W1s + mt * 16 * SA1 + tq * FF1 + r;
              split_tf32(pa[0], abig[mt][0], asmall[mt][0]);
              split_tf32(pa[8 * SA1], abig[mt][1], asmall[mt][1]);
              split_tf32(pa[4 * FF1], abig[mt][2], asmall[mt][2]);
              split_tf32(pa[8 * SA1 + 4 * FF1], abig[mt][3], asmall[mt][3]);
            }
            const float* xr = Xs + (r / F1) * b.XW + r % F1;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= nj) break;
              unsigned b0big, b0small, b1big, b1small;
              split<kExactTf32<XT>>(xr[xoff[j]], b0big, b0small);
              split<kExactTf32<XT>>(xr[4 * a.XSTR + xoff[j]], b1big,
                                    b1small);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_tf32(accA[mt][j], asmall[mt], b0big, b1big,
                         accA[mt][j]);
                if constexpr (!kExactTf32<XT>)
                  mma_tf32(accA[mt][j], abig[mt], b0small, b1small,
                           accA[mt][j]);
                mma_tf32(accA[mt][j], abig[mt], b0big, b1big, accA[mt][j]);
              }
            }
            if ((r & 3) == 3 || r == FF1 - 1) {  // flush the chain
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                  for (int e = 0; e < 4; ++e) totA[mt][j][e] += accA[mt][j][e];
            }
          }
        }
        if (sl + NS < nsl) bar_arrive(empty_bar<NS>(buf), kThreads);
      }
      // bias1, ReLU, into the slab at the clipped box's positions; the
      // previous chunk's phase B must be done with the slab first
      if (p == 0) bar_sync(cons_bar<NS>(), kConsumers);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nj) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos =
              (p * kPassTiles + j * 8 + warp) * 8 + 2 * tq + h;
          if (pos >= b.PA) continue;
          const int nl = pos / (t.MHc * t.MWc), r = pos - nl * t.MHc * t.MWc;
          const int mh = r / t.MWc, mw = r - mh * t.MWc;
          float* d =
              slab + nl * b.RH * b.RW + (mh + b.dh) * b.RW + mw + b.dw;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int v8 = 0; v8 < 2; ++v8) {
              const int row = mt * 16 + g + 8 * v8, cm = cm0 + row;
              float v = totA[mt][j][2 * v8 + h];
              if (s.b1 && cm < s.Cm) v += ld(s.b1 + cm);
              if (s.relu1) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
              d[row * RS] = v;
            }
        }
      }
    }
    bar_sync(cons_bar<NS>(), kConsumers);  // the chunk's slab is complete

    // ---- phase B: conv2's terms of mid channels cm0 .. cm0 + 31 ----
    const int nB = (min(kCM, s.Cm - cm0) + 7) / 8;
    for (int q = 0; q < nB; ++q, ++sl) {
      const int buf = sl % NS;
      bar_sync(full_bar(buf), kThreads);
      const float* W2s = smem + buf * a.STAGE + (wm * 32 + g) * SA2;
      const float* sr = slab + (q * 8 + tq) * RS;
#pragma unroll U2
      for (int r = 0; r < FF2; ++r) {
        if ((r & 3) == 0) {  // a chain of 4 taps (32 terms) from zero
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) accB[mt][nt][e] = 0.f;
        }
        unsigned abig[2][4], asmall[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* pa = W2s + mt * 16 * SA2 + tq * FF2 + r;
          split_tf32(pa[0], abig[mt][0], asmall[mt][0]);
          split_tf32(pa[8 * SA2], abig[mt][1], asmall[mt][1]);
          split_tf32(pa[4 * FF2], abig[mt][2], asmall[mt][2]);
          split_tf32(pa[8 * SA2 + 4 * FF2], abig[mt][3], asmall[mt][3]);
        }
        const float* br = sr + (r / F2) * b.RW + r % F2;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= ntw) break;
          unsigned b0big, b0small, b1big, b1small;
          split_tf32(br[boff[nt]], b0big, b0small);
          split_tf32(br[4 * RS + boff[nt]], b1big, b1small);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(accB[mt][nt], asmall[mt], b0big, b1big, accB[mt][nt]);
            mma_tf32(accB[mt][nt], abig[mt], b0small, b1small, accB[mt][nt]);
            mma_tf32(accB[mt][nt], abig[mt], b0big, b1big, accB[mt][nt]);
          }
        }
        if ((r & 3) == 3 || r == FF2 - 1) {  // flush the chain
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) totB[mt][nt][e] += accB[mt][nt][e];
        }
      }
      if (sl + NS < nsl) bar_arrive(empty_bar<NS>(buf), kThreads);
    }
  }

  if (a.stats && tid == 0) {
    // what the blocks executed: phase A 32 mid channels x the box's
    // 8-tiles x 8 channels x F1^2 taps a stage, phase B BM x the columns'
    // 8-tiles x 8 channels x F2^2 taps a stage
    unsigned long long f = 0;
    for (int ch = 0; ch < a.chunks; ++ch)
      f += 2ull * kCM * 8 * b.ntA * 8 * a.ga * a.a_stages * a.FF1 +
           2ull * BM * 8 * b.ntB * 8 * a.FF2 *
               ((min(kCM, s.Cm - ch * kCM) + 7) / 8);
    atomicAdd(a.stats, f);
  }

  // ---- the epilogue: the sums into shared memory (over the ring, which
  // the last stage freed), then bias2 -> residual -> ReLU [-> pool] ----
  bar_sync(cons_bar<NS>(), kConsumers);
  float* T = smem;  // [BM][TS]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= ntw) break;
    const int c = (nt * WN + wn) * 8 + 2 * tq;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(T + (wm * 32 + mt * 16 + g + 8 * h) * TS +
                                   c) =
            make_float2(totB[mt][nt][2 * h], totB[mt][nt][2 * h + 1]);
  }
  bar_sync(cons_bar<NS>(), kConsumers);
  const int mrows = min(BM, s.Co - co0);
  const int OHW = b.OH * b.OW;
  for (int e = tid; e < mrows * b.C; e += kConsumers) {
    const int m = e / b.C, c = e - m * b.C;
    const int nl = c / OHW, r = c - nl * OHW;
    const int ohl = r / b.OW, owl = r - ohl * b.OW;
    const long long n = t.n0 + nl;
    const int co = co0 + m, oh = b.oh0 + ohl, ow = b.ow0 + owl;
    float v = T[m * TS + c];
    if (s.b2) v += ld(s.b2 + co);
    if (s.res)
      v += ld(s.res + n * s.rs.n + static_cast<long long>(co) * s.rs.c +
              oh * s.rs.h + ow * s.rs.w);
    if (s.relu2) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
    if (POOL)
      T[m * TS + c] = v;
    else
      put(s.y + n * s.ys.n + static_cast<long long>(co) * s.ys.c +
              oh * s.ys.h + ow * s.ys.w,
          v);
  }
  if (!POOL) return;
  bar_sync(cons_bar<NS>(), kConsumers);
  const int outs = t.NBc * t.UTHc * t.UTWc;
  const float area = static_cast<float>(s.pF * s.pF);
  for (int e = tid; e < mrows * outs; e += kConsumers) {
    const int m = e / outs;
    int r = e - m * outs;
    const int uwl = r % t.UTWc;
    r /= t.UTWc;
    const int uhl = r % t.UTHc, nl = r / t.UTHc;
    const float* row = T + m * TS + nl * OHW;
    float acc = s.pool_avg ? 0.f : -INFINITY;
    for (int i = 0; i < s.pF; ++i)
      for (int j = 0; j < s.pF; ++j) {
        const float v = row[(uhl * s.pS + i) * b.OW + uwl * s.pS + j];
        acc = s.pool_avg ? acc + v : nan_max(acc, v);
      }
    put(s.y + static_cast<long long>(t.n0 + nl) * s.ys.n +
            static_cast<long long>(co0 + m) * s.ys.c +
            (t.uh0 + uhl) * s.ys.h + (t.uw0 + uwl) * s.ys.w,
        s.pool_avg ? acc / area : acc);
  }
}

// F1T, F2T: the convs' filter sizes where fixed at compile time (3), else 0
template <typename XT, int BM, bool POOL, int F1T, int F2T>
__global__ void __launch_bounds__(kThreads, 1)
conv_stack_nchw_kernel(const K5bArgs<float, XT> a) {
  constexpr int NS = BM == 256 ? 2 : 3;  // ring stages
  extern __shared__ __align__(16) float smem[];  // ring, then the slab
  const StackArgs<float, XT>& s = a.s;
  const Tile t = repro::stack::make_tile(s);
  const Box b = make_box(a, t);
  const int co0 = blockIdx.y * BM;
  const int last = a.chunks - 1;
  const int nsl = a.chunks * (b.passes * a.a_stages + kCM / 8) - kCM / 8 +
                  (min(kCM, s.Cm - last * kCM) + 7) / 8;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- the producer warpgroup: every stage's copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int XQ = b.XW / 4;            // 16-byte quads of an x box row
    const int xrows = t.NBc * b.XH;     // x box rows of one channel
    auto stage = [&](int sl) {
      const StageId id = stage_id(a, b, sl);
      float* st = smem + (sl % NS) * a.STAGE;
      if (id.q < 0) {
        // w1 rows cm0 .. cm0 + 31, k1 [oct * 8 F1^2, + ga 8 F1^2)
        const int w = 8 * a.ga * a.FF1, wq = w / 4;
        const int k0 = id.oct * 8 * a.FF1;
        for (int e = pt; e < kCM * wq; e += kProducers) {
          const int r = e / wq, c = 4 * (e - r * wq);
          const int cm = id.chunk * kCM + r;
          const int valid = cm < s.Cm ? min(4, s.K1 - (k0 + c)) : 0;
          copy_quad(st + r * a.SA1 + c,
                    s.w1 + static_cast<long long>(cm) * s.K1 + k0 + c, s.w1,
                    valid, a.vec_w1);
        }
        // the x box of channels oct * 8 .. + 8 ga - 1: [8 ga][NB][XH][XW]
        float* xs = st + kCM * a.SA1;
        for (int e = pt; e < 8 * a.ga * xrows * XQ; e += kProducers) {
          const int xq = e % XQ, row = e / XQ;
          const int c8 = row / xrows, rr = row - c8 * xrows;
          const int nl = rr / b.XH, xh = rr - nl * b.XH;
          const int ci = id.oct * 8 + c8, ih = b.ih0 + xh;
          const int iw = b.iw0 + 4 * xq;
          float* d = xs + c8 * a.XSTR + rr * b.XW + 4 * xq;
          const bool rok = ci < s.Ci && static_cast<unsigned>(ih) <
                                            static_cast<unsigned>(s.H);
          const long long base = static_cast<long long>(t.n0 + nl) * s.xs.n +
                                 static_cast<long long>(ci) * s.xs.c +
                                 static_cast<long long>(ih) * s.xs.h;
          if (!rok || iw >= s.W || iw + 4 <= 0) {
            copy4(d, s.x, false);
          } else if (a.vec_x && iw >= 0 && iw + 4 <= s.W) {
            copy4(d, s.x + base + iw, true);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok = static_cast<unsigned>(iw + j) <
                              static_cast<unsigned>(s.W);
              copy1(d + j, ok ? s.x + base + (iw + j) * s.xs.w : s.x, ok);
            }
          }
        }
      } else {
        // w2 rows co0 .. co0 + BM - 1, k2 [(chunk 32 + q 8) F2^2, + 8 F2^2)
        const int w = 8 * a.FF2, wq = w / 4;
        const int k0 = (id.chunk * kCM + id.q * 8) * a.FF2;
        for (int e = pt; e < BM * wq; e += kProducers) {
          const int r = e / wq, c = 4 * (e - r * wq);
          const int co = co0 + r;
          const int valid = co < s.Co ? min(4, s.Cm * a.FF2 - (k0 + c)) : 0;
          copy_quad(st + r * a.SA2 + c,
                    s.w2 + static_cast<long long>(co) * s.Cm * a.FF2 + k0 + c,
                    s.w2, valid, a.vec_w2);
        }
      }
    };
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < nsl) stage(q);
      cp_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      cp_wait<NS - 2>();  // stage sl has landed: announce it
      bar_arrive(full_bar(sl % NS), kThreads);
      const int nx = sl + NS - 1;
      if (nx < nsl) {
        if (nx >= NS) bar_sync(empty_bar<NS>(nx % NS), kThreads);
        stage(nx);
      }
      cp_commit();
    }
    return;
  }

  consumers_f32<XT, BM, POOL, F1T, F2T>(a, t, b, nsl);
}

// ---- the bf16 build: both convs on the bf16 tensor cores -----------------
//
// Instantiated only by the bf16 build (launch_f below).  The tile, the
// chunks of kCM mid channels, the float32 mid slab, the phase A / phase B
// walk of ring stages, the roles and barriers and the epilogue are the
// float32 kernel's; the rings and the products differ.
//
// Rings: bf16.  A stage steps k16, 16 channels at one tap, where the
// float32 kernel's steps 8: a 16-channel bf16 stage takes the bytes of an
// 8-channel float32 one, so every stage lies inside the float32 kernel's
// slot (layout_bf16 below, ops.py::k5b_bf16_layout) and the shared memory,
// the tiles and the plans stay the float32 build's.  A phase-A stage holds
// gb 16-channel groups of Ci (the largest divisor of ceil(Ci / 16) that
// fits) of w1 ([32][16 gb F1^2], contiguous along k in w1) and of the x
// box ([16 gb][NB x XH x XW]); a phase-B stage the w2 slice of 16 mid
// channels ([BM][16 F2^2]).  Weight rows arrive by 16-byte cp.async where
// the row length is a multiple of 8 (storage::chunk8), box rows where W %
// 8 == 0 (the box origin aligned down to 8 and its width rounded up to 8,
// where that box fits the slot), halfwords elsewhere (Ci or Cm not a
// multiple of 16 zero-pads k; W = 55, 28, a CHWN source, the halo): four
// 4-column copies a thread with their loads issued together, no branch
// between them, each copy's place stepped on from the thread's first
// without a division (two copies at a time, each placed by three
// divisions, ran 1.12x slower on ResNet-18's launches; 4-byte cp.async for
// the quads that start on an even element, slower again).
//
// Products: one bf16 m16n8k16 product a conv1 term, three a conv2 term:
// the reference reads the mid at float32, so each mid value enters as
// hi + md + lo (storage::split3, exact) times the exact bf16 w2, as in
// K5a's bf16 build.  A fragment register holds the k pair (2t, 2t+1),
// which the kernel maps to channels t and t + 4 of the step (the pair 2t +
// 8, 2t + 9 to t + 8 and t + 12): both operands agree on the order, and
// channels 4 apart hit other banks.  Neither operand suits ldmatrix (a
// conv1 B column is a gathered window whose start moves with the tap, not
// 16-byte aligned; a weight k pair is F^2 apart), so each register is two
// halfword shared loads packed into a word.  Phase A's warps take the 32
// mid channels by 4 8-position tiles (one A fragment serves 4 tiles);
// phase B's take 64 output channels by 4 column tiles, so a split mid
// value serves 4 x 3 products.  conv1 runs one chain a pass (K1 <= 4608
// on the networks) and conv2 one a chunk (288 terms for 3 x 3, three
// products each), added to fp32 registers; the CPU emulation
// (kernels/bf16_mma.py) holds both at those lengths to one bf16 step.
//
// What bounds it: operations at the bf16 tensor cores' 989 TFLOP/s by
// design, one product a conv1 term and three a conv2 term.  On the card
// (ResNet-18's launches, W 55: every box row by halfwords), timed apart
// with tools/storage_variants.py --timing-only: the consumers alone take
// two thirds of the kernel's time, a third each in conv1's products,
// conv2's and the rest (fragment packing, split3, barriers); conv1's
// B fragments from 32-bit loads instead of halfword pairs change nothing,
// so the shared loads do not bound phase A (and interleaving channel
// pairs in the box would not help); the box copy adds the last third.
// ``stats`` counts the FLOPs as the float32 build does, 8-channel
// granules, so the smoke's check against stack_tiling stands.
static_assert(16 * sizeof(bf16) == 8 * sizeof(float),
              "a 16-channel bf16 stage takes the bytes of an 8-channel "
              "float32 one");

// the bf16 build's box of a block: the float32 one's rows, its columns
// from an origin aligned down to 8 and a width rounded up to 8 where the
// rows copy by 16 bytes (vec_x), else from the first column itself and a
// width rounded up to 4
template <typename XT>
__device__ __forceinline__ Box make_box_bf16(const K5bArgs<bf16, XT>& a,
                                             const Tile& t) {
  Box b = make_box(a, t);
  const int iws = b.iw0 + b.sh;
  const int span = (b.RW - 1) * a.s.S1 + a.s.F1;
  if (a.vec_x) {
    b.iw0 = iws & ~7;
    b.sh = iws - b.iw0;
    b.XW = (b.sh + span + 7) & ~7;
  } else {
    b.iw0 = iws;
    b.sh = 0;
    b.XW = (span + 3) & ~3;
  }
  return b;
}

// stage sl of the bf16 walk: phase A stages of gb 16-channel groups of Ci,
// then kCM / 16 phase-B stages a chunk
template <typename XT>
__device__ __forceinline__ StageId stage_id_bf16(const K5bArgs<bf16, XT>& a,
                                                 const Box& b, int sl) {
  const int na = b.passes * a.a_stages, per = na + kCM / 16;
  StageId id;
  id.chunk = sl / per;
  const int r = sl - id.chunk * per;
  if (r < na) {
    id.pass = r / a.a_stages;
    id.oct = (r - id.pass * a.a_stages) * a.ga;  // the first 16-channel group
    id.q = -1;
  } else {
    id.pass = id.oct = 0;
    id.q = r - na;
  }
  return id;
}

// one x element's bf16 bits: a bf16 as it is, an int8 widened (exact)
__device__ __forceinline__ unsigned xbits_at(const bf16* x, long long i) {
  return __ldg(reinterpret_cast<const unsigned short*>(x) + i);
}
__device__ __forceinline__ unsigned xbits_at(const int8_t* x, long long i) {
  return __float_as_uint(static_cast<float>(__ldg(x + i))) >> 16;
}

// The int8->bf16 kernel's producer pieces below are the bf16 twin's stage
// loops, which the twin keeps inline: called through these functions it
// ran 4.4 % slower on the card (PERF.md), while its consumers
// (consumers_bf16) are shared at no cost.
//
// a phase-A stage's w1 slice: rows cm0 .. cm0 + 31, k1 [oct 16 F1^2, + gb
// 16 F1^2), by 16-byte cp.async where the rows allow it
template <typename XT>
__device__ __forceinline__ void w1_slice_bf16(const K5bArgs<bf16, XT>& a,
                                              const StageId& id,
                                              unsigned short* st, int pt) {
  const StackArgs<bf16, XT>& s = a.s;
  const int wq = 2 * a.ga * a.FF1;  // 16-byte chunks of a row
  const int k0 = id.oct * 16 * a.FF1;
  for (int e = pt; e < kCM * wq; e += kProducers) {
    const int r = e / wq, c = 8 * (e - r * wq);
    const int cm = id.chunk * kCM + r;
    const int valid = cm < s.Cm ? min(8, s.K1 - (k0 + c)) : 0;
    chunk8(reinterpret_cast<bf16*>(st + r * a.SA1 + c),
           valid > 0 ? s.w1 + static_cast<long long>(cm) * s.K1 + k0 + c
                     : s.w1,
           valid, a.vec_w1);
  }
}

// a phase-B stage's w2 slice: rows co0 .. co0 + BM - 1, k2 [(chunk 32 + q
// 16) F2^2, + 16 F2^2)
template <int BM, typename XT>
__device__ __forceinline__ void w2_slice_bf16(const K5bArgs<bf16, XT>& a,
                                              const StageId& id,
                                              unsigned short* st, int co0,
                                              int pt) {
  const StackArgs<bf16, XT>& s = a.s;
  const int wq = 2 * a.FF2;
  const int k0 = (id.chunk * kCM + id.q * 16) * a.FF2;
  for (int e = pt; e < BM * wq; e += kProducers) {
    const int r = e / wq, c = 8 * (e - r * wq);
    const int co = co0 + r;
    const int valid = co < s.Co ? min(8, s.Cm * a.FF2 - (k0 + c)) : 0;
    chunk8(reinterpret_cast<bf16*>(st + r * a.SA2 + c),
           valid > 0
               ? s.w2 + static_cast<long long>(co) * s.Cm * a.FF2 + k0 + c
               : s.w2,
           valid, a.vec_w2);
  }
}

// a producer thread's first 4-column element copy of the box (column xq0
// of row (nl0, xh0) of channel c160), and how far kProducers copies step:
// dq columns and drow rows (one more on a column carry)
struct BoxWalk {
  int xq0, dq, drow, c160, nl0, xh0;
  // (column xq, channel c, image nl, row xh) on by kProducers copies of
  // XQ a row (the int8->fp32 kernel's walks)
  __device__ __forceinline__ void step(int& xq, int& c, int& nl, int& xh,
                                       int XQ, const Box& b,
                                       const Tile& t) const {
    xq += dq;
    int rows = drow;
    if (xq >= XQ) {
      xq -= XQ;
      ++rows;
    }
    xh += rows;
    while (xh >= b.XH) {
      xh -= b.XH;
      if (++nl == t.NBc) {
        nl = 0;
        ++c;
      }
    }
  }
};
__device__ __forceinline__ BoxWalk box_walk(const Box& b, const Tile& t,
                                            int XQ, int pt) {
  BoxWalk w{pt % XQ, kProducers % XQ, kProducers / XQ, 0, 0, pt / XQ};
  while (w.xh0 >= b.XH) {
    w.xh0 -= b.XH;
    if (++w.nl0 == t.NBc) {
      w.nl0 = 0;
      ++w.c160;
    }
  }
  return w;
}

// a phase-A stage's x box element by element (a CHWN source, W not a
// multiple of the copies', the halo): halfwords, 4 columns a copy, kU
// copies' loads issued together with no branch between them; each copy's
// (column, c16, nl, xh) stepped on from the thread's first, never divided
template <typename XT>
__device__ __forceinline__ void box_elements_bf16(
    const K5bArgs<bf16, XT>& a, const Box& b, const Tile& t,
    const StageId& id, unsigned short* xs, int XQ, const BoxWalk& w) {
  constexpr int kU = 4;  // copies in flight at once
  const StackArgs<bf16, XT>& s = a.s;
  int xq = w.xq0, c16 = w.c160, nl = w.nl0, xh = w.xh0;
  while (c16 < 16 * a.ga) {
    unsigned h[kU][4];
    int off[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ci = id.oct * 16 + c16, ih = b.ih0 + xh;
      const int iw = b.iw0 + 4 * xq;
      off[u] = c16 < 16 * a.ga
                   ? c16 * a.XSTR + (nl * b.XH + xh) * b.XW + 4 * xq
                   : -1;
      const bool rok = off[u] >= 0 && ci < s.Ci &&
                       static_cast<unsigned>(ih) <
                           static_cast<unsigned>(s.H);
      const long long base = static_cast<long long>(t.n0 + nl) * s.xs.n +
                             static_cast<long long>(ci) * s.xs.c +
                             static_cast<long long>(ih) * s.xs.h;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[u][j] = rok && static_cast<unsigned>(iw + j) <
                             static_cast<unsigned>(s.W)
                      ? xbits_at(s.x, base + static_cast<long long>(iw + j) *
                                                 s.xs.w)
                      : 0u;
      xq += w.dq;  // on by kProducers copies
      int rows = w.drow;
      if (xq >= XQ) {
        xq -= XQ;
        ++rows;
      }
      xh += rows;
      while (xh >= b.XH) {
        xh -= b.XH;
        if (++nl == t.NBc) {
          nl = 0;
          ++c16;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (off[u] >= 0)
        *reinterpret_cast<uint2*>(xs + off[u]) = make_uint2(
            h[u][0] | (h[u][1] << 16), h[u][2] | (h[u][3] << 16));
  }
}

// The consumer warpgroups of the bf16 builds (the twin's kernel and the
// int8->bf16 one): both GEMMs from the ring's bf16 stages and the epilogue.
template <int BM, bool POOL, int F1T, int F2T, typename XT>
__device__ __forceinline__ void consumers_bf16(const K5bArgs<bf16, XT>& a,
                                               const Tile& t, const Box& b,
                                               int nsl) {
  constexpr int NS = BM == 256 ? 2 : 3;  // ring stages
  constexpr int BN = kTile / BM;
  constexpr int WM = BM / 64;   // phase B warps along Co, 64 rows each
  constexpr int WN = 8 / WM;    // phase B warps along the columns
  constexpr int TS = BN + 8;    // epilogue tile row stride
  extern __shared__ __align__(16) float smem[];  // ring, then the slab
  const unsigned short* ring = reinterpret_cast<unsigned short*>(smem);
  const StackArgs<bf16, XT>& s = a.s;
  const int co0 = blockIdx.y * BM;
  float* slab = smem + (NS * a.STAGE > BM * TS ? NS * a.STAGE : BM * TS);
  const int tid = threadIdx.x;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;      // phase B
  const int RS = a.s.RSTR;
  // the taps: compile-time for 3x3 convs (the loops unroll), else the
  // arguments'
  const int F1 = F1T ? F1T : s.F1, F2 = F2T ? F2T : s.F2;
  const int FF1 = F1 * F1, FF2 = F2 * F2;
  const int SA1 = a.SA1, SA2 = 16 * FF2 + 8;
  constexpr int U1 = F1T ? F1T * F1T : 1, U2 = F2T ? F2T * F2T : 1;
  for (int e = tid; e < kCM * RS; e += kConsumers)
    slab[e] = 0.f;

  // phase B: the slab offset of column g of each of this warp's column
  // tiles (ct = nt * WN + wn); past the last column, the last one
  int boff[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = min((nt * WN + wn) * 8 + g, b.C - 1);
    const int nl = c / (b.OH * b.OW), r = c - nl * b.OH * b.OW;
    const int ohl = r / b.OW, owl = r - ohl * b.OW;
    boff[nt] = nl * b.RH * b.RW + ohl * s.S2 * b.RW + owl * s.S2;
  }
  const int ntw = (b.ntB - wn + WN - 1) / WN;  // this warp's column tiles

  float totB[4][4][4], accB[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) totB[mt][nt][e] = 0.f;

  int sl = 0;
  for (int ch = 0; ch < a.chunks; ++ch) {
    const int cm0 = ch * kCM;
    // ---- phase A: conv1 of mid channels cm0 .. cm0 + 31 ----
    for (int p = 0; p < b.passes; ++p) {
      // this warp's tiles of the clipped box: jt = p * 32 + j * 8 + warp
      const int nj = min(4, max(0, (b.ntA - p * kPassTiles - warp + 7) / 8));
      int xoff[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos =
            min((p * kPassTiles + j * 8 + warp) * 8 + g, b.PA - 1);
        const int nl = pos / (t.MHc * t.MWc), r = pos - nl * t.MHc * t.MWc;
        const int mh = r / t.MWc, mw = r - mh * t.MWc;
        xoff[j] = nl * b.XH * b.XW + (mh + b.dh) * s.S1 * b.XW +
                  (mw + b.dw) * s.S1 + b.sh;
      }
      float accA[2][4][4];  // the pass's sums: one chain over K1
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) accA[mt][j][e] = 0.f;
      for (int o = 0; o < a.a_stages; ++o, ++sl) {
        const int buf = sl % NS;
        bar_sync(full_bar(buf), kThreads);
        for (int o2 = 0; o2 < a.ga; ++o2) {
          // k pair (2t, 2t + 1) is channels t, t + 4 of the group; (2t +
          // 8, 2t + 9) channels t + 8, t + 12
          const unsigned short* W1s =
              ring + buf * 2 * a.STAGE + g * SA1 + (o2 * 16 + tq) * FF1;
          const unsigned short* Xs = ring + buf * 2 * a.STAGE + kCM * SA1 +
                                     (o2 * 16 + tq) * a.XSTR;
#pragma unroll U1
          for (int r = 0; r < FF1; ++r) {
            // a0 (row g, k 2t..), a1 (row g + 8), a2 (g, 2t + 8..), a3
            unsigned af[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const unsigned short* pa = W1s + mt * 16 * SA1 + r;
              af[mt][0] = pack2(pa[0], pa[4 * FF1]);
              af[mt][1] = pack2(pa[8 * SA1], pa[8 * SA1 + 4 * FF1]);
              af[mt][2] = pack2(pa[8 * FF1], pa[12 * FF1]);
              af[mt][3] = pack2(pa[8 * SA1 + 8 * FF1], pa[8 * SA1 + 12 * FF1]);
            }
            const unsigned short* xr = Xs + (r / F1) * b.XW + r % F1;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= nj) break;
              const unsigned short* xp = xr + xoff[j];
              const unsigned b0 = pack2(xp[0], xp[4 * a.XSTR]);
              const unsigned b1 = pack2(xp[8 * a.XSTR], xp[12 * a.XSTR]);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                mma_bf16(accA[mt][j], af[mt], b0, b1);
            }
          }
        }
        if (sl + NS < nsl) bar_arrive(empty_bar<NS>(buf), kThreads);
      }
      // bias1, ReLU, into the slab at the clipped box's positions; the
      // previous chunk's phase B must be done with the slab first
      if (p == 0) bar_sync(cons_bar<NS>(), kConsumers);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nj) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos =
              (p * kPassTiles + j * 8 + warp) * 8 + 2 * tq + h;
          if (pos >= b.PA) continue;
          const int nl = pos / (t.MHc * t.MWc), r = pos - nl * t.MHc * t.MWc;
          const int mh = r / t.MWc, mw = r - mh * t.MWc;
          float* d =
              slab + nl * b.RH * b.RW + (mh + b.dh) * b.RW + mw + b.dw;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int v8 = 0; v8 < 2; ++v8) {
              const int row = mt * 16 + g + 8 * v8, cm = cm0 + row;
              float v = accA[mt][j][2 * v8 + h];
              if (s.b1 && cm < s.Cm) v += ld(s.b1 + cm);
              if (s.relu1) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
              d[row * RS] = v;
            }
        }
      }
    }
    bar_sync(cons_bar<NS>(), kConsumers);  // the chunk's slab is complete

    // ---- phase B: conv2's terms of mid channels cm0 .. cm0 + 31, one
    // chain a chunk ----
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) accB[mt][nt][e] = 0.f;
    const int nB = (min(kCM, s.Cm - cm0) + 15) / 16;
    for (int q = 0; q < nB; ++q, ++sl) {
      const int buf = sl % NS;
      bar_sync(full_bar(buf), kThreads);
      const unsigned short* W2s =
          ring + buf * 2 * a.STAGE + (wm * 64 + g) * SA2 + tq * FF2;
      const float* sr = slab + (q * 16 + tq) * RS;
#pragma unroll U2
      for (int r = 0; r < FF2; ++r) {
        unsigned af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const unsigned short* pa = W2s + mt * 16 * SA2 + r;
          af[mt][0] = pack2(pa[0], pa[4 * FF2]);
          af[mt][1] = pack2(pa[8 * SA2], pa[8 * SA2 + 4 * FF2]);
          af[mt][2] = pack2(pa[8 * FF2], pa[12 * FF2]);
          af[mt][3] = pack2(pa[8 * SA2 + 8 * FF2], pa[8 * SA2 + 12 * FF2]);
        }
        const float* br = sr + (r / F2) * b.RW + r % F2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= ntw) break;
          const float* bp = br + boff[nt];
          unsigned hi0, md0, lo0, hi1, md1, lo1;
          split3(bp[0], bp[4 * RS], hi0, md0, lo0);
          split3(bp[8 * RS], bp[12 * RS], hi1, md1, lo1);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_bf16(accB[mt][nt], af[mt], lo0, lo1);
            mma_bf16(accB[mt][nt], af[mt], md0, md1);
            mma_bf16(accB[mt][nt], af[mt], hi0, hi1);
          }
        }
      }
      if (sl + NS < nsl) bar_arrive(empty_bar<NS>(buf), kThreads);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) totB[mt][nt][e] += accB[mt][nt][e];
  }

  if (a.stats && tid == 0) {
    // what the float32 build counts (8-channel granules): phase A 32 mid
    // channels x the box's 8-tiles x Ci in 8s x F1^2 taps, phase B BM x the
    // columns' 8-tiles x the chunk's mid channels in 8s x F2^2 taps
    unsigned long long f = 0;
    for (int ch = 0; ch < a.chunks; ++ch)
      f += 2ull * kCM * 8 * b.ntA * 8 * ((s.Ci + 7) / 8) * a.FF1 +
           2ull * BM * 8 * b.ntB * 8 * a.FF2 *
               ((min(kCM, s.Cm - ch * kCM) + 7) / 8);
    atomicAdd(a.stats, f);
  }

  // ---- the epilogue: the sums into shared memory (over the ring, which
  // the last stage freed), then bias2 -> residual -> ReLU [-> pool] ----
  bar_sync(cons_bar<NS>(), kConsumers);
  float* T = smem;  // [BM][TS]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (nt >= ntw) break;
    const int c = (nt * WN + wn) * 8 + 2 * tq;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(T + (wm * 64 + mt * 16 + g + 8 * h) * TS +
                                   c) =
            make_float2(totB[mt][nt][2 * h], totB[mt][nt][2 * h + 1]);
  }
  bar_sync(cons_bar<NS>(), kConsumers);
  const int mrows = min(BM, s.Co - co0);
  const int OHW = b.OH * b.OW;
  for (int e = tid; e < mrows * b.C; e += kConsumers) {
    const int m = e / b.C, c = e - m * b.C;
    const int nl = c / OHW, r = c - nl * OHW;
    const int ohl = r / b.OW, owl = r - ohl * b.OW;
    const long long n = t.n0 + nl;
    const int co = co0 + m, oh = b.oh0 + ohl, ow = b.ow0 + owl;
    float v = T[m * TS + c];
    if (s.b2) v += ld(s.b2 + co);
    if (s.res)
      v += ld(s.res + n * s.rs.n + static_cast<long long>(co) * s.rs.c +
              oh * s.rs.h + ow * s.rs.w);
    if (s.relu2) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
    if (POOL)
      T[m * TS + c] = v;
    else
      put(s.y + n * s.ys.n + static_cast<long long>(co) * s.ys.c +
              oh * s.ys.h + ow * s.ys.w,
          v);
  }
  if (!POOL) return;
  bar_sync(cons_bar<NS>(), kConsumers);
  const int outs = t.NBc * t.UTHc * t.UTWc;
  const float area = static_cast<float>(s.pF * s.pF);
  for (int e = tid; e < mrows * outs; e += kConsumers) {
    const int m = e / outs;
    int r = e - m * outs;
    const int uwl = r % t.UTWc;
    r /= t.UTWc;
    const int uhl = r % t.UTHc, nl = r / t.UTHc;
    const float* row = T + m * TS + nl * OHW;
    float acc = s.pool_avg ? 0.f : -INFINITY;
    for (int i = 0; i < s.pF; ++i)
      for (int j = 0; j < s.pF; ++j) {
        const float v = row[(uhl * s.pS + i) * b.OW + uwl * s.pS + j];
        acc = s.pool_avg ? acc + v : nan_max(acc, v);
      }
    put(s.y + static_cast<long long>(t.n0 + nl) * s.ys.n +
            static_cast<long long>(co0 + m) * s.ys.c +
            (t.uh0 + uhl) * s.ys.h + (t.uw0 + uwl) * s.ys.w,
        s.pool_avg ? acc / area : acc);
  }
}


template <typename XT, int BM, bool POOL, int F1T, int F2T>
__global__ void __launch_bounds__(kThreads, 1)
conv_stack_nchw_bf16_kernel(const K5bArgs<bf16, XT> a) {
  constexpr int NS = BM == 256 ? 2 : 3;  // ring stages
  extern __shared__ __align__(16) float smem[];  // ring, then the slab
  // the ring in bf16 bits: stage s at 2 s STAGE halfwords
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem);
  const StackArgs<bf16, XT>& s = a.s;
  const Tile t = repro::stack::make_tile(s);
  const Box b = make_box_bf16(a, t);
  const int co0 = blockIdx.y * BM;
  const int last = a.chunks - 1;
  const int nsl = a.chunks * (b.passes * a.a_stages + kCM / 16) - kCM / 16 +
                  (min(kCM, s.Cm - last * kCM) + 15) / 16;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- the producer warpgroup: every stage's copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int QW = a.vec_x ? 8 : 4;     // columns of a box copy
    const int XQ = b.XW / QW;           // copies of an x box row
    const int xrows = t.NBc * b.XH;     // x box rows of one channel
    constexpr int kU = 4;               // halfword copies in flight at once
    // the thread's first halfword copy (column xq0 of row (nl0, xh0) of
    // channel c160), and how far kProducers copies step: dq columns and
    // drow rows (one more on a column carry)
    const int xq0 = pt % XQ, dq = kProducers % XQ, drow = kProducers / XQ;
    int c160 = 0, nl0 = 0, xh0 = pt / XQ;
    while (xh0 >= b.XH) {
      xh0 -= b.XH;
      if (++nl0 == t.NBc) {
        nl0 = 0;
        ++c160;
      }
    }
    auto stage = [&](int sl) {
      const StageId id = stage_id_bf16(a, b, sl);
      unsigned short* st = ring + (sl % NS) * 2 * a.STAGE;
      if (id.q < 0) {
        // w1 rows cm0 .. cm0 + 31, k1 [oct 16 F1^2, + gb 16 F1^2)
        const int wq = 2 * a.ga * a.FF1;  // 16-byte chunks of a row
        const int k0 = id.oct * 16 * a.FF1;
        for (int e = pt; e < kCM * wq; e += kProducers) {
          const int r = e / wq, c = 8 * (e - r * wq);
          const int cm = id.chunk * kCM + r;
          const int valid = cm < s.Cm ? min(8, s.K1 - (k0 + c)) : 0;
          chunk8(
              reinterpret_cast<bf16*>(st + r * a.SA1 + c),
              valid > 0 ? s.w1 + static_cast<long long>(cm) * s.K1 + k0 + c
                        : s.w1,
              valid, a.vec_w1);
        }
        // the x box of channels oct 16 .. + 16 gb - 1: [16 gb][NB][XH][XW]
        unsigned short* xs = st + kCM * a.SA1;
        const int total = 16 * a.ga * xrows * XQ;
        if (!a.vec_x) {
          // halfwords, 4 columns a copy, kU copies' loads issued together
          // with no branch between them; each copy's (column, c16, nl, xh)
          // stepped on from the thread's first, never divided
          int xq = xq0, c16 = c160, nl = nl0, xh = xh0;
          while (c16 < 16 * a.ga) {
            unsigned h[kU][4];
            int off[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int ci = id.oct * 16 + c16, ih = b.ih0 + xh;
              const int iw = b.iw0 + 4 * xq;
              off[u] = c16 < 16 * a.ga
                           ? c16 * a.XSTR + (nl * b.XH + xh) * b.XW + 4 * xq
                           : -1;
              const bool rok = off[u] >= 0 && ci < s.Ci &&
                               static_cast<unsigned>(ih) <
                                   static_cast<unsigned>(s.H);
              const long long base = static_cast<long long>(t.n0 + nl) *
                                         s.xs.n +
                                     static_cast<long long>(ci) * s.xs.c +
                                     static_cast<long long>(ih) * s.xs.h;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                h[u][j] = rok && static_cast<unsigned>(iw + j) <
                                     static_cast<unsigned>(s.W)
                              ? xbits_at(s.x, base +
                                                  static_cast<long long>(
                                                      iw + j) * s.xs.w)
                              : 0u;
              xq += dq;  // on by kProducers copies
              int rows = drow;
              if (xq >= XQ) {
                xq -= XQ;
                ++rows;
              }
              xh += rows;
              while (xh >= b.XH) {
                xh -= b.XH;
                if (++nl == t.NBc) {
                  nl = 0;
                  ++c16;
                }
              }
            }
#pragma unroll
            for (int u = 0; u < kU; ++u)
              if (off[u] >= 0)
                *reinterpret_cast<uint2*>(xs + off[u]) =
                    make_uint2(h[u][0] | (h[u][1] << 16),
                               h[u][2] | (h[u][3] << 16));
          }
        } else {
          // 16-byte copies of 8 columns (element by element where the row
          // leaves [0, W)), two at a time
          for (int e0 = pt; e0 < total; e0 += 2 * kProducers) {
            unsigned v[2][4];
            unsigned short* d[2];
            bool run[2];
            const XT* src[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int e = e0 + u * kProducers;
              const int xq = e % XQ, row = e / XQ;
              const int c16 = row / xrows, rr = row - c16 * xrows;
              const int nl = rr / b.XH, xh = rr - nl * b.XH;
              const int ci = id.oct * 16 + c16, ih = b.ih0 + xh;
              const int iw = b.iw0 + 8 * xq;
              d[u] = xs + c16 * a.XSTR + rr * b.XW + 8 * xq;
              const bool rok = e < total && ci < s.Ci &&
                               static_cast<unsigned>(ih) <
                                   static_cast<unsigned>(s.H);
              const long long base =
                  static_cast<long long>(t.n0 + nl) * s.xs.n +
                  static_cast<long long>(ci) * s.xs.c +
                  static_cast<long long>(ih) * s.xs.h;
              run[u] = rok && iw >= 0 && iw + 8 <= s.W;
              src[u] = s.x + base + iw;
              unsigned h[8];
#pragma unroll
              for (int j = 0; j < 8; ++j)
                h[j] = !run[u] && rok &&
                               static_cast<unsigned>(iw + j) <
                                   static_cast<unsigned>(s.W)
                           ? xbits_at(s.x, base + iw + j)
                           : 0u;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                v[u][j] = h[2 * j] | (h[2 * j + 1] << 16);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (e0 + u * kProducers >= total) break;
              if (run[u])
                cp16(d[u], src[u], true);
              else
                *reinterpret_cast<uint4*>(d[u]) =
                    make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
            }
          }
        }
      } else {
        // w2 rows co0 .. co0 + BM - 1, k2 [(chunk 32 + q 16) F2^2, + 16 F2^2)
        const int wq = 2 * a.FF2;
        const int k0 = (id.chunk * kCM + id.q * 16) * a.FF2;
        for (int e = pt; e < BM * wq; e += kProducers) {
          const int r = e / wq, c = 8 * (e - r * wq);
          const int co = co0 + r;
          const int valid = co < s.Co ? min(8, s.Cm * a.FF2 - (k0 + c)) : 0;
          chunk8(
              reinterpret_cast<bf16*>(st + r * a.SA2 + c),
              valid > 0
                  ? s.w2 + static_cast<long long>(co) * s.Cm * a.FF2 + k0 + c
                  : s.w2,
              valid, a.vec_w2);
        }
      }
    };
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < nsl) stage(q);
      cp_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      cp_wait<NS - 2>();  // stage sl has landed: announce it
      bar_arrive(full_bar(sl % NS), kThreads);
      const int nx = sl + NS - 1;
      if (nx < nsl) {
        if (nx >= NS) bar_sync(empty_bar<NS>(nx % NS), kThreads);
        stage(nx);
      }
      cp_commit();
    }
    return;
  }

  consumers_bf16<BM, POOL, F1T, F2T>(a, t, b, nsl);
}

// ---- the int8->bf16 build: x in flight as bytes -----------------------------
//
// Instantiated only by the int8->bf16 build (launch_f below).  The twin's
// kernel above on int8 x loaded each box run of 8 by one blocking 8-byte
// load (and the other columns byte by byte), a producer thread two runs at
// a time: on ResNet-18's layer1 block (W 56, where the twin's 8-aligned box
// does not fit the slot, so every column went by bytes) everything but its
// products took 0.35 ms and its consumers alone 0.28 of its 0.47 (PERF.md).
// This kernel keeps the twin's tile, walk, ring, barriers, consumers
// (consumers_bf16: fragments, products, epilogue) and counted FLOPs, and
// changes how x reaches the stage: the int8 bytes travel by cp.async,
// NS - 1 stages ahead as w1 does, and are widened in shared memory.
//
//   Copy units (vec_x 2: W % 8 == 0, the box origin aligned down to 8 and
//   its width rounded up to 8, where that box fits the slot; vec_x 1: W %
//   4 == 0, aligned to 4, the float32 box's columns, which always fit): a
//   unit is 2Q columns of a box row (Q = 8 or 4; Q where the row ends),
//   and its bf16 span in the stage (4Q bytes) holds its bytes until they
//   are widened, at the span's upper half.  One 2Q-byte cp.async where
//   both halves lie in x and the source is 2Q-aligned, else one Q-byte
//   copy a half; a half off [0, W) x [0, H) (or past Ci) is zero-filled by
//   the copy's source size.  Both ends are aligned (x and W multiples of Q,
//   the box rows and channels 16 bytes apart).
//   Widening: once its cp.async group has landed (cp.async.wait_group makes
//   a thread's own copies visible to it), each producer thread reads the
//   bytes it copied and writes their bf16 over its units' spans, then
//   arrives on the stage's FULL barrier, which publishes the box as the
//   twin's does.  A unit's bytes lie inside its own span, so no thread
//   reads bytes another writes, and the stage never outgrows the twin's
//   slot: the kernel's shared memory is the twin's at every tile.
//   Elements (vec_x 0: a CHWN source, W % 4 != 0, x misaligned): the
//   twin's box and its batched loads (box_elements_bf16), a byte each.
//
// What bounds it: as the twin, operations by design (one bf16 product a
// conv1 term, three a conv2 term).  On the card (ResNet-18's layer1 block,
// timed apart with tools/timing_variants.py, PERF.md) the consumers alone
// (the twin's body) take ~0.28 of its ~0.37 ms, and everything but the
// products ~0.26: the copies no longer wait on memory, and what is left of
// them is their share of the sub-partitions' issue slots, which the
// consumers' halfword fragment loads keep busy.

// the int8 build's box of a block: the float32 one's rows; its columns from
// an origin aligned down to Q (8 at vec_x 2, 4 at vec_x 1) and a width
// rounded up to Q, else (vec_x 0) the bf16 build's element box
__device__ __forceinline__ Box make_box_i8(const K5bArgs<bf16, int8_t>& a,
                                           const Tile& t) {
  Box b = make_box(a, t);
  const int iws = b.iw0 + b.sh;
  const int span = (b.RW - 1) * a.s.S1 + a.s.F1;
  if (a.vec_x) {
    const int Q = a.vec_x == 2 ? 8 : 4;
    b.iw0 = iws & -Q;
    b.sh = iws - b.iw0;
    b.XW = (b.sh + span + Q - 1) & -Q;
  } else {
    b.iw0 = iws;
    b.sh = 0;
    b.XW = (span + 3) & ~3;
  }
  return b;
}

// One copy unit of the int8 box (ops.py::k5b_i8bf16_unit mirrors it): 2Q
// columns of a box row, or Q where the row ends (half)
struct I8Unit {
  unsigned char* d;   // its bf16 span in the stage (4Q bytes; 2Q if half)
  const int8_t* src;  // its first element in x
  bool ok0, ok1;      // its first and second Q columns lie in x
  bool half;
};

// every unit of a phase-A stage's box that a producer thread owns, from its
// first (w: box_walk over XU units a row) stepped on by kProducers units,
// never divided; Q (8 or 4) the bytes of one aligned copy.  The units'
// sources lie within the block's box, 32-bit offsets from its origin.
template <int Q, typename F>
__device__ __forceinline__ void i8_units(const K5bArgs<bf16, int8_t>& a,
                                         const Box& b, const Tile& t,
                                         const StageId& id,
                                         unsigned short* xs, int XU,
                                         const BoxWalk& w, F f) {
  const StackArgs<bf16, int8_t>& s = a.s;
  const int8_t* x0 = s.x + static_cast<long long>(t.n0) * s.xs.n +
                     static_cast<long long>(id.oct * 16) * s.xs.c +
                     static_cast<long long>(b.ih0) * s.xs.h + b.iw0;
  int xu = w.xq0, c16 = w.c160, nl = w.nl0, xh = w.xh0;
  while (c16 < 16 * a.ga) {
    const int ci = id.oct * 16 + c16, ih = b.ih0 + xh;
    const int c0 = 2 * Q * xu, iw = b.iw0 + c0;
    const bool rok = ci < s.Ci && static_cast<unsigned>(ih) <
                                      static_cast<unsigned>(s.H);
    I8Unit u;
    u.d = reinterpret_cast<unsigned char*>(
        xs + c16 * a.XSTR + (nl * b.XH + xh) * b.XW + c0);
    u.half = c0 + Q == b.XW;
    u.ok0 = rok && iw >= 0 && iw + Q <= s.W;
    u.ok1 = !u.half && rok && iw + Q >= 0 && iw + 2 * Q <= s.W;
    u.src = x0 + (nl * s.xs.n + c16 * s.xs.c + xh * s.xs.h + c0);
    f(u);
    xu += w.dq;  // on by kProducers units
    int rows = w.drow;
    if (xu >= XU) {
      xu -= XU;
      ++rows;
    }
    xh += rows;
    while (xh >= b.XH) {
      xh -= b.XH;
      if (++nl == t.NBc) {
        nl = 0;
        ++c16;
      }
    }
  }
}

// N bytes (16, 8 or 4) global -> shared by cp.async; ok == false writes
// zeros
template <int N>
__device__ __forceinline__ void cp_n(void* d, const void* src, bool ok) {
  if constexpr (N == 16)
    cp16(d, src, ok);
  else if constexpr (N == 8)
    cp8(d, src, ok);
  else
    cp4(d, src, ok);
}

// a unit's bytes into the upper part of its span: one 2Q-byte copy where
// both halves lie in x and the source is 2Q-aligned, else a Q-byte copy a
// half (zeros where it lies off x; `any` a readable address)
template <int Q>
__device__ __forceinline__ void copy_unit(const I8Unit& u, const int8_t* any) {
  if (u.half) {
    cp_n<Q>(u.d + Q, u.ok0 ? u.src : any, u.ok0);
  } else if (u.ok0 && u.ok1 &&
             (reinterpret_cast<uintptr_t>(u.src) & (2 * Q - 1)) == 0) {
    cp_n<2 * Q>(u.d + 2 * Q, u.src, true);
  } else {
    cp_n<Q>(u.d + 2 * Q, u.ok0 ? u.src : any, u.ok0);
    cp_n<Q>(u.d + 3 * Q, u.ok1 ? u.src + Q : any, u.ok1);
  }
}

// a unit's bytes, once landed, widened to bf16 over its span (all read
// before any is written: they lie inside the span)
template <int Q>
__device__ __forceinline__ void widen_unit(const I8Unit& u) {
  if constexpr (Q == 8) {
    if (u.half) {
      *reinterpret_cast<uint4*>(u.d) =
          bf16x8(*reinterpret_cast<const uint2*>(u.d + 8));
    } else {
      const uint4 r = *reinterpret_cast<const uint4*>(u.d + 16);
      *reinterpret_cast<uint4*>(u.d) = bf16x8(make_uint2(r.x, r.y));
      *reinterpret_cast<uint4*>(u.d + 16) = bf16x8(make_uint2(r.z, r.w));
    }
  } else {
    if (u.half) {
      *reinterpret_cast<uint2*>(u.d) =
          bf16x4(*reinterpret_cast<const unsigned*>(u.d + 4));
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(u.d + 8);
      *reinterpret_cast<uint2*>(u.d) = bf16x4(r.x);
      *reinterpret_cast<uint2*>(u.d + 8) = bf16x4(r.y);
    }
  }
}

template <int BM, bool POOL, int F1T, int F2T>
__global__ void __launch_bounds__(kThreads, 1)
conv_stack_nchw_i8bf16_kernel(const K5bArgs<bf16, int8_t> a) {
  constexpr int NS = BM == 256 ? 2 : 3;  // ring stages
  extern __shared__ __align__(16) float smem[];  // ring, then the slab
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem);
  const StackArgs<bf16, int8_t>& s = a.s;
  const Tile t = repro::stack::make_tile(s);
  const Box b = make_box_i8(a, t);
  const int co0 = blockIdx.y * BM;
  const int last = a.chunks - 1;
  const int nsl = a.chunks * (b.passes * a.a_stages + kCM / 16) - kCM / 16 +
                  (min(kCM, s.Cm - last * kCM) + 15) / 16;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- the producer warpgroup: every stage's copies, x widened ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int Q = a.vec_x == 2 ? 8 : 4;  // bytes of an aligned copy
    // element copies (4 columns) or units (2Q columns) of a box row, and
    // this thread's first
    const int XQ = a.vec_x ? (b.XW + 2 * Q - 1) / (2 * Q) : b.XW / 4;
    const BoxWalk w = box_walk(b, t, XQ, pt);
    auto stage = [&](int sl) {
      const StageId id = stage_id_bf16(a, b, sl);
      unsigned short* st = ring + (sl % NS) * 2 * a.STAGE;
      if (id.q >= 0) {
        w2_slice_bf16<BM>(a, id, st, co0, pt);
        return;
      }
      w1_slice_bf16(a, id, st, pt);
      unsigned short* xs = st + kCM * a.SA1;
      if (!a.vec_x) {
        box_elements_bf16(a, b, t, id, xs, XQ, w);
        return;
      }
      if (a.vec_x == 2)
        i8_units<8>(a, b, t, id, xs, XQ, w,
                    [&](const I8Unit& u) { copy_unit<8>(u, s.x); });
      else
        i8_units<4>(a, b, t, id, xs, XQ, w,
                    [&](const I8Unit& u) { copy_unit<4>(u, s.x); });
    };
    // the bytes this thread copied into stage sl, widened to bf16 in place
    auto widen = [&](int sl) {
      const StageId id = stage_id_bf16(a, b, sl);
      if (!a.vec_x || id.q >= 0) return;
      unsigned short* xs = ring + (sl % NS) * 2 * a.STAGE + kCM * a.SA1;
      if (a.vec_x == 2)
        i8_units<8>(a, b, t, id, xs, XQ, w,
                    [&](const I8Unit& u) { widen_unit<8>(u); });
      else
        i8_units<4>(a, b, t, id, xs, XQ, w,
                    [&](const I8Unit& u) { widen_unit<4>(u); });
    };
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < nsl) stage(q);
      cp_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      cp_wait<NS - 2>();  // stage sl has landed: widen it, announce it
      widen(sl);
      bar_arrive(full_bar(sl % NS), kThreads);
      const int nx = sl + NS - 1;
      if (nx < nsl) {
        if (nx >= NS) bar_sync(empty_bar<NS>(nx % NS), kThreads);
        stage(nx);
      }
      cp_commit();
    }
    return;
  }
  consumers_bf16<BM, POOL, F1T, F2T>(a, t, b, nsl);
}

// ---- the int8->fp32 build: x in flight as bytes ----------------------------
//
// Instantiated only by the int8->fp32 build (launch_f below).  The float32
// kernel above on int8 x filled its box by storage::copy4 / copy1: each a
// blocking 4-byte (or 1-byte) load, widened in registers and stored, one in
// flight a producer thread, while w1 and w2 went by cp.async.  This kernel
// keeps the float32 kernel's tile, box, walk, ring, barriers, consumers
// (consumers_f32: 3xTF32, conv1 without x's small part, which is zero;
// chains flushed every 32 terms; the epilogue) and counted FLOPs, and
// changes how x reaches the stage: the int8 bytes travel by cp.async, NS - 1
// stages ahead as w1 does, and are widened to float32 in shared memory.
//
//   Copy units (vec_x = C: 16, 8 or 4, an NCHW source with W % C == 0 and x
//   C-byte aligned, so every row of x starts on a C-byte boundary): a unit
//   is the box quads (4 columns; the box origin is aligned down to 4) of a
//   row that lie in one C-byte chunk of x, chunk quads [j0, j1) of Cq = C /
//   4; a row's first and last units may hold fewer.  A whole unit is one
//   C-byte cp.async, a part of one 8-byte copies of even quad pairs and
//   4-byte ones; a chunk lies wholly inside [0, W) or wholly outside it (W
//   % C == 0), so one off [0, W) x [0, H) (or past Ci) is zero-filled by the
//   copies' source size.  The bytes go into the last C bytes of the unit's
//   own float32 span (a whole unit's upper quarter), chunk quad j at 4 j,
//   so each copy is aligned at both ends as it is in x.
//   Widening: once its cp.async group has landed (cp.async.wait_group makes
//   a thread's own copies visible to it), each producer thread reads the
//   bytes of its units and writes their floats over the units' spans, every
//   byte read before any float is written (exact: |q| <= 127), then arrives
//   on the stage's FULL barrier.  No thread reads bytes another writes, and
//   the box is the float32 kernel's: the shared memory is the twin's.
//   Elements (vec_x 0: a CHWN source, W % 4 != 0, x misaligned): 4 columns
//   a copy, kU copies' byte loads issued together before any is stored
//   (box_elements_f32).
//
// What bounds it: as the twin, operations (3xTF32 on the tensor cores, two
// TF32 products a conv1 term, three a conv2 term).  On the card
// (ResNet-18's layer1 block, timed apart with tools/timing_variants.py,
// PERF.md) the consumers alone take ~0.51 of its ~0.58 ms, cuDNN's time
// for the whole block; the copies, off the consumers' path, add the rest.

// a phase-A stage's w1 slice: rows cm0 .. cm0 + 31, k1 [oct 8 F1^2, + ga 8
// F1^2), by 16-byte cp.async where the rows allow it
__device__ __forceinline__ void w1_slice_f32(const K5bArgs<float, int8_t>& a,
                                             const StageId& id, float* st,
                                             int pt) {
  const StackArgs<float, int8_t>& s = a.s;
  const int wq = 2 * a.ga * a.FF1;  // quads of a row
  const int k0 = id.oct * 8 * a.FF1;
  for (int e = pt; e < kCM * wq; e += kProducers) {
    const int r = e / wq, c = 4 * (e - r * wq);
    const int cm = id.chunk * kCM + r;
    const int valid = cm < s.Cm ? min(4, s.K1 - (k0 + c)) : 0;
    copy_quad(st + r * a.SA1 + c,
              s.w1 + static_cast<long long>(cm) * s.K1 + k0 + c, s.w1, valid,
              a.vec_w1);
  }
}

// a phase-B stage's w2 slice: rows co0 .. co0 + BM - 1, k2 [(chunk 32 + q
// 8) F2^2, + 8 F2^2)
template <int BM>
__device__ __forceinline__ void w2_slice_f32(const K5bArgs<float, int8_t>& a,
                                             const StageId& id, float* st,
                                             int co0, int pt) {
  const StackArgs<float, int8_t>& s = a.s;
  const int wq = 2 * a.FF2;
  const int k0 = (id.chunk * kCM + id.q * 8) * a.FF2;
  for (int e = pt; e < BM * wq; e += kProducers) {
    const int r = e / wq, c = 4 * (e - r * wq);
    const int co = co0 + r;
    const int valid = co < s.Co ? min(4, s.Cm * a.FF2 - (k0 + c)) : 0;
    copy_quad(st + r * a.SA2 + c,
              s.w2 + static_cast<long long>(co) * s.Cm * a.FF2 + k0 + c, s.w2,
              valid, a.vec_w2);
  }
}

// 4 int8 (bytes of w, element 0 lowest) as 4 floats
__device__ __forceinline__ float4 f32x4(unsigned w) {
  const int v = static_cast<int>(w);
  return make_float4(repro::storage::i8_at(v, 0), repro::storage::i8_at(v, 1),
                     repro::storage::i8_at(v, 2), repro::storage::i8_at(v, 3));
}

// a phase-A stage's x box element by element (vec_x 0), 4 columns a copy,
// kU copies' loads issued together with no branch between them; each
// copy's (column, c8, nl, xh) stepped on from the thread's first, never
// divided
__device__ __forceinline__ void box_elements_f32(
    const K5bArgs<float, int8_t>& a, const Box& b, const Tile& t,
    const StageId& id, float* xs, int XQ, const BoxWalk& w) {
  constexpr int kU = 4;  // copies in flight at once
  const StackArgs<float, int8_t>& s = a.s;
  int xq = w.xq0, c8 = w.c160, nl = w.nl0, xh = w.xh0;
  while (c8 < 8 * a.ga) {
    float4 v[kU];
    int off[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ci = id.oct * 8 + c8, ih = b.ih0 + xh;
      const int iw = b.iw0 + 4 * xq;
      off[u] = c8 < 8 * a.ga
                   ? c8 * a.XSTR + (nl * b.XH + xh) * b.XW + 4 * xq
                   : -1;
      const bool rok = off[u] >= 0 && ci < s.Ci &&
                       static_cast<unsigned>(ih) <
                           static_cast<unsigned>(s.H);
      const long long base = static_cast<long long>(t.n0 + nl) * s.xs.n +
                             static_cast<long long>(ci) * s.xs.c +
                             static_cast<long long>(ih) * s.xs.h;
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = rok && static_cast<unsigned>(iw + j) <
                          static_cast<unsigned>(s.W)
                   ? static_cast<float>(__ldg(
                         s.x + base + static_cast<long long>(iw + j) * s.xs.w))
                   : 0.f;
      v[u] = make_float4(e[0], e[1], e[2], e[3]);
      w.step(xq, c8, nl, xh, XQ, b, t);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (off[u] >= 0) *reinterpret_cast<float4*>(xs + off[u]) = v[u];
  }
}

// One copy unit of the int8->fp32 box (ops.py::k5b_i8f32_unit mirrors it):
// chunk quads [j0, j1) of a C-byte chunk of x that lie in a box row
struct F32Unit {
  unsigned char* d;   // the (virtual) float32 span of chunk quad 0
  const int8_t* src;  // x's address of chunk quad 0
  int j0, j1;
  bool ok;            // the chunk lies in x (row, channel and columns)
};

// every unit of a phase-A stage's box that a producer thread owns, from its
// first (w: box_walk over XU units a row) stepped on by kProducers units,
// never divided; phi: the box origin's quad in its chunk.  The units'
// sources lie within the block's box, 32-bit offsets from its origin.
template <int C, typename F>
__device__ __forceinline__ void f32_units(const K5bArgs<float, int8_t>& a,
                                          const Box& b, const Tile& t,
                                          const StageId& id, float* xs,
                                          int XU, int phi, const BoxWalk& w,
                                          F f) {
  constexpr int Cq = C / 4;
  const StackArgs<float, int8_t>& s = a.s;
  const int cw0 = b.iw0 - 4 * phi;  // the first chunk's column (C-aligned)
  const int8_t* x0 = s.x + static_cast<long long>(t.n0) * s.xs.n +
                     static_cast<long long>(id.oct * 8) * s.xs.c +
                     static_cast<long long>(b.ih0) * s.xs.h + cw0;
  const int XQ = b.XW / 4;
  int xu = w.xq0, c8 = w.c160, nl = w.nl0, xh = w.xh0;
  while (c8 < 8 * a.ga) {
    const int ci = id.oct * 8 + c8, ih = b.ih0 + xh;
    const int q0 = Cq * xu - phi;  // the box quad of chunk quad 0
    const int cw = cw0 + C * xu;
    F32Unit u;
    u.j0 = max(0, -q0);
    u.j1 = min(Cq, XQ - q0);
    u.d = reinterpret_cast<unsigned char*>(
        xs + c8 * a.XSTR + (nl * b.XH + xh) * b.XW + 4 * q0);
    u.src = x0 + (nl * s.xs.n + c8 * s.xs.c + xh * s.xs.h + C * xu);
    u.ok = ci < s.Ci &&
           static_cast<unsigned>(ih) < static_cast<unsigned>(s.H) &&
           cw >= 0 && cw + C <= s.W;
    f(u);
    w.step(xu, c8, nl, xh, XU, b, t);
  }
}

// where a unit's bytes lie: the last C bytes of its span (a whole unit's
// upper quarter), chunk quad j at 4 j, so each copy is aligned in shared
// memory as its source is in x
template <int C>
__device__ __forceinline__ unsigned char* unit_bytes(const F32Unit& u) {
  return u.d + 16 * u.j1 - C;
}

// a unit's bytes into its span: one C-byte copy where the unit is whole,
// else an 8-byte copy a pair of even and odd quads and a 4-byte one a quad
// left (zeros where it lies off x; `any` a readable address)
template <int C>
__device__ __forceinline__ void copy_unit_f32(const F32Unit& u,
                                              const int8_t* any) {
  constexpr int Cq = C / 4;
  unsigned char* b = unit_bytes<C>(u);
  if (u.j0 == 0 && u.j1 == Cq) {
    cp_n<C>(b, u.ok ? u.src : any, u.ok);
    return;
  }
#pragma unroll
  for (int j = 0; j < Cq; ++j) {
    const bool in = j >= u.j0 && j < u.j1;
    const bool pair = C >= 8 && (j & 1) == 0 && in && j + 1 < u.j1;
    const bool paired = C >= 8 && (j & 1) == 1 && in && j - 1 >= u.j0;
    if (pair)
      cp8(b + 4 * j, u.ok ? u.src + 4 * j : any, u.ok);
    else if (in && !paired)
      cp4(b + 4 * j, u.ok ? u.src + 4 * j : any, u.ok);
  }
}

// a unit's bytes, once landed, widened to float32 over its span (all read
// before any is written: they lie inside the span)
template <int C>
__device__ __forceinline__ void widen_unit_f32(const F32Unit& u) {
  constexpr int Cq = C / 4;
  const unsigned char* b = unit_bytes<C>(u);
  unsigned q[Cq];
#pragma unroll
  for (int j = 0; j < Cq; ++j)
    q[j] = j >= u.j0 && j < u.j1
               ? *reinterpret_cast<const unsigned*>(b + 4 * j)
               : 0u;
#pragma unroll
  for (int j = 0; j < Cq; ++j)
    if (j >= u.j0 && j < u.j1)
      *reinterpret_cast<float4*>(u.d + 16 * j) = f32x4(q[j]);
}

template <int BM, bool POOL, int F1T, int F2T>
__global__ void __launch_bounds__(kThreads, 1)
conv_stack_nchw_i8f32_kernel(const K5bArgs<float, int8_t> a) {
  constexpr int NS = BM == 256 ? 2 : 3;  // ring stages
  extern __shared__ __align__(16) float smem[];  // ring, then the slab
  const StackArgs<float, int8_t>& s = a.s;
  const Tile t = repro::stack::make_tile(s);
  const Box b = make_box(a, t);
  const int co0 = blockIdx.y * BM;
  const int last = a.chunks - 1;
  const int nsl = a.chunks * (b.passes * a.a_stages + kCM / 8) - kCM / 8 +
                  (min(kCM, s.Cm - last * kCM) + 7) / 8;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- the producer warpgroup: every stage's copies, x widened ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int C = a.vec_x;                 // bytes of a chunk, or 0
    const int Cq = C / 4;
    const int phi = C ? (b.iw0 & (C - 1)) / 4 : 0;
    // units (or 4-column element copies) of a box row, this thread's first
    const int XU = C ? (b.XW / 4 + phi + Cq - 1) / Cq : b.XW / 4;
    const BoxWalk w = box_walk(b, t, XU, pt);
    auto stage = [&](int sl) {
      const StageId id = stage_id(a, b, sl);
      float* st = smem + (sl % NS) * a.STAGE;
      if (id.q >= 0) {
        w2_slice_f32<BM>(a, id, st, co0, pt);
        return;
      }
      w1_slice_f32(a, id, st, pt);
      float* xs = st + kCM * a.SA1;
      if (C == 16)
        f32_units<16>(a, b, t, id, xs, XU, phi, w,
                      [&](const F32Unit& u) { copy_unit_f32<16>(u, s.x); });
      else if (C == 8)
        f32_units<8>(a, b, t, id, xs, XU, phi, w,
                     [&](const F32Unit& u) { copy_unit_f32<8>(u, s.x); });
      else if (C == 4)
        f32_units<4>(a, b, t, id, xs, XU, phi, w,
                     [&](const F32Unit& u) { copy_unit_f32<4>(u, s.x); });
      else
        box_elements_f32(a, b, t, id, xs, XU, w);
    };
    // the bytes this thread copied into stage sl, widened in place
    auto widen = [&](int sl) {
      const StageId id = stage_id(a, b, sl);
      if (!C || id.q >= 0) return;
      float* xs = smem + (sl % NS) * a.STAGE + kCM * a.SA1;
      if (C == 16)
        f32_units<16>(a, b, t, id, xs, XU, phi, w,
                      [&](const F32Unit& u) { widen_unit_f32<16>(u); });
      else if (C == 8)
        f32_units<8>(a, b, t, id, xs, XU, phi, w,
                     [&](const F32Unit& u) { widen_unit_f32<8>(u); });
      else
        f32_units<4>(a, b, t, id, xs, XU, phi, w,
                     [&](const F32Unit& u) { widen_unit_f32<4>(u); });
    };
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < nsl) stage(q);
      cp_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      cp_wait<NS - 2>();  // stage sl has landed: widen it, announce it
      widen(sl);
      bar_arrive(full_bar(sl % NS), kThreads);
      const int nx = sl + NS - 1;
      if (nx < nsl) {
        if (nx >= NS) bar_sync(empty_bar<NS>(nx % NS), kThreads);
        stage(nx);
      }
      cp_commit();
    }
    return;
  }
  consumers_f32<int8_t, BM, POOL, F1T, F2T>(a, t, b, nsl);
}

// K5b's shared-memory layout at a block tile (ops.py::k5b_layout computes
// the same): a phase-A stage holds ga 8-channel groups of Ci (the largest
// divisor of Ci/8 whose stage fits the slot a phase-B stage needs)
struct Layout {
  int sa1, sa2, xstr, rstr, ga, stage;
  long long bytes;  // -1: no such tile
};
Layout layout(int Ci, int F1, int S1, int F2, int S2, int pool_F, int pool_S,
              int bm, int nb, int uth, int utw) {
  Layout l{};
  l.bytes = -1;
  if ((bm != 64 && bm != 128 && bm != 256) || nb < 1 || uth < 1 || utw < 1)
    return l;
  const int oth = pool_F > 0 ? (uth - 1) * pool_S + pool_F : uth;
  const int otw = pool_F > 0 ? (utw - 1) * pool_S + pool_F : utw;
  if (static_cast<long long>(nb) * oth * otw > kTile / bm) return l;
  const int rh = (oth - 1) * S2 + F2, rw = (otw - 1) * S2 + F2;
  const int xh = (rh - 1) * S1 + F1, xw = (3 + (rw - 1) * S1 + F1 + 3) & ~3;
  const int ff1 = F1 * F1, ci_oct = (Ci + 7) / 8;
  l.sa2 = 8 * F2 * F2 + 4;
  l.xstr = rows8(nb * xh * xw);
  l.rstr = rows8(nb * rh * rw);
  auto stage_a = [&](int ga) {
    return kCM * (8 * ga * ff1 + 4) + 8 * ga * l.xstr;
  };
  const int slot = stage_a(1) > bm * l.sa2 ? stage_a(1) : bm * l.sa2;
  l.ga = 1;
  for (int ga = 2; ga <= ci_oct; ++ga)
    if (ci_oct % ga == 0 && stage_a(ga) <= slot) l.ga = ga;
  l.sa1 = 8 * l.ga * ff1 + 4;
  l.stage = slot;
  const long long ring = (bm == 256 ? 2LL : 3LL) * slot;
  const long long tile = static_cast<long long>(bm) * (kTile / bm + 8);
  l.bytes = 4 * ((ring > tile ? ring : tile) + 1LL * kCM * l.rstr);
  return l;
}

// The bf16 builds' layout at the same tile (ops.py::k5b_bf16_layout and
// k5b_i8bf16_layout compute the same): every stage in the float32 layout's
// slot, so the slab and the shared memory are the float32 layout's.  A
// phase-B stage, BM w2 rows of 16 F2^2 + 8 halfwords, takes the float32
// one's bytes.  A phase-A stage holds gb 16-channel groups of Ci, gb the
// largest divisor of ceil(Ci / 16) whose stage fits: w1 rows of 16 gb F1^2
// + 8 halfwords and the x box, its channels XSTR halfwords apart (8 mod 32,
// as the float32 box's floats).  The box (mode, the kernels' vec_x): 2, an
// origin aligned down to 8 and a width rounded up to 8, where want8 (the
// rows may copy by 8 or 16 bytes: an NCHW source, W % 8 == 0, x aligned)
// and that box fits the slot at gb = 1; 1, aligned down to 4 and rounded
// up to 4 (want4: W % 4 == 0; the int8->bf16 build's 4-byte copies), the
// float32 box's columns, which fit as the float32 box does; else 0, the
// box from its first column, width rounded up to 4 (at most the float32
// box's columns, half its bytes).
Layout layout_bf16(const Layout& l, int Ci, int F1, int S1, int F2, int S2,
                   int pool_F, int pool_S, int nb, int uth, int utw,
                   bool want8, bool want4, int& mode) {
  Layout b = l;
  const int oth = pool_F > 0 ? (uth - 1) * pool_S + pool_F : uth;
  const int otw = pool_F > 0 ? (utw - 1) * pool_S + pool_F : utw;
  const int rh = (oth - 1) * S2 + F2, rw = (otw - 1) * S2 + F2;
  const int xh = (rh - 1) * S1 + F1, span = (rw - 1) * S1 + F1;
  const int ff1 = F1 * F1, ci16 = (Ci + 15) / 16;
  const long long slot = 2LL * l.stage;  // halfwords
  auto stage_a = [&](int gb, int xstr) {
    return 1LL * kCM * (16 * gb * ff1 + 8) + 16LL * gb * xstr;
  };
  const int x8 = rows8(nb * xh * ((7 + span + 7) & ~7));
  const int x4 = rows8(nb * xh * ((3 + span + 3) & ~3));
  mode = want8 && stage_a(1, x8) <= slot   ? 2
         : want4 && stage_a(1, x4) <= slot ? 1
                                           : 0;
  b.xstr = mode == 2   ? x8
           : mode == 1 ? x4
                       : rows8(nb * xh * ((span + 3) & ~3));
  b.ga = 1;
  for (int g = 2; g <= ci16; ++g)
    if (ci16 % g == 0 && stage_a(g, b.xstr) <= slot) b.ga = g;
  b.sa1 = 16 * b.ga * ff1 + 8;
  b.sa2 = 16 * F2 * F2 + 8;
  if (stage_a(b.ga, b.xstr) > slot) b.bytes = -1;
  return b;
}

template <int BM, bool POOL, int FT>
cudaError_t launch_f(const K5bArgs<T, X>& a, dim3 grid, int smem,
                     cudaStream_t st) {
  void (*kernel)(const K5bArgs<T, X>);
  if constexpr (std::is_same<T, bf16>::value &&
                std::is_same<X, int8_t>::value)
    kernel = conv_stack_nchw_i8bf16_kernel<BM, POOL, FT, FT>;
  else if constexpr (std::is_same<X, int8_t>::value)
    kernel = conv_stack_nchw_i8f32_kernel<BM, POOL, FT, FT>;
  else if constexpr (std::is_same<T, bf16>::value)
    kernel = conv_stack_nchw_bf16_kernel<X, BM, POOL, FT, FT>;
  else
    kernel = conv_stack_nchw_kernel<X, BM, POOL, FT, FT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int BM, bool POOL>
cudaError_t launch(const K5bArgs<T, X>& a, dim3 grid, int smem,
                   cudaStream_t st) {
  return a.s.F1 == 3 && a.s.F2 == 3 ? launch_f<BM, POOL, 3>(a, grid, smem, st)
                                    : launch_f<BM, POOL, 0>(a, grid, smem, st);
}

}  // namespace

// Host entry of K5b: fills the arguments from the shapes and the tile the
// wrapper chose (bm output channels; nb x uth x utw output units), and
// launches.  x is REPRO_XT, every other tensor REPRO_WT (storage.cuh:
// conv_stack_nchw_forward is float32, conv_stack_nchw_forward_bf16 bf16,
// _i8f32 and _i8bf16 int8 x with float32 or bf16 w).  stats (or null): one
// uint64 on the card that the blocks add their executed FLOPs to.  Returns
// a cudaError_t code.
extern "C" int REPRO_ENTRY(conv_stack_nchw_forward)(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* res, void* y, int N, int Ci, int H, int W,
    int Cm, int F1, int S1, int P1, int Co, int F2, int S2, int P2,
    int pool_F, int pool_S, int pool_avg, int relu1, int relu2, int src_nchw,
    int dst_nchw, int res_nchw, int bm, int nb, int uth, int utw,
    void* stats, void* stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr bool kI8 = std::is_same<X, int8_t>::value;
  Layout l = layout(Ci, F1, S1, F2, S2, pool_F, pool_S, bm, nb, uth, utw);
  int box = 0;  // the bf16 builds' box (layout_bf16's mode)
  if (kBf16 && l.bytes >= 0) {
    // bf16 x: 16-byte runs of 8; int8 x: runs of 8 or 4 bytes
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    l = layout_bf16(l, Ci, F1, S1, F2, S2, pool_F, pool_S, nb, uth, utw,
                    src_nchw && W % 8 == 0 && xa % (kI8 ? 8 : 16) == 0,
                    kI8 && src_nchw && W % 4 == 0 && xa % 4 == 0, box);
  }
  if (l.bytes < 0 || l.bytes > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  K5bArgs<T, X> a{};
  StackArgs<T, X>& s = a.s;
  s.x = static_cast<const X*>(x);
  s.w1 = static_cast<const T*>(w1);
  s.b1 = static_cast<const T*>(b1);
  s.w2 = static_cast<const T*>(w2);
  s.b2 = static_cast<const T*>(b2);
  s.res = static_cast<const T*>(res);
  s.y = static_cast<T*>(y);
  s.N = N; s.Ci = Ci; s.H = H; s.W = W; s.Cm = Cm;
  s.F1 = F1; s.S1 = S1; s.P1 = P1; s.K1 = Ci * F1 * F1;
  s.Ho1 = (H + 2 * P1 - F1) / S1 + 1;
  s.Wo1 = (W + 2 * P1 - F1) / S1 + 1;
  s.Co = Co; s.F2 = F2; s.S2 = S2; s.P2 = P2;
  s.Ho2 = (s.Ho1 + 2 * P2 - F2) / S2 + 1;
  s.Wo2 = (s.Wo1 + 2 * P2 - F2) / S2 + 1;
  s.pF = pool_F; s.pS = pool_S; s.pool_avg = pool_avg;
  s.relu1 = relu1; s.relu2 = relu2;
  const bool pool = pool_F > 0;
  s.UH = pool ? (s.Ho2 - pool_F) / pool_S + 1 : s.Ho2;
  s.UW = pool ? (s.Wo2 - pool_F) / pool_S + 1 : s.Wo2;
  s.NB = nb; s.UTH = uth; s.UTW = utw;
  s.nTH = (s.UH + uth - 1) / uth;
  s.nTW = (s.UW + utw - 1) / utw;
  s.RSTR = l.rstr;
  s.xs = repro::layout_strides(src_nchw, N, Ci, H, W);
  s.rs = repro::layout_strides(res_nchw, N, Co, s.Ho2, s.Wo2);
  s.ys = repro::layout_strides(dst_nchw, N, Co, s.UH, s.UW);
  a.FF1 = F1 * F1;
  a.FF2 = F2 * F2;
  a.SA1 = l.sa1;
  a.SA2 = l.sa2;
  a.XSTR = l.xstr;
  a.STAGE = l.stage;
  a.ga = l.ga;
  a.chunks = (Cm + kCM - 1) / kCM;
  if (kBf16) {  // 16-channel stages, runs of 8 elements
    a.a_stages = (Ci + 15) / 16 / l.ga;
    a.vec_x = box;
    a.vec_w1 = s.K1 % 8 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
    a.vec_w2 = (Cm * a.FF2) % 8 == 0 &&
               reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  } else {
  a.a_stages = (Ci + 7) / 8 / l.ga;
  if (kI8) {  // int8 x: chunks of C bytes, every row C-aligned
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    for (int c = 16; c >= 4 && !a.vec_x; c /= 2)
      if (src_nchw && W % c == 0 && xa % c == 0) a.vec_x = c;
  } else {
    a.vec_x = src_nchw && W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  }
  a.vec_w1 = s.K1 % 4 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  a.vec_w2 = (Cm * a.FF2) % 4 == 0 &&
             reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  }
  a.stats = static_cast<unsigned long long*>(stats);
  if (N <= 0 || Co <= 0 || Cm <= 0 || s.UH <= 0 || s.UW <= 0)
    return static_cast<int>(cudaGetLastError());
  const dim3 grid(((N + nb - 1) / nb) * s.nTH * s.nTW, (Co + bm - 1) / bm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(l.bytes);
  cudaError_t e;
  switch (bm) {
    case 64:
      e = pool ? launch<64, true>(a, grid, sm, st)
               : launch<64, false>(a, grid, sm, st);
      break;
    case 128:
      e = pool ? launch<128, true>(a, grid, sm, st)
               : launch<128, false>(a, grid, sm, st);
      break;
    default:
      e = pool ? launch<256, true>(a, grid, sm, st)
               : launch<256, false>(a, grid, sm, st);
  }
  return static_cast<int>(e);
}
