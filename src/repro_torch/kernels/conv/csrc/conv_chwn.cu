// K1: the direct CHWN convolution engine, with its fused epilogue.
//
// Replaces repro/kernels/conv/conv.py::conv_chwn_pallas (body _conv_kernel),
// the cuda-convnet analogue the paper pairs with CHWN: out[co,ho,wo,n] +=
// x[ci,ho*S+dy,wo*S+dx,n] * w[ci,dy,dx,co], fp32 accuracy, then bias ->
// residual -> ReLU -> max/avg pool, reading x in src_layout and writing y
// in dst_layout.  x is [Ci,H,W,N] or [N,Ci,H,W]; w is [Ci,F,F,Co]; y is
// [Co,Ho',Wo',N] or [N,Co,Ho',Wo'] (Ho', Wo' after the pool).  dgrad runs
// here too, as the stride-1 conv of the dilated gradient.
//
// Storage dtypes (csrc/storage.cuh): x float32, bf16 or int8, w (and bias,
// residual, y) float32 or bf16, the (x, w) pairs ops.py admits; int8 x
// holds per-channel quantized values whose scale the caller folded into w.
// Where w is bf16 (bf16 x, int8 x) the narrow kernel below runs: a bf16
// ring and bf16 products on the tensor cores, summed in fp32 (its own note
// says how).  int8 x with float32 w (the calibration's int8 row) runs a
// kernel of its own (conv_chwn_i8f32_kernel, below): x widened to bf16 as
// in the narrow builds, w float32 cut into three bf16 parts, three bf16
// products a term.  Everything after the products is float32, and y is
// rounded once where it is stored.
// z (save_act, training) is stored in y's type, rounded once as y is: the
// reference saves it in the output dtype (its odt), so a bf16 conv saves
// bf16 z and the activation memory halves.  The pool then reads the
// float32 values of its tile, whose max rounds to the max of the rounded
// z (rounding is monotonic): y is the max of z, as the backward assumes.
//
// What bounds it on an H100: operations.  It is an implicit GEMM out[co,
// col] = sum_k w[k, co] P[k, col], k = (ci, dy, dx) over K = Ci*F*F and a
// column per conv output (n, oh, ow), n fastest (the CHWN engine's order:
// a run of columns is a run of n, contiguous in CHWN); P is the virtual
// im2col matrix, gathered from x with the padding halo read as zero.
// 2*Co*K FLOPs per output against a few bytes.  fp32 FMA on the CUDA cores
// peaks at 67 TFLOP/s; the tensor cores do 495 TFLOP/s in TF32.
//
// Arithmetic: fp32 accuracy from the tensor cores by the 3xTF32 split of
// K6 (csrc/mma.cuh: big rounded to TF32 in two integer ops, small passed
// raw, three TF32 products a term on mma.sync m16n8k8).  The tensor core
// truncates as it accumulates, so each 32-deep reduction slice is summed
// from zero in the mma registers and then added to fp32 registers.
//
// Design.  A block owns a BM (co: 128, or 64 where Co <= 64 or the block
// pools) x columns tile.  Its 512 threads are two producer warpgroups,
// which only copy, and two consumer warpgroups, which only multiply (K6's
// split: a warp that both issues cp.async and runs mma stalls its mma).
// The producers stage each 32-deep slice of w ([k][co], contiguous along
// co) and of P ([k][column], contiguous along n in CHWN) through a
// 3-stage cp.async ring: 16-byte copies where 4 columns are 4 contiguous,
// aligned, in-range elements, else 4-byte copies with zero fill (the
// padding halo, ragged N, an NCHW source, strided taps).  Named barriers
// pass each stage: FULL when it landed, EMPTY when it was multiplied.
// Both operands arrive reduction-minor, so the m16n8k8 fragments are read
// from [k][m] and [k][n] shared rows whose stride is 8 mod 32 floats.  The
// GEMM's rows and columns are permuted within each 16 so that what one
// lane needs at one k sits side by side: mma row g is channel 2g and row
// g + 8 channel 2g + 1, and column g of a pair of n tiles is column 2g
// (first tile) and 2g + 1 (second); so a fragment is two float2 loads, and
// a half warp's float2 loads (k = t, t + 4) hit 32 banks.
//
// Every pass's sums go through shared memory.  Without a pool a block
// takes 128 consecutive columns, stages its sums in the freed ring, and
// applies bias, residual and ReLU as it stores, a warp along 32 columns
// (a run of n, contiguous in CHWN).  With a pool it owns a rectangle of
// POOLED outputs (ph x pw of them, for nb images) and computes the conv
// outputs under it once, (ph-1)*pS+pF by (pw-1)*pS+pF positions per
// image, in passes of 128 columns, into a shared tile; only the halo rows
// and columns that neighbouring rectangles share are computed twice
// (ops.conv_tiling picks the rectangle and prices the executed FLOPs
// exactly: AlexNet's 3/2 layers execute 1.16-1.28x their direct FLOPs,
// against 2.25x when every window recomputed its taps).  After the last
// pass the block applies the epilogue on the tile, then pools from it and
// stores.  The save_act output z (training) is written from the same
// tile, one writer per conv output: the block whose rectangle starts the
// window rows (columns) it lies in, the last rectangle for the rows past
// them; conv outputs under no window are never written (the wrapper
// zero-fills z then).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/mma.cuh"
#include "../../csrc/nan_max.cuh"
#include "../../csrc/storage.cuh"
#include "conv_common.cuh"  // Strides, layout_strides

namespace {

using namespace repro::mma;
using namespace repro::storage;
using repro::Strides;

constexpr int kConsumers = 256;  // two warpgroups: the mma
constexpr int kProducers = 256;  // two warpgroups: the copies
constexpr int kThreads = kConsumers + kProducers;
constexpr int kConsumerRegs = 168;  // setmaxnreg, as K6
constexpr int kProducerRegs = 80;
constexpr int BN = 128;      // GEMM columns of a pass
constexpr int BK = 32;       // reduction slice, the flush length
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kRowPad = 8;   // shared row stride = width + 8 (8 mod 32)
constexpr int kSmemMax = 232448;
constexpr int kStaticBytes = 3 * BN * 4;  // colofs
constexpr int kPoolBar = 1 + 2 * kStages;  // consumers only

template <typename TX, typename TW>
struct K1Args {
  const TX* x;
  const TW* w;        // [K, Co]
  const TW* bias;     // [Co] or null
  const TW* res;      // conv-output shape, or null
  TW* y;
  TW* z;              // save_act: the pre-pool activation (CHWN), or null
  int N, Ci, H, W, Co, F, S, pad, K, Ho, Wo;
  int pF, pS, pool_avg, relu;  // pF == 0: no pool
  int UH, UW;                  // the pooled output
  int nb, ph, pw;              // pooled rectangle: images, rows, columns
  int tiles_h, tiles_w;        // rectangles along UH and UW
  int cs;                      // row stride of the shared conv tile
  int cols;                    // no pool: N*Ho*Wo columns
  int vec_x, vec_w;            // 16-byte copies allowed
  Strides xs, ys, rs, zs;
};

// the columns of one block: a run of global columns (no pool), or the
// conv outputs under one pooled rectangle, (rh, rw, n) with n fastest
struct Tile {
  int c0;        // no pool: the first global column
  int n0, nbt, ph0, pht, pw0, pwt, oh0, ow0, rht, rwt;
  int C;          // columns of the tile
};

template <typename A>
__device__ __forceinline__ Tile make_tile(const A& a) {
  Tile t;
  if (a.pF == 0) {
    t.c0 = blockIdx.x * BN;
    t.C = min(BN, a.cols - t.c0);
    t.n0 = t.nbt = t.ph0 = t.pht = t.pw0 = t.pwt = 0;
    t.oh0 = t.ow0 = t.rht = t.rwt = 0;
    return t;
  }
  int b = blockIdx.x;
  const int tw = b % a.tiles_w;
  b /= a.tiles_w;
  const int th = b % a.tiles_h, tn = b / a.tiles_h;
  t.c0 = 0;
  t.n0 = tn * a.nb;
  t.nbt = min(a.nb, a.N - t.n0);
  t.ph0 = th * a.ph;
  t.pht = min(a.ph, a.UH - t.ph0);
  t.pw0 = tw * a.pw;
  t.pwt = min(a.pw, a.UW - t.pw0);
  t.oh0 = t.ph0 * a.pS;
  t.ow0 = t.pw0 * a.pS;
  t.rht = (t.pht - 1) * a.pS + a.pF;
  t.rwt = (t.pwt - 1) * a.pS + a.pF;
  t.C = t.nbt * t.rht * t.rwt;
  return t;
}

// (n, oh, ow) of column c of the tile (c < t.C)
template <typename A>
__device__ __forceinline__ void column(const A& a, const Tile& t, int c,
                                       int& n, int& oh, int& ow) {
  if (a.pF == 0) {
    const int gc = t.c0 + c, r = gc / a.N;
    n = gc - r * a.N;
    ow = r % a.Wo;
    oh = r / a.Wo;
  } else {
    const int nl = c % t.nbt, r = c / t.nbt;
    n = t.n0 + nl;
    ow = t.ow0 + r % t.rwt;
    oh = t.oh0 + r / t.rwt;
  }
}

__host__ __device__ constexpr int ring_floats(int bm) {
  return kStages * BK * ((bm + kRowPad) + (BN + kRowPad));
}

// stage s of the ring: FULL and EMPTY barriers (barrier 0 is __syncthreads)
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + kStages + s; }

template <typename TX, typename TW, int BM, bool POOL>
__global__ void __launch_bounds__(kThreads, 1)
conv_chwn_kernel(const K1Args<TX, TW> a) {
  // a w (A) or x (B) operand of a narrow type has no small part
  constexpr bool kAExact = kExactTf32<TW>, kBExact = kExactTf32<TX>;
  constexpr int SA = BM + kRowPad, SB = BN + kRowPad;
  constexpr int STAGE = BK * (SA + SB);
  constexpr int WM = BM / 32;   // consumer warps along co, 32 rows each
  constexpr int WN = 8 / WM;    // consumer warps along the columns
  constexpr int WTN = BN / WN;  // columns per consumer warp
  constexpr int NT = WTN / 8;   // m16n8 tiles per consumer warp
  constexpr int ACH = BM / 4;   // 16-byte chunks of a w row
  constexpr int APT = BK * ACH / kProducers;  // w chunks per producer
  static_assert(WM * WN == 8 && NT % 2 == 0 && APT >= 1, "tile");
  extern __shared__ __align__(16) float smem[];  // ring, then the conv tile
  __shared__ int colofs[3][BN];  // no pool: y, res, z offset of a column

  const Tile t = make_tile(a);
  const int co0 = blockIdx.y * BM;
  const int kslices = (a.K + BK - 1) / BK;
  const int passes = (t.C + BN - 1) / BN;
  const int nsl = passes * kslices;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- the producer warpgroups: every slice's copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int q = pt % 32, row0 = pt / 32;  // P: column chunk, first row
    const int FF = a.F * a.F;
    int cur = -1;          // the pass whose columns xb/ih/iw/ok describe
    int xb[4], ih[4], iw[4];
    bool ok[4], cont = false;
    // (ci, dy, dx) of this thread's P rows row0 + 8 i in the next slice,
    // stepped by BK = (sci, sdy, sdx) in the mixed radix (Ci, F, F)
    int kci[BK / 8], kdy[BK / 8], kdx[BK / 8];
    const int sci = BK / FF, sdy = (BK - sci * FF) / a.F;
    const int sdx = BK - sci * FF - sdy * a.F;
    // Walk slice sl: for each of this thread's P rows i (columns 4q ..
    // 4q + 3) prow(i, p, v, vec) with p = x + the row's k offset (column j
    // at p + xb[j], valid where v[j]; vec: all 4 valid, contiguous and
    // 16-byte aligned), then for each of its w chunks i wchunk(i, src, kin,
    // co): 4 weights from src = w[k][co], kin = (k < K).  Steps the k
    // indices to the next slice's.
    auto walk = [&](int sl, auto&& prow, auto&& wchunk) {
      const int pass = sl / kslices, k0 = (sl - pass * kslices) * BK;
      if (k0 == 0) {  // a pass starts over at k = 0
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          const int k = row0 + 8 * i, ci = k / FF, rem = k - ci * FF;
          kci[i] = ci;
          kdy[i] = rem / a.F;
          kdx[i] = rem - kdy[i] * a.F;
        }
      }
      if (pass != cur) {  // this thread's 4 columns of the new pass
        cur = pass;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = pass * BN + 4 * q + j;
          int n = 0, oh = 0, ow = 0;
          ok[j] = c < t.C;
          if (ok[j]) column(a, t, c, n, oh, ow);
          ih[j] = oh * a.S - a.pad;
          iw[j] = ow * a.S - a.pad;
          xb[j] = n * a.xs.n + ih[j] * a.xs.h + iw[j] * a.xs.w;
        }
        cont = a.vec_x && ok[3] && xb[1] == xb[0] + 1 &&
               xb[2] == xb[0] + 2 && xb[3] == xb[0] + 3;
      }
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int k = k0 + row0 + 8 * i;
        const int dy = kdy[i], dx = kdx[i];
        const int ko = kci[i] * a.xs.c + dy * a.xs.h + dx * a.xs.w;
        // on to the next slice's k
        kdx[i] += sdx;
        if (kdx[i] >= a.F) {
          kdx[i] -= a.F;
          ++kdy[i];
        }
        kdy[i] += sdy;
        if (kdy[i] >= a.F) {
          kdy[i] -= a.F;
          ++kci[i];
        }
        kci[i] += sci;
        bool v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = ok[j] && k < a.K &&
                 static_cast<unsigned>(ih[j] + dy) <
                     static_cast<unsigned>(a.H) &&
                 static_cast<unsigned>(iw[j] + dx) <
                     static_cast<unsigned>(a.W);
        prow(i, a.x + ko, v,
             cont && v[0] && v[1] && v[2] && v[3] && ((xb[0] + ko) & 3) == 0);
      }
      // w: chunk e of the [BK][BM] slice, co fastest
#pragma unroll
      for (int i = 0; i < APT; ++i) {
        const int e = pt + kProducers * i;
        const int r = e / ACH, cq = e - r * ACH;
        const int k = k0 + r, co = co0 + 4 * cq;
        wchunk(i, a.w + static_cast<long long>(k) * a.Co + co, k < a.K, co);
      }
    };
    // the shared-memory floats of P row i and of w chunk i of a stage
    auto prow_at = [&](float* Bs, int i) {
      return Bs + (row0 + 8 * i) * SB + 4 * q;
    };
    auto wchunk_at = [&](float* As, int i) {
      const int e = pt + kProducers * i, r = e / ACH;
      return As + r * SA + 4 * (e - r * ACH);
    };
    // a slice straight into its stage (cp.async for a float32 operand)
    auto stage = [&](int sl) {
      float* As = smem + (sl % kStages) * STAGE;
      float* Bs = As + BK * SA;
      walk(
          sl,
          [&](int i, const TX* p, const bool (&v)[4], bool vec) {
            float* d = prow_at(Bs, i);
            if (vec) {
              copy4(d, p + xb[0], true);
            } else if (!(v[0] || v[1] || v[2] || v[3])) {
              copy4(d, a.x, false);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                copy1(d + j, v[j] ? p + xb[j] : a.x, v[j]);
            }
          },
          [&](int i, const TW* src, bool kin, int co) {
            float* d = wchunk_at(As, i);
            if (kin && a.vec_w && co + 3 < a.Co) {
              copy4(d, src, true);
            } else if (!kin || co >= a.Co) {
              copy4(d, a.w, false);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                copy1(d + j, co + j < a.Co ? src + j : a.w, co + j < a.Co);
            }
          });
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

  // ---- the consumer warpgroups: the products and the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if (!POOL && tid < t.C) {  // y, res and z offsets of column tid (n, oh, ow)
    int n, oh, ow;
    column(a, t, tid, n, oh, ow);
    colofs[0][tid] = n * a.ys.n + oh * a.ys.h + ow * a.ys.w;
    colofs[1][tid] = n * a.rs.n + oh * a.rs.h + ow * a.rs.w;
    colofs[2][tid] = n * a.zs.n + oh * a.zs.h + ow * a.zs.w;
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  float* tile = smem + kStages * STAGE;  // POOL: [BM][cs] conv outputs
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  int sl = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int cvalid = min(BN, t.C - pass * BN);  // columns of this pass
    float total[2][NT][4];
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;
    for (int ks = 0; ks < kslices; ++ks, ++sl) {
      const int buf = sl % kStages;
      bar_sync(full_bar(buf), kThreads);
      const float* As = smem + buf * STAGE;
      const float* Bs = As + BK * SA;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        unsigned abig[2][4], asmall[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // mma row g is shared column 2g of the 16-row block, row g + 8
          // column 2g + 1: a0, a1 (k t) and a2, a3 (k t + 4) as float2
          const float* pa = As + (kk + tq) * SA + wm * 32 + mt * 16 + 2 * g;
          const float2 lo = *reinterpret_cast<const float2*>(pa);
          const float2 hi = *reinterpret_cast<const float2*>(pa + 4 * SA);
          split<kAExact>(lo.x, abig[mt][0], asmall[mt][0]);
          split<kAExact>(lo.y, abig[mt][1], asmall[mt][1]);
          split<kAExact>(hi.x, abig[mt][2], asmall[mt][2]);
          split<kAExact>(hi.y, abig[mt][3], asmall[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          const int nc = wn * WTN + nt * 8;
          if (nc >= cvalid) continue;  // past the pass's last column
          // mma column g of n tiles nt and nt + 1 is shared column 2g and
          // 2g + 1 of their 16: b0 (k t) and b1 (k t + 4) of both as float2
          const float* pb = Bs + (kk + tq) * SB + nc + 2 * g;
          const float2 lo = *reinterpret_cast<const float2*>(pb);
          const float2 hi = *reinterpret_cast<const float2*>(pb + 4 * SB);
          unsigned b0big[2], b0small[2], b1big[2], b1small[2];
          split<kBExact>(lo.x, b0big[0], b0small[0]);
          split<kBExact>(lo.y, b0big[1], b0small[1]);
          split<kBExact>(hi.x, b1big[0], b1small[0]);
          split<kBExact>(hi.y, b1big[1], b1small[1]);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              // the chain's first product (kk == 0) starts from zero
              float (&c)[4] = acc[mt][nt + p];
              bool fresh = kk == 0;
              if constexpr (!kAExact) {
                if (fresh)
                  mma_tf32(c, asmall[mt], b0big[p], b1big[p], zero);
                else
                  mma_tf32(c, asmall[mt], b0big[p], b1big[p], c);
                fresh = false;
              }
              if constexpr (!kBExact) {
                if (fresh)
                  mma_tf32(c, abig[mt], b0small[p], b1small[p], zero);
                else
                  mma_tf32(c, abig[mt], b0small[p], b1small[p], c);
                fresh = false;
              }
              if (fresh)
                mma_tf32(c, abig[mt], b0big[p], b1big[p], zero);
              else
                mma_tf32(c, abig[mt], b0big[p], b1big[p], c);
            }
          }
        }
      }
      // the stage is free for the producers (they wait only for the
      // stages they refill)
      if (sl + kStages < nsl) bar_arrive(empty_bar(buf), kThreads);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (wn * WTN + (nt & ~1) * 8 >= cvalid) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) total[mt][nt][e] += acc[mt][nt][e];
        }
    }

    // the pass's sums into the conv tile, four adjacent columns (of a pair
    // of n tiles) a float4: accumulator e of (mt, nt) is channel wm*32 +
    // mt*16 + 2g + (e >= 2), column 4 tq + 2 (e & 1) + (nt & 1) of the pair
    if (!POOL) bar_sync(kPoolBar, kConsumers);  // the ring is read no more
    float* T = POOL ? tile + pass * BN : smem;
    const int ts = POOL ? a.cs : SB;
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      const int cl = wn * WTN + nt * 8 + 4 * tq;
      if (cl >= cvalid) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(T + (wm * 32 + mt * 16 + 2 * g + h) * ts +
                                     cl) =
              make_float4(total[mt][nt][2 * h], total[mt][nt + 1][2 * h],
                          total[mt][nt][2 * h + 1],
                          total[mt][nt + 1][2 * h + 1]);
    }
  }
  bar_sync(kPoolBar, kConsumers);
  const int mrows = min(BM, a.Co - co0);

  if (!POOL) {
    // bias, residual, ReLU and the stores, a warp along 32 columns: a run
    // of n, contiguous in CHWN; into NCHW, where a block's columns are
    // whole runs of N (N divides 128), the positions of one n come first
    const int npos = (a.ys.n != 1 && BN % a.N == 0) ? BN / a.N : 0;
    for (int e = tid; e < mrows * BN; e += kConsumers) {
      const int m = e / BN, j = e - m * BN;
      const int c = npos ? (j % npos) * a.N + j / npos : j;
      if (c >= t.C) continue;
      const int co = co0 + m;
      float v = smem[m * SB + c];
      if (a.bias) v += ld(a.bias + co);
      if (a.res)
        v += ld(a.res + colofs[1][c] + static_cast<long long>(co) * a.rs.c);
      if (a.relu) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
      put(a.y + colofs[0][c] + static_cast<long long>(co) * a.ys.c, v);
      if (a.z)
        put(a.z + colofs[2][c] + static_cast<long long>(co) * a.zs.c, v);
    }
    return;
  }

  // ---- with a pool: bias, residual, ReLU and z on the tile, then the
  // windows ----
  // one z writer per conv output: rows (columns) before the next
  // rectangle's first window, all of them in the last rectangle; none
  // under no window
  const bool last_h = t.ph0 + t.pht == a.UH, last_w = t.pw0 + t.pwt == a.UW;
  for (int e = tid; e < mrows * t.C; e += kConsumers) {
    const int m = e / t.C, c = e - m * t.C;
    const int co = co0 + m;
    float* p = tile + m * a.cs + c;
    float v = *p;
    if (a.bias) v += ld(a.bias + co);
    if (a.res || a.z) {
      const int nl = c % t.nbt, r = c / t.nbt;
      const int rw = r % t.rwt, rh = r / t.rwt;
      const long long n = t.n0 + nl;
      const int oh = t.oh0 + rh, ow = t.ow0 + rw;
      if (a.res)
        v += ld(a.res + n * a.rs.n + static_cast<long long>(co) * a.rs.c +
                oh * a.rs.h + ow * a.rs.w);
      if (a.relu) v = v < 0.f ? 0.f : v;
      if (a.z && (rh < t.pht * a.pS || last_h) && rh % a.pS < a.pF &&
          (rw < t.pwt * a.pS || last_w) && rw % a.pS < a.pF)
        put(a.z + n * a.zs.n + static_cast<long long>(co) * a.zs.c +
                oh * a.zs.h + ow * a.zs.w,
            v);
    } else if (a.relu) {
      v = v < 0.f ? 0.f : v;
    }
    *p = v;
  }
  bar_sync(kPoolBar, kConsumers);
  const int outs = t.pht * t.pwt * t.nbt;
  const float area = static_cast<float>(a.pF * a.pF);
  for (int e = tid; e < mrows * outs; e += kConsumers) {
    const int m = e / outs;
    int r = e - m * outs;
    const int nl = r % t.nbt;
    r /= t.nbt;
    const int pwl = r % t.pwt, phl = r / t.pwt;
    const float* row = tile + m * a.cs;
    float acc = a.pool_avg ? 0.f : -INFINITY;
    for (int i = 0; i < a.pF; ++i)
      for (int j = 0; j < a.pF; ++j) {
        const float v =
            row[((phl * a.pS + i) * t.rwt + pwl * a.pS + j) * t.nbt + nl];
        acc = a.pool_avg ? acc + v : nan_max(acc, v);
      }
    put(a.y + static_cast<long long>(t.n0 + nl) * a.ys.n +
            static_cast<long long>(co0 + m) * a.ys.c +
            (t.ph0 + phl) * a.ys.h + (t.pw0 + pwl) * a.ys.w,
        a.pool_avg ? acc / area : acc);
  }
}

template <int BM, bool POOL, typename TX, typename TW>
cudaError_t launch(const K1Args<TX, TW>& a, int blocks, int smem,
                   cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv_chwn_kernel<TX, TW, BM, POOL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, (a.Co + BM - 1) / BM);
  conv_chwn_kernel<TX, TW, BM, POOL><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// ---- the narrow builds: bf16 w with bf16 or int8 x, on bf16 tensor cores ---
//
// Instantiated only by the bf16 and int8->bf16 builds (forward below).  The
// block tile, the producer/consumer split, the FULL/EMPTY hand-off, the
// passes and the whole epilogue are the float32 kernel's; what differs is
// the ring and the products.  The ring holds bf16: a stage is a 64-deep
// slice (kNBK, four k16 steps: the bytes of the float32 kernel's 32-deep
// one) of w ([k][co]) and P ([k][column]), each row of 16-byte chunks
// XOR-swizzled by the row (mma.cuh::swz), so the 8 rows one ldmatrix reads
// lie in 8 bank groups.  Both operands are MN-major (co, column fastest);
// ldmatrix.trans turns them into the m16n8k16 fragments, and the bf16
// products (exact in fp32) are summed in fp32 on the tensor cores, each
// 64-deep slice from zero in the mma registers and then added to fp32
// registers (an unflushed chain over K 4608 and 6400 held the bf16 gate on
// the card too: tools/chain_accuracy.py).
//
// Producers fill a chunk of 8 columns of a P row by one 16-byte cp.async
// where the 8 are 8 consecutive, 16-byte-aligned, in-range elements of x (a
// run of n in CHWN with N a multiple of 8: every CHWN launch of the main
// path), by a zero-filling one where none is in range, and else element by
// element through registers, packed into bf16 pairs and stored as 16 bytes
// (the padding halo's edge, ragged N, an NCHW source, strided 1x1 taps).
// int8 x is widened to bf16 in registers (exact: |q| <= 127): a run of 8 is
// one 8-byte load, issued before the producer waits for its stage to be
// free, so the wait hides it.  A w chunk (8 output channels) is one 16-byte
// cp.async where Co % 8 == 0 and all 8 are below Co, else elements.
//
// What bounds it: by its work, operations, at the bf16 tensor cores' 989
// TFLOP/s; as built, its producers: each slice's copies are issued by 256
// threads that compute their own addresses, and timed alone (consumers
// that multiply nothing) they take most of the kernel's time, while
// halving the bytes they move barely changes it (PERF.md, Findings;
// tools/storage_variants.py --timing-only).  TMA, which computes the
// addresses in hardware, and wgmma are the next step.
constexpr int kNBK = 64;            // reduction slice, the flush length
constexpr int kNRows = kNBK / 16;   // P rows of a producer thread

__host__ __device__ constexpr int narrow_ring_bytes(int bm) {
  return kStages * kNBK * (bm + BN) * 2;
}

template <typename TX, int BM, bool POOL>
__global__ void __launch_bounds__(kThreads, 1)
conv_chwn_narrow_kernel(const K1Args<TX, bf16> a) {
  constexpr bool kI8 = std::is_same<TX, int8_t>::value;
  constexpr int STAGE = kNBK * (BM + BN);  // bf16 elements of a stage
  constexpr int SB = BN + kRowPad;         // float row stride of the sums
  constexpr int WM = BM / 32;   // consumer warps along co, 32 rows each
  constexpr int WN = 8 / WM;    // consumer warps along the columns
  constexpr int WTN = BN / WN;  // columns per consumer warp
  constexpr int NT = WTN / 8;   // m16n8 tiles per consumer warp
  constexpr int WCH = BM / 8;   // 16-byte chunks of a w row
  constexpr int WPT = kNBK * WCH / kProducers;  // w chunks per producer
  static_assert(WM * WN == 8 && NT % 2 == 0 && WPT >= 1, "tile");
  extern __shared__ __align__(128) unsigned char smem_n[];
  bf16* const ring = reinterpret_cast<bf16*>(smem_n);
  __shared__ int colofs[3][BN];  // no pool: y, res, z offset of a column

  const Tile t = make_tile(a);
  const int co0 = blockIdx.y * BM;
  const int kslices = (a.K + kNBK - 1) / kNBK;
  const int passes = (t.C + BN - 1) / BN;
  const int nsl = passes * kslices;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- the producer warpgroups: every slice's copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int q = pt % 16, row0 = pt / 16;  // P: 8-column chunk, first row
    const int FF = a.F * a.F;
    int cur = -1;  // the pass whose columns xb/ih/iw describe
    // this thread's 8 columns: x offset and first input row and column of
    // each (ih far out of range past the tile's last column)
    int xb[8], ih[8], iw[8];
    // the 8 are 8 consecutive elements of x at one input position (a run
    // of n): one bounds test covers them
    bool cont = false;
    // (ci, dy, dx) of this thread's P rows row0 + 16 i in the next slice,
    // stepped by kNBK in the mixed radix (Ci, F, F)
    int kci[kNRows], kdy[kNRows], kdx[kNRows];
    const int sci = kNBK / FF, sdy = (kNBK - sci * FF) / a.F;
    const int sdx = kNBK - sci * FF - sdy * a.F;
    auto stage = [&](int sl) {
      const int pass = sl / kslices, k0 = (sl - pass * kslices) * kNBK;
      if (k0 == 0) {  // a pass starts over at k = 0
#pragma unroll
        for (int i = 0; i < kNRows; ++i) {
          const int k = row0 + 16 * i, ci = k / FF, rem = k - ci * FF;
          kci[i] = ci;
          kdy[i] = rem / a.F;
          kdx[i] = rem - kdy[i] * a.F;
        }
      }
      if (pass != cur) {  // this thread's 8 columns of the new pass
        cur = pass;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = pass * BN + 8 * q + j;
          int n = 0, oh = 0, ow = 0;
          const bool ok = c < t.C;
          if (ok) column(a, t, c, n, oh, ow);
          ih[j] = ok ? oh * a.S - a.pad : -0x40000000;
          iw[j] = ow * a.S - a.pad;
          xb[j] = n * a.xs.n + (oh * a.S - a.pad) * a.xs.h + iw[j] * a.xs.w;
        }
        cont = a.vec_x;
#pragma unroll
        for (int j = 1; j < 8; ++j)
          cont = cont && xb[j] == xb[0] + j && ih[j] == ih[0] &&
                 iw[j] == iw[0];
      }
      // each P row's x offset (ko) and its columns in range (bits 0-7;
      // bit 8: a whole aligned run of 8), then, for int8, the run's load
      int ko[kNRows];
      unsigned vm[kNRows];
      uint2 raw[kNRows];
#pragma unroll
      for (int i = 0; i < kNRows; ++i) {
        const int k = k0 + row0 + 16 * i;
        const int dy = kdy[i], dx = kdx[i];
        ko[i] = kci[i] * a.xs.c + dy * a.xs.h + dx * a.xs.w;
        // on to the next slice's k
        kdx[i] += sdx;
        if (kdx[i] >= a.F) {
          kdx[i] -= a.F;
          ++kdy[i];
        }
        kdy[i] += sdy;
        if (kdy[i] >= a.F) {
          kdy[i] -= a.F;
          ++kci[i];
        }
        kci[i] += sci;
        unsigned m = 0;
        if (cont) {
          if (k < a.K &&
              static_cast<unsigned>(ih[0] + dy) < static_cast<unsigned>(a.H) &&
              static_cast<unsigned>(iw[0] + dx) < static_cast<unsigned>(a.W))
            m = ((xb[0] + ko[i]) & 7) == 0 ? 0x1ffu : 0xffu;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            m |= static_cast<unsigned>(
                     k < a.K &&
                     static_cast<unsigned>(ih[j] + dy) <
                         static_cast<unsigned>(a.H) &&
                     static_cast<unsigned>(iw[j] + dx) <
                         static_cast<unsigned>(a.W))
                 << j;
        }
        vm[i] = m;
        if constexpr (kI8) {
          if (m & 0x100u)
            raw[i] = __ldg(reinterpret_cast<const uint2*>(a.x + xb[0] + ko[i]));
        }
      }
      if (sl >= kStages) bar_sync(empty_bar(sl % kStages), kThreads);
      bf16* As = ring + (sl % kStages) * STAGE;
      bf16* Bs = As + kNBK * BM;
#pragma unroll
      for (int i = 0; i < kNRows; ++i) {
        bf16* d = Bs + swz<BN>(row0 + 16 * i, q);
        const TX* p = a.x + ko[i];
        if (vm[i] == 0) {
          cp16(d, a.x, false);
        } else if (vm[i] & 0x100u) {
          if constexpr (kI8)
            *reinterpret_cast<uint4*>(d) = bf16x8(raw[i]);
          else
            cp16(d, p + xb[0], true);
        } else {
          unsigned e[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bool v = (vm[i] >> j) & 1u;
            e[j] = bf16_bits(v ? p + xb[j] : a.x, v);
          }
          *reinterpret_cast<uint4*>(d) =
              make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                         e[4] | (e[5] << 16), e[6] | (e[7] << 16));
        }
      }
      // w: chunk e of the [kNBK][BM] slice, co fastest
#pragma unroll
      for (int i = 0; i < WPT; ++i) {
        const int e = pt + kProducers * i;
        const int r = e / WCH, cq = e - r * WCH;
        const int k = k0 + r, co = co0 + 8 * cq;
        bf16* d = As + swz<BM>(r, cq);
        const bf16* src = a.w + static_cast<long long>(k) * a.Co + co;
        if (k >= a.K || co >= a.Co) {
          cp16(d, a.w, false);
        } else if (a.vec_w && co + 7 < a.Co) {
          cp16(d, src, true);
        } else {
          unsigned v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = bf16_bits(co + j < a.Co ? src + j : a.w, co + j < a.Co);
          *reinterpret_cast<uint4*>(d) =
              make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                         v[4] | (v[5] << 16), v[6] | (v[7] << 16));
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
      if (nx < nsl) stage(nx);  // waits for the stage to be free
      cp_commit();
    }
    return;
  }

  // ---- the consumer warpgroups: the products and the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if (!POOL && tid < t.C) {  // y, res and z offsets of column tid (n, oh, ow)
    int n, oh, ow;
    column(a, t, tid, n, oh, ow);
    colofs[0][tid] = n * a.ys.n + oh * a.ys.h + ow * a.ys.w;
    colofs[1][tid] = n * a.rs.n + oh * a.rs.h + ow * a.rs.w;
    colofs[2][tid] = n * a.zs.n + oh * a.zs.h + ow * a.zs.w;
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  // the row (k) and 16-byte chunk of this lane's ldmatrix.trans address: A
  // matrices (co 0-7, k 0-7), (co 8-15, k 0-7), (co 0-7, k 8-15), (co 8-15,
  // k 8-15); B (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15,
  // n 8-15)
  const int ar = (lane & 7) + ((lane >> 4) << 3), ac = (lane >> 3) & 1;
  const int br = (lane & 7) + (((lane >> 3) & 1) << 3), bc = lane >> 4;
  // their swizzled offsets in a stage: a k16 step adds 16 rows, which
  // leaves the row's XOR term (row mod 8) as it is
  int aoff[2], boff[NT / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    aoff[mt] = swz<BM>(ar, (wm * 32 + mt * 16) / 8 + ac);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    boff[np] = swz<BN>(br, (wn * WTN + np * 16) / 8 + bc);
  float* sums = reinterpret_cast<float*>(smem_n);  // no pool: over the ring
  float* tile = reinterpret_cast<float*>(smem_n + narrow_ring_bytes(BM));
  int sl = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int cvalid = min(BN, t.C - pass * BN);  // columns of this pass
    const bool busy = wn * WTN < cvalid;  // the warp holds a column
    float total[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;
    for (int ks = 0; ks < kslices; ++ks, ++sl) {
      const int buf = sl % kStages;
      bar_sync(full_bar(buf), kThreads);
      if (busy) {
        const bf16* As = ring + buf * STAGE;
        const bf16* Bs = As + kNBK * BM;
        // every k16 step, those past K too (zero-filled): no branch
        // between the steps' fragment loads and products
        float acc[2][NT][4];
#pragma unroll
        for (int kk = 0; kk < kNBK / 16; ++kk) {
          unsigned af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4_t(af[mt], As + aoff[mt] + 16 * kk * BM);
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2) {
            unsigned bq[4];
            ldsm_x4_t(bq, Bs + boff[nt / 2] + 16 * kk * BN);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              // the chain's first product (kk == 0) starts from zero
              if (kk == 0) {
                mma_bf16_z(acc[mt][nt], af[mt], bq[0], bq[1]);
                mma_bf16_z(acc[mt][nt + 1], af[mt], bq[2], bq[3]);
              } else {
                mma_bf16(acc[mt][nt], af[mt], bq[0], bq[1]);
                mma_bf16(acc[mt][nt + 1], af[mt], bq[2], bq[3]);
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) total[mt][nt][e] += acc[mt][nt][e];
      }
      // the stage is free for the producers (they wait only for the
      // stages they refill)
      if (sl + kStages < nsl) bar_arrive(empty_bar(buf), kThreads);
    }

    // the pass's sums into the conv tile: accumulator e of (mt, nt) is
    // channel wm*32 + mt*16 + g + 8 (e >= 2), column nt*8 + 2 tq + (e & 1)
    // of the warp's
    if (!POOL) bar_sync(kPoolBar, kConsumers);  // the ring is read no more
    float* T = POOL ? tile + pass * BN : sums;
    const int ts = POOL ? a.cs : SB;
    if (busy) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cl = wn * WTN + nt * 8 + 2 * tq;
        if (cl >= cvalid) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* r = T + (wm * 32 + mt * 16 + g) * ts + cl;
          *reinterpret_cast<float2*>(r) =
              make_float2(total[mt][nt][0], total[mt][nt][1]);
          *reinterpret_cast<float2*>(r + 8 * ts) =
              make_float2(total[mt][nt][2], total[mt][nt][3]);
        }
      }
    }
  }
  bar_sync(kPoolBar, kConsumers);
  const int mrows = min(BM, a.Co - co0);

  // the float32 kernel's epilogue, from here on as it is there
  if (!POOL) {
    const int npos = (a.ys.n != 1 && BN % a.N == 0) ? BN / a.N : 0;
    for (int e = tid; e < mrows * BN; e += kConsumers) {
      const int m = e / BN, j = e - m * BN;
      const int c = npos ? (j % npos) * a.N + j / npos : j;
      if (c >= t.C) continue;
      const int co = co0 + m;
      float v = sums[m * SB + c];
      if (a.bias) v += ld(a.bias + co);
      if (a.res)
        v += ld(a.res + colofs[1][c] + static_cast<long long>(co) * a.rs.c);
      if (a.relu) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
      put(a.y + colofs[0][c] + static_cast<long long>(co) * a.ys.c, v);
      if (a.z)
        put(a.z + colofs[2][c] + static_cast<long long>(co) * a.zs.c, v);
    }
    return;
  }
  const bool last_h = t.ph0 + t.pht == a.UH, last_w = t.pw0 + t.pwt == a.UW;
  for (int e = tid; e < mrows * t.C; e += kConsumers) {
    const int m = e / t.C, c = e - m * t.C;
    const int co = co0 + m;
    float* p = tile + m * a.cs + c;
    float v = *p;
    if (a.bias) v += ld(a.bias + co);
    if (a.res || a.z) {
      const int nl = c % t.nbt, r = c / t.nbt;
      const int rw = r % t.rwt, rh = r / t.rwt;
      const long long n = t.n0 + nl;
      const int oh = t.oh0 + rh, ow = t.ow0 + rw;
      if (a.res)
        v += ld(a.res + n * a.rs.n + static_cast<long long>(co) * a.rs.c +
                oh * a.rs.h + ow * a.rs.w);
      if (a.relu) v = v < 0.f ? 0.f : v;
      if (a.z && (rh < t.pht * a.pS || last_h) && rh % a.pS < a.pF &&
          (rw < t.pwt * a.pS || last_w) && rw % a.pS < a.pF)
        put(a.z + n * a.zs.n + static_cast<long long>(co) * a.zs.c +
                oh * a.zs.h + ow * a.zs.w,
            v);
    } else if (a.relu) {
      v = v < 0.f ? 0.f : v;
    }
    *p = v;
  }
  bar_sync(kPoolBar, kConsumers);
  const int outs = t.pht * t.pwt * t.nbt;
  const float area = static_cast<float>(a.pF * a.pF);
  for (int e = tid; e < mrows * outs; e += kConsumers) {
    const int m = e / outs;
    int r = e - m * outs;
    const int nl = r % t.nbt;
    r /= t.nbt;
    const int pwl = r % t.pwt, phl = r / t.pwt;
    const float* row = tile + m * a.cs;
    float acc = a.pool_avg ? 0.f : -INFINITY;
    for (int i = 0; i < a.pF; ++i)
      for (int j = 0; j < a.pF; ++j) {
        const float v =
            row[((phl * a.pS + i) * t.rwt + pwl * a.pS + j) * t.nbt + nl];
        acc = a.pool_avg ? acc + v : nan_max(acc, v);
      }
    put(a.y + static_cast<long long>(t.n0 + nl) * a.ys.n +
            static_cast<long long>(co0 + m) * a.ys.c +
            (t.ph0 + phl) * a.ys.h + (t.pw0 + pwl) * a.ys.w,
        a.pool_avg ? acc / area : acc);
  }
}

template <int BM, bool POOL, typename TX>
cudaError_t launch_narrow(const K1Args<TX, bf16>& a, int blocks, int smem,
                          cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv_chwn_narrow_kernel<TX, BM, POOL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, (a.Co + BM - 1) / BM);
  conv_chwn_narrow_kernel<TX, BM, POOL><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// ---- the int8->fp32 build: int8 x, float32 w, on bf16 tensor cores -----
//
// Instantiated only by the int8->fp32 build (forward below; the
// calibration's int8 row).  The block tile, the producer/consumer split,
// the passes and the epilogue are the float32 kernel's; the ring and the
// products differ.  An int8 value is exact in bf16 (|q| <= 127), so x
// goes the narrow kernels' way: widened to bf16 in registers (a run of 8,
// one 8-byte load issued before the producer waits for its stage; the
// halo, ragged N and NCHW element by element) into a bf16 P ring of
// XOR-swizzled 16-byte chunks, read by ldmatrix.trans.  w stays float32:
// 16-byte cp.async into rows of BM + 4 floats (so a quarter warp's float2
// fragment loads hit 32 banks), and the consumers cut each pair of
// weights into three bf16 parts (storage::split3: hi, md, lo, exact), so
// a term is three mma.sync m16n8k16 products of exact bf16 values, each
// exact in fp32: fp32 accuracy at three bf16 products a term (3 / 989 of
// tensor time against 3xTF32's 2 / 495 with x exact).  Rows of the GEMM
// are permuted within each 16 as in the float32 kernel (mma row g is
// channel 2g, row g + 8 channel 2g + 1), so a fragment is float2 loads.
// The tensor core truncates as it accumulates: each k16 step's three
// products (lo, md, hi) are a chain from zero, added to fp32 registers at
// once (flushed every 16 terms; the float32 kernel flushes every 32), so
// four independent chains (two channel tiles by two column tiles)
// interleave and the consumers' registers hold no second set of sums.
// Its ring (4 stages of 32-deep slices) is smaller than the float32
// kernel's 3, so conv_tiling's tiles fit as they are (ops.k1_i8f32_smem).
//
// What bounds it: operations, at the bf16 tensor cores' 989 TFLOP/s over
// three products a term; as built, neither side alone: timed apart, the
// consumers (fragment loads, the split, each chain's fp32 adds) and the
// producers (16 KB of float32 w a slice from L2, x through registers)
// each take most of the kernel's time (tools/storage_variants.py
// --timing-only; PERF.md, Findings).  TMA (w multicast across the blocks
// that share it) and wgmma are the next step.
constexpr int kIBK = 32;                // reduction slice
constexpr int kIStages = 4;             // ring depth
constexpr int kIRows = kIBK / 16;       // P rows of a producer thread
constexpr int kIPad = 4;                // w row stride: BM + 4 floats
constexpr int kIPoolBar = 1 + 2 * kIStages;  // consumers only

__host__ __device__ constexpr int i8f32_ring_bytes(int bm) {
  return kIStages * kIBK * ((bm + kIPad) * 4 + BN * 2);
}
__device__ __forceinline__ int i8_full(int s) { return 1 + s; }
__device__ __forceinline__ int i8_empty(int s) { return 1 + kIStages + s; }

// bias, residual, ReLU, z and the stores of a block's sums: sums[m * SB +
// c] (no pool; SB = BN + kRowPad) or the conv tile (a pool), as the float32
// kernel's epilogue
template <bool POOL, typename A>
__device__ __forceinline__ void epilogue(const A& a, const Tile& t, int co0,
                                         int mrows, const float* sums,
                                         float* tile, const int (*colofs)[BN],
                                         int bar) {
  const int tid = threadIdx.x;
  if (!POOL) {
    const int npos = (a.ys.n != 1 && BN % a.N == 0) ? BN / a.N : 0;
    for (int e = tid; e < mrows * BN; e += kConsumers) {
      const int m = e / BN, j = e - m * BN;
      const int c = npos ? (j % npos) * a.N + j / npos : j;
      if (c >= t.C) continue;
      const int co = co0 + m;
      float v = sums[m * (BN + kRowPad) + c];
      if (a.bias) v += ld(a.bias + co);
      if (a.res)
        v += ld(a.res + colofs[1][c] + static_cast<long long>(co) * a.rs.c);
      if (a.relu) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
      put(a.y + colofs[0][c] + static_cast<long long>(co) * a.ys.c, v);
      if (a.z)
        put(a.z + colofs[2][c] + static_cast<long long>(co) * a.zs.c, v);
    }
    return;
  }
  const bool last_h = t.ph0 + t.pht == a.UH, last_w = t.pw0 + t.pwt == a.UW;
  for (int e = tid; e < mrows * t.C; e += kConsumers) {
    const int m = e / t.C, c = e - m * t.C;
    const int co = co0 + m;
    float* p = tile + m * a.cs + c;
    float v = *p;
    if (a.bias) v += ld(a.bias + co);
    if (a.res || a.z) {
      const int nl = c % t.nbt, r = c / t.nbt;
      const int rw = r % t.rwt, rh = r / t.rwt;
      const long long n = t.n0 + nl;
      const int oh = t.oh0 + rh, ow = t.ow0 + rw;
      if (a.res)
        v += ld(a.res + n * a.rs.n + static_cast<long long>(co) * a.rs.c +
                oh * a.rs.h + ow * a.rs.w);
      if (a.relu) v = v < 0.f ? 0.f : v;
      if (a.z && (rh < t.pht * a.pS || last_h) && rh % a.pS < a.pF &&
          (rw < t.pwt * a.pS || last_w) && rw % a.pS < a.pF)
        put(a.z + n * a.zs.n + static_cast<long long>(co) * a.zs.c +
                oh * a.zs.h + ow * a.zs.w,
            v);
    } else if (a.relu) {
      v = v < 0.f ? 0.f : v;
    }
    *p = v;
  }
  bar_sync(bar, kConsumers);
  const int outs = t.pht * t.pwt * t.nbt;
  const float area = static_cast<float>(a.pF * a.pF);
  for (int e = tid; e < mrows * outs; e += kConsumers) {
    const int m = e / outs;
    int r = e - m * outs;
    const int nl = r % t.nbt;
    r /= t.nbt;
    const int pwl = r % t.pwt, phl = r / t.pwt;
    const float* row = tile + m * a.cs;
    float acc = a.pool_avg ? 0.f : -INFINITY;
    for (int i = 0; i < a.pF; ++i)
      for (int j = 0; j < a.pF; ++j) {
        const float v =
            row[((phl * a.pS + i) * t.rwt + pwl * a.pS + j) * t.nbt + nl];
        acc = a.pool_avg ? acc + v : nan_max(acc, v);
      }
    put(a.y + static_cast<long long>(t.n0 + nl) * a.ys.n +
            static_cast<long long>(co0 + m) * a.ys.c +
            (t.ph0 + phl) * a.ys.h + (t.pw0 + pwl) * a.ys.w,
        a.pool_avg ? acc / area : acc);
  }
}

template <int BM, bool POOL>
__global__ void __launch_bounds__(kThreads, 1)
conv_chwn_i8f32_kernel(const K1Args<int8_t, float> a) {
  constexpr int SA = BM + kIPad;          // float row stride of the w ring
  constexpr int ABYTES = kIBK * SA * 4;   // w slice of a stage
  constexpr int STAGE = ABYTES + kIBK * BN * 2;  // bytes of a stage
  constexpr int SB = BN + kRowPad;        // float row stride of the sums
  constexpr int WM = BM / 32;   // consumer warps along co, 32 rows each
  constexpr int WN = 8 / WM;    // consumer warps along the columns
  constexpr int WTN = BN / WN;  // columns per consumer warp
  constexpr int NT = WTN / 8;   // m16n8 tiles per consumer warp
  constexpr int ACH = BM / 4;   // 16-byte chunks of a w row
  constexpr int APT = kIBK * ACH / kProducers;  // w chunks per producer
  static_assert(WM * WN == 8 && NT % 2 == 0 && APT >= 1, "tile");
  static_assert((2 * SA) % 32 == 8, "w fragment loads: 32 banks");
  extern __shared__ __align__(128) unsigned char smem_i[];
  __shared__ int colofs[3][BN];  // no pool: y, res, z offset of a column

  const Tile t = make_tile(a);
  const int co0 = blockIdx.y * BM;
  const int kslices = (a.K + kIBK - 1) / kIBK;
  const int passes = (t.C + BN - 1) / BN;
  const int nsl = passes * kslices;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- the producer warpgroups: every slice's copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int q = pt % 16, row0 = pt / 16;  // P: 8-column chunk, first row
    const int FF = a.F * a.F;
    int cur = -1;  // the pass whose columns xb/ih/iw describe
    // this thread's 8 columns: x offset and first input row and column of
    // each (ih far out of range past the tile's last column)
    int xb[8], ih[8], iw[8];
    bool cont = false;  // the 8 are 8 consecutive elements of x (a run of n)
    // (ci, dy, dx) of this thread's P rows row0 + 16 i in the next slice,
    // stepped by kIBK in the mixed radix (Ci, F, F)
    int kci[kIRows], kdy[kIRows], kdx[kIRows];
    const int sci = kIBK / FF, sdy = (kIBK - sci * FF) / a.F;
    const int sdx = kIBK - sci * FF - sdy * a.F;
    auto stage = [&](int sl) {
      const int pass = sl / kslices, k0 = (sl - pass * kslices) * kIBK;
      if (k0 == 0) {  // a pass starts over at k = 0
#pragma unroll
        for (int i = 0; i < kIRows; ++i) {
          const int k = row0 + 16 * i, ci = k / FF, rem = k - ci * FF;
          kci[i] = ci;
          kdy[i] = rem / a.F;
          kdx[i] = rem - kdy[i] * a.F;
        }
      }
      if (pass != cur) {  // this thread's 8 columns of the new pass
        cur = pass;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = pass * BN + 8 * q + j;
          int n = 0, oh = 0, ow = 0;
          const bool ok = c < t.C;
          if (ok) column(a, t, c, n, oh, ow);
          ih[j] = ok ? oh * a.S - a.pad : -0x40000000;
          iw[j] = ow * a.S - a.pad;
          xb[j] = n * a.xs.n + (oh * a.S - a.pad) * a.xs.h + iw[j] * a.xs.w;
        }
        cont = a.vec_x;
#pragma unroll
        for (int j = 1; j < 8; ++j)
          cont = cont && xb[j] == xb[0] + j && ih[j] == ih[0] &&
                 iw[j] == iw[0];
      }
      // each P row's x offset (ko) and its columns in range (bits 0-7;
      // bit 8: a whole aligned run of 8, loaded now)
      int ko[kIRows];
      unsigned vm[kIRows];
      uint2 raw[kIRows];
#pragma unroll
      for (int i = 0; i < kIRows; ++i) {
        const int k = k0 + row0 + 16 * i;
        const int dy = kdy[i], dx = kdx[i];
        ko[i] = kci[i] * a.xs.c + dy * a.xs.h + dx * a.xs.w;
        // on to the next slice's k
        kdx[i] += sdx;
        if (kdx[i] >= a.F) {
          kdx[i] -= a.F;
          ++kdy[i];
        }
        kdy[i] += sdy;
        if (kdy[i] >= a.F) {
          kdy[i] -= a.F;
          ++kci[i];
        }
        kci[i] += sci;
        unsigned m = 0;
        if (cont) {
          if (k < a.K &&
              static_cast<unsigned>(ih[0] + dy) < static_cast<unsigned>(a.H) &&
              static_cast<unsigned>(iw[0] + dx) < static_cast<unsigned>(a.W))
            m = ((xb[0] + ko[i]) & 7) == 0 ? 0x1ffu : 0xffu;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            m |= static_cast<unsigned>(
                     k < a.K &&
                     static_cast<unsigned>(ih[j] + dy) <
                         static_cast<unsigned>(a.H) &&
                     static_cast<unsigned>(iw[j] + dx) <
                         static_cast<unsigned>(a.W))
                 << j;
        }
        vm[i] = m;
        if (m & 0x100u)
          raw[i] = __ldg(reinterpret_cast<const uint2*>(a.x + xb[0] + ko[i]));
      }
      if (sl >= kIStages) bar_sync(i8_empty(sl % kIStages), kThreads);
      unsigned char* st = smem_i + (sl % kIStages) * STAGE;
      float* As = reinterpret_cast<float*>(st);
      bf16* Bs = reinterpret_cast<bf16*>(st + ABYTES);
#pragma unroll
      for (int i = 0; i < kIRows; ++i) {
        bf16* d = Bs + swz<BN>(row0 + 16 * i, q);
        const int8_t* p = a.x + ko[i];
        if (vm[i] == 0) {
          cp16(d, a.x, false);
        } else if (vm[i] & 0x100u) {
          *reinterpret_cast<uint4*>(d) = bf16x8(raw[i]);
        } else {
          unsigned e[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bool v = (vm[i] >> j) & 1u;
            e[j] = bf16_bits(v ? p + xb[j] : a.x, v);
          }
          *reinterpret_cast<uint4*>(d) =
              make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                         e[4] | (e[5] << 16), e[6] | (e[7] << 16));
        }
      }
      // w: chunk e of the [kIBK][BM] slice, co fastest, by 16-byte cp.async
#pragma unroll
      for (int i = 0; i < APT; ++i) {
        const int e = pt + kProducers * i;
        const int r = e / ACH, cq = e - r * ACH;
        const int k = k0 + r, co = co0 + 4 * cq;
        float* d = As + r * SA + 4 * cq;
        const float* src = a.w + static_cast<long long>(k) * a.Co + co;
        if (k < a.K && a.vec_w && co + 3 < a.Co) {
          cp16(d, src, true);
        } else if (k >= a.K || co >= a.Co) {
          cp16(d, a.w, false);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cp4(d + j, co + j < a.Co ? src + j : a.w, co + j < a.Co);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kIStages - 1; ++s) {
      if (s < nsl) stage(s);
      cp_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      cp_wait<kIStages - 2>();  // slice sl has landed: announce it
      bar_arrive(i8_full(sl % kIStages), kThreads);
      const int nx = sl + kIStages - 1;
      if (nx < nsl) stage(nx);  // waits for the stage to be free
      cp_commit();
    }
    return;
  }

  // ---- the consumer warpgroups: the products and the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if (!POOL && tid < t.C) {  // y, res and z offsets of column tid (n, oh, ow)
    int n, oh, ow;
    column(a, t, tid, n, oh, ow);
    colofs[0][tid] = n * a.ys.n + oh * a.ys.h + ow * a.ys.w;
    colofs[1][tid] = n * a.rs.n + oh * a.rs.h + ow * a.rs.w;
    colofs[2][tid] = n * a.zs.n + oh * a.zs.h + ow * a.zs.w;
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  // B: the row (k) and 16-byte chunk of this lane's ldmatrix.trans address
  // ((k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)),
  // swizzled; a k16 step adds 16 rows, which leaves the XOR term as it is
  const int br = (lane & 7) + (((lane >> 3) & 1) << 3), bc = lane >> 4;
  int boff[NT / 2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    boff[np] = swz<BN>(br, (wn * WTN + np * 16) / 8 + bc);
  // A: this lane's float2 of channels (2g, 2g + 1) at k = 2 tq of the step
  const int aoff = 2 * tq * SA + wm * 32 + 2 * g;
  float* sums = reinterpret_cast<float*>(smem_i);  // no pool: over the ring
  float* tile = reinterpret_cast<float*>(smem_i + i8f32_ring_bytes(BM));
  int sl = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int cvalid = min(BN, t.C - pass * BN);  // columns of this pass
    const bool busy = wn * WTN < cvalid;  // the warp holds a column
    float total[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0.f;
    for (int ks = 0; ks < kslices; ++ks, ++sl) {
      const int buf = sl % kIStages;
      bar_sync(i8_full(buf), kThreads);
      if (busy) {
        const unsigned char* st = smem_i + buf * STAGE;
        const float* As = reinterpret_cast<const float*>(st);
        const bf16* Bs = reinterpret_cast<const bf16*>(st + ABYTES);
        // every k16 step, those past K too (zero-filled): no branch
        // between the steps' fragment loads and products
#pragma unroll
        for (int kk = 0; kk < kIBK / 16; ++kk) {
          // w's three parts: a0 (row g: k 2tq, 2tq + 1), a1 (row g + 8),
          // a2, a3 (k + 8); rows g and g + 8 are channels 2g and 2g + 1
          unsigned ahi[2][4], amd[2][4], alo[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* pa = As + aoff + 16 * kk * SA + mt * 16;
            const float2 k0 = *reinterpret_cast<const float2*>(pa);
            const float2 k1 = *reinterpret_cast<const float2*>(pa + SA);
            const float2 k8 = *reinterpret_cast<const float2*>(pa + 8 * SA);
            const float2 k9 = *reinterpret_cast<const float2*>(pa + 9 * SA);
            split3(k0.x, k1.x, ahi[mt][0], amd[mt][0], alo[mt][0]);
            split3(k0.y, k1.y, ahi[mt][1], amd[mt][1], alo[mt][1]);
            split3(k8.x, k9.x, ahi[mt][2], amd[mt][2], alo[mt][2]);
            split3(k8.y, k9.y, ahi[mt][3], amd[mt][3], alo[mt][3]);
          }
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            unsigned bq[4];
            ldsm_x4_t(bq, Bs + boff[np] + 16 * kk * BN);
            // four chains of three products (lo, md, hi), interleaved
            float c[2][2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                mma_bf16_z(c[mt][h], alo[mt], bq[2 * h], bq[2 * h + 1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                mma_bf16(c[mt][h], amd[mt], bq[2 * h], bq[2 * h + 1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                mma_bf16(c[mt][h], ahi[mt], bq[2 * h], bq[2 * h + 1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  total[mt][2 * np + h][e] += c[mt][h][e];
          }
        }
      }
      // the stage is free for the producers (they wait only for the
      // stages they refill)
      if (sl + kIStages < nsl) bar_arrive(i8_empty(buf), kThreads);
    }

    // the pass's sums into the conv tile: accumulator e of (mt, nt) is
    // channel wm*32 + mt*16 + 2g + (e >= 2), column nt*8 + 2 tq + (e & 1)
    // of the warp's
    if (!POOL) bar_sync(kIPoolBar, kConsumers);  // the ring is read no more
    float* T = POOL ? tile + pass * BN : sums;
    const int ts = POOL ? a.cs : SB;
    if (busy) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cl = wn * WTN + nt * 8 + 2 * tq;
        if (cl >= cvalid) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                T + (wm * 32 + mt * 16 + 2 * g + h) * ts + cl) =
                make_float2(total[mt][nt][2 * h], total[mt][nt][2 * h + 1]);
      }
    }
  }
  bar_sync(kIPoolBar, kConsumers);
  epilogue<POOL>(a, t, co0, min(BM, a.Co - co0), sums, tile, colofs,
                 kIPoolBar);
}

template <int BM, bool POOL>
cudaError_t launch_i8f32(const K1Args<int8_t, float>& a, int blocks,
                         int smem, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      conv_chwn_i8f32_kernel<BM, POOL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, (a.Co + BM - 1) / BM);
  conv_chwn_i8f32_kernel<BM, POOL><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TW>
int forward(const void* x, const void* w, const void* bias, const void* res,
            void* y, void* z, int N, int Ci, int H, int W, int Co, int F,
            int S, int pad, int pool_F, int pool_S, int pool_avg, int relu,
            int src_nchw, int dst_nchw, int res_nchw, int bm, int nb, int ph,
            int pw, void* stream) {
  K1Args<TX, TW> a;
  a.x = static_cast<const TX*>(x);
  a.w = static_cast<const TW*>(w);
  a.bias = static_cast<const TW*>(bias);
  a.res = static_cast<const TW*>(res);
  a.y = static_cast<TW*>(y);
  a.z = static_cast<TW*>(z);
  a.N = N; a.Ci = Ci; a.H = H; a.W = W; a.Co = Co; a.F = F; a.S = S;
  a.pad = pad;
  a.K = Ci * F * F;
  a.Ho = (H + 2 * pad - F) / S + 1;
  a.Wo = (W + 2 * pad - F) / S + 1;
  a.pF = pool_F; a.pS = pool_S; a.pool_avg = pool_avg; a.relu = relu;
  a.xs = repro::layout_strides(src_nchw, N, Ci, H, W);
  a.rs = repro::layout_strides(res_nchw, N, Co, a.Ho, a.Wo);
  a.zs = repro::layout_strides(false, N, Co, a.Ho, a.Wo);
  // the narrow builds copy 8 elements at a time: 16 bytes of bf16 (8 of
  // int8 x, loaded into registers); so does the int8->fp32 build
  constexpr bool kNarrow = std::is_same<TW, bf16>::value;
  constexpr bool kI8F32 =
      std::is_same<TX, int8_t>::value && std::is_same<TW, float>::value;
  a.vec_x = reinterpret_cast<uintptr_t>(x) %
                (kNarrow || kI8F32 ? 8 * sizeof(TX) : 16) ==
            0;
  a.vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
            Co % (kNarrow ? 8 : 4) == 0;
  const long long cols = static_cast<long long>(N) * a.Ho * a.Wo;
  if (cols >= 0x7fffffffLL - BN) return static_cast<int>(cudaErrorInvalidValue);
  a.cols = static_cast<int>(cols);
  const bool pool = pool_F > 0;
  long long blocks;
  int smem = kNarrow   ? narrow_ring_bytes(bm)
             : kI8F32 ? i8f32_ring_bytes(bm)
                      : 4 * ring_floats(bm);
  if (pool) {
    a.UH = (a.Ho - pool_F) / pool_S + 1;
    a.UW = (a.Wo - pool_F) / pool_S + 1;
    if (nb < 1 || ph < 1 || pw < 1 || a.UH < 1 || a.UW < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    a.nb = nb; a.ph = ph; a.pw = pw;
    a.tiles_h = (a.UH + ph - 1) / ph;
    a.tiles_w = (a.UW + pw - 1) / pw;
    const int cmax = min(nb, N) * ((min(ph, a.UH) - 1) * pool_S + pool_F) *
                     ((min(pw, a.UW) - 1) * pool_S + pool_F);
    a.cs = (cmax + 31) / 32 * 32 + 8;
    smem += 4 * bm * a.cs;
    blocks = static_cast<long long>((N + nb - 1) / nb) * a.tiles_h *
             a.tiles_w;
  } else {
    a.UH = a.Ho; a.UW = a.Wo;
    a.nb = a.ph = a.pw = a.tiles_h = a.tiles_w = a.cs = 0;
    blocks = (cols + BN - 1) / BN;
  }
  a.ys = repro::layout_strides(dst_nchw, N, Co, a.UH, a.UW);
  if (cols <= 0 || Co <= 0) return static_cast<int>(cudaGetLastError());
  if (smem + kStaticBytes > kSmemMax || blocks > 0x7fffffffLL ||
      (bm != 64 && bm != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = static_cast<int>(blocks);
  cudaError_t e;
  if constexpr (kNarrow) {
    if (bm == 64)
      e = pool ? launch_narrow<64, true>(a, nblk, smem, st)
               : launch_narrow<64, false>(a, nblk, smem, st);
    else
      e = pool ? launch_narrow<128, true>(a, nblk, smem, st)
               : launch_narrow<128, false>(a, nblk, smem, st);
  } else if constexpr (kI8F32) {
    if (bm == 64)
      e = pool ? launch_i8f32<64, true>(a, nblk, smem, st)
               : launch_i8f32<64, false>(a, nblk, smem, st);
    else
      e = pool ? launch_i8f32<128, true>(a, nblk, smem, st)
               : launch_i8f32<128, false>(a, nblk, smem, st);
  } else if (bm == 64) {
    e = pool ? launch<64, true>(a, nblk, smem, st)
             : launch<64, false>(a, nblk, smem, st);
  } else {
    e = pool ? launch<128, true>(a, nblk, smem, st)
             : launch<128, false>(a, nblk, smem, st);
  }
  return static_cast<int>(e);
}

}  // namespace

// w [Ci, F, F, Co] is [K, Co]; z (or null) is [Co, Ho, Wo, N], of y's
// type.  The block tile is bm (64 or 128) output channels by 128
// consecutive columns without a pool, or by the conv outputs under nb images
// x ph x pw pooled outputs with one (ops.conv_tiling).  x is REPRO_XT, w,
// bias, res and y REPRO_WT (storage.cuh: conv_chwn_forward is float32,
// conv_chwn_forward_<variant> a storage variant).  Returns
// cudaGetLastError().
extern "C" int REPRO_ENTRY(conv_chwn_forward)(
    const void* x, const void* w, const void* bias, const void* res, void* y,
    void* z, int N, int Ci, int H, int W, int Co, int F, int S, int pad,
    int pool_F, int pool_S, int pool_avg, int relu, int src_nchw,
    int dst_nchw, int res_nchw, int bm, int nb, int ph, int pw,
    void* stream) {
  return forward<REPRO_XT, REPRO_WT>(x, w, bias, res, y, z, N, Ci, H, W, Co,
                                     F, S, pad, pool_F, pool_S, pool_avg,
                                     relu, src_nchw, dst_nchw, res_nchw, bm,
                                     nb, ph, pw, stream);
}
