// K2: the NCHW convolution engine over a virtual im2col matrix, with its
// fused epilogue.
//
// Replaces repro/kernels/conv/im2col_mm.py::conv_nchw_pallas (body
// _conv_nchw_kernel), the Caffe/cuDNN analogue: per sample, the conv is the
// product of the filter matrix [Co x Ci*F*F] with the im2col patch matrix
// [Ci*F*F x Ho*Wo].  The patch matrix is never built, not even in shared
// memory: a block stages a box of x and reads each filter tap as a shifted
// window of it.  Same epilogue and layout-fold protocol as K1 (bias ->
// residual -> ReLU -> max/avg pool; src/dst/residual layouts NCHW or CHWN
// through their strides).  x is [N,Ci,H,W] or [Ci,H,W,N]; w is canonical
// [Co,Ci,F,F]; y is [N,Co,Ho',Wo'] or [Co,Ho',Wo',N].  dgrad runs here
// too, as the stride-1 conv of the dilated gradient (backward.py).
//
// Storage dtypes (csrc/storage.cuh), as K1: x float32, bf16 or int8, w
// (and bias, residual, y) float32 or bf16; int8 x carries per-channel
// quantized values whose scale the caller folded into w.  Where w is
// float32 (the float32 and int8 -> float32 builds) the producer widens an
// int8 x box to float32 as it stages it (a register load instead of
// cp.async: once per element of the box, not once per tap) and the
// consumers drop the 3xTF32 products of its zero small part.  Where w is
// bf16 (the bf16 and int8 -> bf16 builds) a kernel of its own runs on the
// bf16 tensor cores (conv_nchw_bf16_kernel below, whose note says how).
// y is rounded once where it is stored; z (save_act) is stored in y's
// type, as K1's.
//
// What bounds it on an H100: operations, 2*Co*Ci*F^2 FLOPs per conv output
// against a few bytes (VGG16's conv1_1, Ci = 3, writes 411 MB at batch 32
// and is bound by bytes).  fp32 FMA on the CUDA cores peaks at 67 TFLOP/s,
// the TF32 tensor cores at 495.
//
// Arithmetic: fp32 accuracy from the tensor cores by the 3xTF32 split of
// K6 (csrc/mma.cuh), three TF32 products a term on mma.sync m16n8k8; each
// chain of at most 32 reduction terms (4 taps of 8 channels) is summed from
// zero in the mma registers and added to fp32 registers, because the
// tensor core truncates as it accumulates.
//
// Design (K5b's conv2 phase, fed from x).  A block owns BM output channels
// (64, 128 or 256) by a rectangle of conv outputs: NB images x OH rows x
// OW columns, at most 16384 / BM of them (with a pool, the conv outputs
// under UTH x UTW pooled outputs, computed once per block; only the halo
// rows and columns that neighbouring rectangles share are computed twice).
// ops.nchw_tiling picks the tile by a time model fitted to card timings and
// prices the FLOPs the blocks execute, which the kernel adds to ``stats``
// when given.  The reduction steps as (8 input channels) x (one tap): an
// mma k index is an input channel, its tap fixed for the step, so an
// operand is never expanded into im2col form.  A stage of the ring holds,
// for 8 channels (GA x 8 for a 1x1 conv) and TR tap rows (all F where it
// fits the ring), the w slice [BM][8 TR F + 4] and the x box [8][NB x XH x
// XW] those taps read; a tap's B fragment is a shifted window of the box.
// So x is read from device memory once per block and Co slice, plus its
// halo (plus the rows a split of the taps reloads), not once per tap.
// Weight rows are 4 mod 8 floats apart and a channel's taps (TR F, odd) sit
// side by side, so the scalar A fragment loads hit 32 banks; box channels
// are 8 mod 32 floats apart, so a tile of 8 output columns along a row does
// too (at stride 1).  3x3 and 1x1 convs get their own instantiations with
// the taps unrolled.  A thin input (Ci < 8: the 3-channel first layers)
// steps 8 consecutive (tap row, channel, dx) of the stage's list instead,
// so its mma are 3/8 full rather than 5/8 empty (THIN below).
//
// 384 threads, K5b's split: one producer warpgroup only copies (cp.async:
// 16 bytes where 4 box columns are in range and aligned, or 4 weights of a
// row are; 8 bytes where 2 are; 4 bytes with zero fill at the padding halo,
// for a ragged row, and for a CHWN source), two consumer warpgroups only
// multiply, passing a
// ring of stages (3; 2 at BM 256) on named barriers, FULL when a stage
// landed and EMPTY when it was used; setmaxnreg moves the producer's spare
// registers to the consumers.  The consumer warps are BM/32 along Co by
// 8/(BM/32) along the columns, each 32 channels by 8-column tiles dealt
// round-robin.  After the last stage the sums go through shared memory
// (the freed ring) for the epilogue: bias -> residual (read in its layout)
// -> ReLU (keeps NaN) -> max (nan_max) or avg pool, stored along w (along
// n where dst is CHWN).  The save_act output z (training) is written in
// NCHW from the same tile, one writer per conv output: the block whose
// rectangle starts the window rows (columns) it lies in, the last
// rectangle for the rows past them; conv outputs under no window are never
// written (the wrapper zero-fills z then).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/mma.cuh"
#include "../../csrc/nan_max.cuh"
#include "../../csrc/storage.cuh"
#include "conv_common.cuh"  // Strides, layout_strides
#include "conv_ring.cuh"    // ring barriers, copy_quad, rows8

namespace {

using namespace repro::mma;
using namespace repro::ring;
using namespace repro::storage;
using repro::Strides;

constexpr int kConsumers = 256;  // two warpgroups: the mma
constexpr int kProducers = 128;  // one warpgroup: the copies
constexpr int kThreads = kConsumers + kProducers;
// registers of a thread of each role (setmaxnreg): 384 x 168 at launch,
// then 256 x 224 + 128 x 56, the same 64512
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;
constexpr int kTile = 16384;      // BM * BN
constexpr int kSmemMax = 232448;  // 227 KB, what an H100 block may use

template <typename TX, typename TW>
struct K2Args {
  const TX* x;
  const TW* w;        // [Co, K], k = (ci, dy, dx)
  const TW* bias;     // [Co] or null
  const TW* res;      // conv-output (pre-pool) shape, or null
  TW* y;
  TW* z;              // save_act: the pre-pool activation (NCHW), or null
  int N, Ci, H, W, Co, F, S, pad, K, Ho, Wo;
  int pF, pS, pool_avg, relu;  // pF == 0: no pool
  int UH, UW;         // unit grid: the pooled output, or the conv output
  int NB, UTH, UTW;   // block tile in units
  int nTH, nTW;       // tiles along the unit rows / columns
  int TR, TF, tblocks;  // tap rows a stage holds, TR * F, ceil(F / TR)
  int GA;             // channel groups a stage holds (1x1 only), else 1:
                      // of 8 channels (float32 kernel) or 16 (bf16)
  int SA, XSTR, STAGE;  // w slice row stride, x box channel stride, ring
                        // stage: in floats (float32 kernel) or halfwords
  int RING;           // floats before the k tables
  int KP;             // thin: the stage's k list (TR Ci F) padded to 8
                      // (float32 kernel) or 16 (bf16)
  int nsl;            // stages of a block
  int vec_x, vec_w;   // 16-byte copies allowed
  int pair_x;         // 8-byte copies of x allowed (float32 kernel)
  int XV;             // bf16 kernel: elements a box copy moves (8, 4, 2, 1)
  Strides xs, ys, rs, zs;
  unsigned long long* stats;  // executed FLOPs, or null
};

// a block's rectangle: its units, the conv outputs under them and the x
// box of one image that they read
struct Tile {
  int n0, NBc, uh0, uw0, UTHc, UTWc;
  int oh0, ow0, OH, OW, C;  // conv outputs: origin, rows, columns, all
  int XH, XW, ih0, iw0, sh;  // x box rows (for TR tap rows) and columns (a
                             // multiple of 4), origin (iw0 aligned down to
                             // 4) and the first column's shift in it
  bool last_h, last_w;       // the last rectangle along the unit rows/cols
};

template <typename A>
__device__ __forceinline__ Tile make_tile(const A& a) {
  Tile t;
  int b = blockIdx.x;
  const int tw = b % a.nTW;
  b /= a.nTW;
  const int th = b % a.nTH, tn = b / a.nTH;
  t.n0 = tn * a.NB;
  t.NBc = min(a.NB, a.N - t.n0);
  t.uh0 = th * a.UTH;
  t.UTHc = min(a.UTH, a.UH - t.uh0);
  t.uw0 = tw * a.UTW;
  t.UTWc = min(a.UTW, a.UW - t.uw0);
  const bool pool = a.pF > 0;
  t.oh0 = pool ? t.uh0 * a.pS : t.uh0;
  t.ow0 = pool ? t.uw0 * a.pS : t.uw0;
  t.OH = pool ? (t.UTHc - 1) * a.pS + a.pF : t.UTHc;
  t.OW = pool ? (t.UTWc - 1) * a.pS + a.pF : t.UTWc;
  t.C = t.NBc * t.OH * t.OW;
  const int iws = t.ow0 * a.S - a.pad;
  t.ih0 = t.oh0 * a.S - a.pad;
  t.iw0 = iws & ~3;
  t.sh = iws - t.iw0;
  t.XH = (t.OH - 1) * a.S + a.TR;
  t.XW = (t.sh + (t.OW - 1) * a.S + a.F + 3) & ~3;
  t.last_h = t.uh0 + t.UTHc == a.UH;
  t.last_w = t.uw0 + t.UTWc == a.UW;
  return t;
}

// A producer thread walks the x box's (segment, row, image, channel) by a
// fixed step (kProducers): its digits in that mixed radix (r0, r1, r2,
// unbounded), least significant first, are stepped with one carry a
// digit, so the loop divides nothing.
struct Radix {
  int d0, d1, d2, d3;
};
__device__ __forceinline__ Radix radix_of(int v, int r0, int r1, int r2) {
  Radix d;
  d.d0 = v % r0;
  v /= r0;
  d.d1 = v % r1;
  v /= r1;
  d.d2 = v % r2;
  d.d3 = v / r2;
  return d;
}
__device__ __forceinline__ void radix_add(Radix& d, const Radix& s, int r0,
                                          int r1, int r2) {
  d.d0 += s.d0;
  int c = d.d0 >= r0;
  d.d0 -= c ? r0 : 0;
  d.d1 += s.d1 + c;
  c = d.d1 >= r1;
  d.d1 -= c ? r1 : 0;
  d.d2 += s.d2 + c;
  c = d.d2 >= r2;
  d.d2 -= c ? r2 : 0;
  d.d3 += s.d3 + c;
}

// The A fragments of one 8-deep reduction step, split for 3xTF32: pa
// points at (row g, k t) of the warp's first 16 rows, k t + 4 lies d4
// floats further, row g + 8 eight rows (8 SA) down.  AX: w is of a narrow
// storage type (its small part is zero and never read)
template <bool AX>
__device__ __forceinline__ void load_a(const float* pa, int SA, int d4,
                                       unsigned (&abig)[2][4],
                                       unsigned (&asmall)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* p = pa + mt * 16 * SA;
    split<AX>(p[0], abig[mt][0], asmall[mt][0]);
    split<AX>(p[8 * SA], abig[mt][1], asmall[mt][1]);
    split<AX>(p[d4], abig[mt][2], asmall[mt][2]);
    split<AX>(p[8 * SA + d4], abig[mt][3], asmall[mt][3]);
  }
}

// One 8-deep reduction step of a warp on its 2 x 8 mma tiles: the B value
// of column tile nt at xr0 + boff[nt] (k t) and xr1 + boff[nt] (k t + 4).
// The tiles go in two halves of 4, and each of the three 3xTF32 products
// runs over the half's 8 accumulators before the next reads them, so the
// tensor core has independent mma to overlap.  AX / BX: w / x is of a
// narrow storage type, and the products of its zero small part are skipped
template <bool AX, bool BX>
__device__ __forceinline__ void mma_step(float (&acc)[2][8][4],
                                         const unsigned (&abig)[2][4],
                                         const unsigned (&asmall)[2][4],
                                         const float* xr0, const float* xr1,
                                         const int (&boff)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned b0big[4], b0small[4], b1big[4], b1small[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split<BX>(xr0[boff[4 * h + j]], b0big[j], b0small[j]);
      split<BX>(xr1[boff[4 * h + j]], b1big[j], b1small[j]);
    }
    if constexpr (!AX) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_tf32(acc[mt][4 * h + j], asmall[mt], b0big[j], b1big[j],
                   acc[mt][4 * h + j]);
    }
    if constexpr (!BX) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_tf32(acc[mt][4 * h + j], abig[mt], b0small[j], b1small[j],
                   acc[mt][4 * h + j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_tf32(acc[mt][4 * h + j], abig[mt], b0big[j], b1big[j],
                 acc[mt][4 * h + j]);
  }
}

__device__ __forceinline__ void set_zero(float (&v)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[mt][nt][e] = 0.f;
}
__device__ __forceinline__ void add_to(float (&tot)[2][8][4],
                                       const float (&acc)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] += acc[mt][nt][e];
}

// The end of both K2 kernels (the float32 one and the bf16 one): what the
// block executed into ``stats``, then the sums ``tot`` (each consumer
// warp's 32 rows by 8 column tiles, as the mma accumulators hold them:
// rows g, g + 8 and columns 2t, 2t + 1 of each 16 x 8 tile) through shared
// memory over the ring, which the last stage freed, and bias -> residual
// -> ReLU [-> save_act z] [-> pool] -> y
template <int BM, int NS, bool POOL, typename A>
__device__ __forceinline__ void epilogue(const A& a, const Tile& t,
                                         float* smem,
                                         const float (&tot)[2][8][4],
                                         int co0, int tid) {
  constexpr int BN = kTile / BM;
  constexpr int WM = BM / 32;   // warps along Co, 32 rows each
  constexpr int WN = 8 / WM;    // warps along the columns
  constexpr int TS = BN + 8;    // epilogue tile row stride
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int OHW = t.OH * t.OW;
  const int mrows = min(BM, a.Co - co0);
  if (a.stats && tid == 0)  // what the block executed, as nchw_tiling counts
    atomicAdd(a.stats, 2ull * a.K * mrows * t.C);

  bar_sync(cons_bar<NS>(), kConsumers);
  float* T = smem;  // [BM][TS]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = (nt * WN + wn) * 8 + 2 * tq;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(T + (wm * 32 + mt * 16 + g + 8 * h) * TS +
                                   c) =
            make_float2(tot[mt][nt][2 * h], tot[mt][nt][2 * h + 1]);
  }
  bar_sync(cons_bar<NS>(), kConsumers);
  // a thread takes one column (C <= BN <= 256) and every kConsumers / C-th
  // channel: its offsets are worked out once.  Stores run along w, or along
  // n where dst is CHWN and the tile holds several images
  const bool n_fast = a.ys.n == 1 && t.NBc > 1;
  {
    const int per = kConsumers / t.C;
    if (tid < per * t.C) {
      const int q = tid % t.C, m0 = tid / t.C;
      const int c =
          n_fast && !POOL ? (q % t.NBc) * OHW + q / t.NBc : q;
      const int nl = c / OHW, r = c - nl * OHW;
      const int ohl = r / t.OW, owl = r - ohl * t.OW;
      const long long n = t.n0 + nl;
      const int oh = t.oh0 + ohl, ow = t.ow0 + owl;
      const long long yo = n * a.ys.n + oh * a.ys.h + ow * a.ys.w;
      const long long ro = n * a.rs.n + oh * a.rs.h + ow * a.rs.w;
      const long long zo = n * a.zs.n + oh * a.zs.h + ow * a.zs.w;
      // one z writer per conv output: rows (columns) before the next
      // rectangle's first window, all of them in the last rectangle; none
      // under no window
      const bool zw = a.z && (!POOL || ((ohl < t.UTHc * a.pS || t.last_h) &&
                                        ohl % a.pS < a.pF &&
                                        (owl < t.UTWc * a.pS || t.last_w) &&
                                        owl % a.pS < a.pF));
      for (int m = m0; m < mrows; m += per) {
        const long long co = co0 + m;
        float v = T[m * TS + c];
        if (a.bias) v += ld(a.bias + co);
        if (a.res) v += ld(a.res + ro + co * a.rs.c);
        if (a.relu) v = v < 0.f ? 0.f : v;  // keeps NaN, as max(v, 0)
        if (zw) put(a.z + zo + co * a.zs.c, v);
        if (POOL)
          T[m * TS + c] = v;
        else
          put(a.y + yo + co * a.ys.c, v);
      }
    }
  }
  if (!POOL) return;
  bar_sync(cons_bar<NS>(), kConsumers);
  const int outs = t.NBc * t.UTHc * t.UTWc;
  const int per = kConsumers / outs;
  if (tid >= per * outs) return;
  const int q = tid % outs, m0 = tid / outs;
  int nl, uhl, uwl;
  if (n_fast) {
    nl = q % t.NBc;
    uwl = (q / t.NBc) % t.UTWc;
    uhl = q / t.NBc / t.UTWc;
  } else {
    uwl = q % t.UTWc;
    uhl = (q / t.UTWc) % t.UTHc;
    nl = q / t.UTWc / t.UTHc;
  }
  const int base = nl * OHW + uhl * a.pS * t.OW + uwl * a.pS;
  const long long yo = (t.n0 + nl) * static_cast<long long>(a.ys.n) +
                       (t.uh0 + uhl) * a.ys.h + (t.uw0 + uwl) * a.ys.w;
  const float area = static_cast<float>(a.pF * a.pF);
  for (int m = m0; m < mrows; m += per) {
    const float* row = T + m * TS + base;
    float acc = a.pool_avg ? 0.f : -INFINITY;
    for (int i = 0; i < a.pF; ++i)
      for (int j = 0; j < a.pF; ++j) {
        const float v = row[i * t.OW + j];
        acc = a.pool_avg ? acc + v : nan_max(acc, v);
      }
    put(a.y + yo + static_cast<long long>(co0 + m) * a.ys.c,
        a.pool_avg ? acc / area : acc);
  }
}

// FT: the filter size where fixed at compile time with all its tap rows in
// a stage (1 or 3: the taps unroll), else 0.  THIN (Ci < 8): a reduction
// step is 8 consecutive (tap row, input channel, dx) of the stage's list
// instead of 8 channels at one tap, so a 3-channel input fills 3/8 of an
// mma instead of wasting 5/8; each lane reads its k's offsets in the x box
// from a table, and k past the list reads a zero channel of the box
template <typename TX, typename TW, int BM, bool POOL, int FT, bool THIN>
__global__ void __launch_bounds__(kThreads, 1)
conv_nchw_kernel(const K2Args<TX, TW> a) {
  constexpr bool AX = kExactTf32<TW>, BX = kExactTf32<TX>;
  constexpr int NS = BM == 256 ? 2 : 3;  // ring stages
  constexpr int WM = BM / 32;   // warps along Co, 32 rows each
  constexpr int WN = 8 / WM;    // warps along the columns
  // the ring (or the epilogue tile over it), then for THIN the k tables
  extern __shared__ __align__(16) float smem[];
  int* kx = reinterpret_cast<int*>(smem + a.RING);  // [KP] x box offsets
  int* kw = kx + a.KP;                              // [KP] w offsets, or -1
  const Tile t = make_tile(a);
  const int co0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int FF = a.F * a.F, CF = a.Ci * a.F;

  if (tid >= kConsumers) {
    // ---- the producer warpgroup: every stage's copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int XQ = t.XW / 4;  // 16-byte quads of an x box row
    // x box channels of a stage: 8 ga (or Ci and the zero one)
    const int cv = THIN ? a.Ci + 1 : 8 * a.GA;
    if (THIN) {
      // the w offset of each k of a stage's list (tap row, ci, dx), from
      // its first tap row; -1 past the list
      for (int k = pt; k < a.KP; k += kProducers) {
        const int dyl = k / CF, r = k - dyl * CF, ci = r / a.F;
        kw[k] = k < a.TR * CF ? ci * FF + dyl * a.F + (r - ci * a.F) : -1;
      }
      bar_sync(prod_bar<NS>(), kProducers);
    }
    // Each copy is cut into rows (of w or of the x box), each row into
    // enough segments that the 128 producer threads all have one; a thread
    // sets up a segment's addresses once and steps along it.  (Lanes along
    // a row coalesce better but pay a row's set-up for a unit or two, and
    // ran slower: PERF.md, "Tried".)
    auto stage = [&](int sl) {
      const int oct = sl / a.tblocks, tb = sl - oct * a.tblocks;
      const int dy0 = tb * a.TR, trc = min(a.TR, a.F - dy0);
      float* st = smem + (sl % NS) * a.STAGE;
      if (THIN) {
        // w rows co0 .. co0 + BM - 1: the k list of tap rows dy0 .. dy0 +
        // trc - 1, zero past it
        const int kv = trc * CF;
        const int segs = max(1, min(a.KP, kProducers / BM));
        const int len = (a.KP + segs - 1) / segs;
        for (int it = pt; it < BM * segs; it += kProducers) {
          const int r = it / segs, k0 = (it - r * segs) * len;
          const int co = co0 + r;
          const TW* src =
              a.w + static_cast<long long>(co) * a.K + dy0 * a.F;
          float* dst = st + r * a.SA;
          for (int k = k0; k < min(a.KP, k0 + len); ++k) {
            const bool ok = co < a.Co && k < kv;
            copy1(dst + k, ok ? src + kw[k] : a.w, ok);
          }
        }
      } else if (a.TR == a.F) {
        // w rows co0 .. co0 + BM - 1, k [oct 8 ga F^2, + 8 ga F^2):
        // contiguous
        const int wq = 2 * a.GA * FF, k0 = oct * 8 * a.GA * FF;
        const int segs = max(1, min(wq, kProducers / BM));
        const int len = (wq + segs - 1) / segs;
        for (int it = pt; it < BM * segs; it += kProducers) {
          const int r = it / segs, q0 = (it - r * segs) * len;
          const int co = co0 + r;
          const TW* src = a.w + static_cast<long long>(co) * a.K + k0;
          float* dst = st + r * a.SA;
          for (int q = q0; q < min(wq, q0 + len); ++q) {
            const int c = 4 * q;
            copy_quad(dst + c, src + c, a.w,
                      co < a.Co ? min(4, a.K - (k0 + c)) : 0, a.vec_w);
          }
        }
      } else {
        // tap rows dy0 .. dy0 + trc - 1 of 8 channels: a run of trc F
        // weights per channel
        const int run = trc * a.F;
        for (int it = pt; it < BM * 8; it += kProducers) {
          const int r = it >> 3, c8 = it & 7;
          const int co = co0 + r, ci = oct * 8 + c8;
          const bool ok = co < a.Co && ci < a.Ci;
          const TW* src = a.w + static_cast<long long>(co) * a.K + ci * FF +
                          dy0 * a.F;
          float* dst = st + r * a.SA + c8 * a.TF;
          for (int j = 0; j < run; ++j)
            copy1(dst + j, ok ? src + j : a.w, ok);
        }
      }
      // the x box of the stage's channels for these tap rows:
      // [cv][NB][XH][XW], rows (OH - 1) S + trc of each image; a thin
      // slot's zero channel is filled by the slot's first stage only
      float* xs = st + BM * a.SA;
      const int xhn = (t.OH - 1) * a.S + trc;
      const int rows = (THIN && sl >= NS ? a.Ci : cv) * t.NBc * xhn;
      const int segs = max(1, min(XQ, kProducers / rows));
      const int len = (XQ + segs - 1) / segs;
      Radix d = radix_of(pt, segs, xhn, t.NBc);
      const Radix s = radix_of(kProducers, segs, xhn, t.NBc);
      for (int it = pt; it < rows * segs; it += kProducers) {
        const int q0 = d.d0 * len, xh = d.d1, nl = d.d2, c8 = d.d3;
        radix_add(d, s, segs, xhn, t.NBc);
        const int ci = THIN ? c8 : oct * 8 * a.GA + c8;
        const int ih = t.ih0 + dy0 + xh;
        float* dst = xs + c8 * a.XSTR + (nl * t.XH + xh) * t.XW;
        const bool rok = ci < a.Ci && static_cast<unsigned>(ih) <
                                          static_cast<unsigned>(a.H);
        const TX* src =
            rok ? a.x + static_cast<long long>(t.n0 + nl) * a.xs.n +
                      static_cast<long long>(ci) * a.xs.c +
                      static_cast<long long>(ih) * a.xs.h
                : a.x;
        for (int q = q0; q < min(XQ, q0 + len); ++q) {
          const int iw = t.iw0 + 4 * q;
          float* d4 = dst + 4 * q;
          if (!rok || iw >= a.W || iw + 4 <= 0) {
            copy4(d4, a.x, false);
          } else if (iw >= 0 && iw + 4 <= a.W && a.vec_x) {
            copy4(d4, src + iw, true);
          } else if (iw >= 0 && iw + 4 <= a.W && a.pair_x) {
            copy2(d4, src + iw, true);
            copy2(d4 + 2, src + iw + 2, true);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool ok =
                  static_cast<unsigned>(iw + j) < static_cast<unsigned>(a.W);
              copy1(d4 + j, ok ? src + (iw + j) * a.xs.w : a.x, ok);
            }
          }
        }
      }
    };
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < a.nsl) stage(q);
      cp_commit();
    }
    for (int sl = 0; sl < a.nsl; ++sl) {
      cp_wait<NS - 2>();  // stage sl has landed: announce it
      bar_arrive(full_bar(sl % NS), kThreads);
      const int nx = sl + NS - 1;
      if (nx < a.nsl) {
        if (nx >= NS) bar_sync(empty_bar<NS>(nx % NS), kThreads);
        stage(nx);
      }
      cp_commit();
    }
    return;
  }

  // ---- the consumer warpgroups: the products and the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int F = FT ? FT : a.F, TF = FT ? FT * FT : a.TF;
  const int SA = FT == 3 ? 8 * 9 + 4 : a.SA;  // 3x3 stages hold one group
  constexpr int U = FT ? FT * FT : 1;
  const int OHW = t.OH * t.OW;
  if (THIN) {
    // the x box offset of each k of a stage's list; past it, the zero
    // channel (index Ci)
    for (int k = tid; k < a.KP; k += kConsumers) {
      const int dyl = k / CF, r = k - dyl * CF, ci = r / a.F;
      kx[k] = k < a.TR * CF
                  ? ci * a.XSTR + dyl * t.XW + (r - ci * a.F)
                  : a.Ci * a.XSTR;
    }
    bar_sync(cons_bar<NS>(), kConsumers);
  }

  // the box offset of column g of each of this warp's column tiles (ct =
  // nt * WN + wn); past the last column, the last one.  Every warp runs
  // all 8 tiles, so a reduction step is one block of independent mma with
  // no exit for the scheduler to respect
  int boff[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = min((nt * WN + wn) * 8 + g, t.C - 1);
    const int nl = c / OHW, r = c - nl * OHW;
    const int ohl = r / t.OW, owl = r - ohl * t.OW;
    boff[nt] = nl * t.XH * t.XW + ohl * a.S * t.XW + owl * a.S + t.sh;
  }

  float tot[2][8][4], acc[2][8][4];
  set_zero(tot);
  for (int sl = 0; sl < a.nsl; ++sl) {
    const int buf = sl % NS;
    const int tb = FT ? 0 : sl % a.tblocks;
    const int trc = FT ? FT : min(a.TR, F - tb * a.TR);
    bar_sync(full_bar(buf), kThreads);
    const float* Ws = smem + buf * a.STAGE + (wm * 32 + g) * SA;
    const float* Xs = smem + buf * a.STAGE + BM * SA;
    if (THIN) {
      // 8-deep steps along the stage's k list, a chain of 4 (32 terms);
      // k past this stage's list (its weights are 0) reads the zero
      // channel, never rows of an earlier stage
      const int kv = trc * CF, steps = (kv + 7) / 8, zx = a.Ci * a.XSTR;
      for (int ks = 0; ks < steps; ++ks) {
        if ((ks & 3) == 0) set_zero(acc);  // a chain from zero
        const int k0 = ks * 8 + tq;
        unsigned abig[2][4], asmall[2][4];
        load_a<AX>(Ws + k0, SA, 4, abig, asmall);
        mma_step<AX, BX>(acc, abig, asmall, Xs + (k0 < kv ? kx[k0] : zx),
                 Xs + (k0 + 4 < kv ? kx[k0 + 4] : zx), boff);
        if ((ks & 3) == 3 || ks == steps - 1) add_to(tot, acc);
      }
    } else if (FT == 1) {
      // 1x1: one tap, the stage's ga groups of 8 channels a step each; a
      // chain of 4 steps (32 terms)
      for (int o2 = 0; o2 < a.GA; ++o2) {
        if ((o2 & 3) == 0) set_zero(acc);  // a chain from zero
        unsigned abig[2][4], asmall[2][4];
        load_a<AX>(Ws + o2 * 8 + tq, SA, 4, abig, asmall);
        const float* xr = Xs + (o2 * 8 + tq) * a.XSTR;
        mma_step<AX, BX>(acc, abig, asmall, xr, xr + 4 * a.XSTR, boff);
        if ((o2 & 3) == 3 || o2 == a.GA - 1) add_to(tot, acc);
      }
    } else {
      // 8 channels at one tap a step, a chain of 4 taps (32 terms)
      const int taps = trc * F;
      const float* Xq = Xs + tq * a.XSTR;
#pragma unroll U
      for (int r = 0; r < taps; ++r) {
        if ((r & 3) == 0) set_zero(acc);  // a chain from zero
        // a0 (row g, k t), a1 (row g + 8, k t), a2 (g, t + 4), a3 (g + 8,
        // t + 4): k is input channel k of the stage's 8, at tap r
        unsigned abig[2][4], asmall[2][4];
        load_a<AX>(Ws + tq * TF + r, SA, 4 * TF, abig, asmall);
        const int dy = r / F;
        const float* xr = Xq + dy * t.XW + (r - dy * F);
        mma_step<AX, BX>(acc, abig, asmall, xr, xr + 4 * a.XSTR, boff);
        if ((r & 3) == 3 || r == taps - 1) add_to(tot, acc);
      }
    }
    if (sl + NS < a.nsl) bar_arrive(empty_bar<NS>(buf), kThreads);
  }

  epilogue<BM, NS, POOL>(a, t, smem, tot, co0, tid);
}

// ---- the bf16 and int8 -> bf16 builds: K2 on the bf16 tensor cores -------
//
// Instantiated only where w is bf16 (launch_f below).  The tile, the warp
// roles, the barriers, the ring's walk of stages and the epilogue are the
// float32 kernel's; the rings, the producers' copies and the products
// differ.
//
// Rings: bf16.  A stage steps k16, 16 input channels at one tap, where the
// float32 kernel's steps 8: a 16-channel bf16 stage takes the bytes of an
// 8-channel float32 one, so every stage lies inside the float32 layout's
// shared memory (layout_bf16 below, ops.py::k2_bf16_layout) and the tiles
// and plans stay the float32 build's.  Ci not a multiple of 16 zero-pads
// k; a 1x1 conv of ga 8-channel groups a stage takes ceil(ga / 2)
// 16-channel groups; a thin input (Ci < 8) steps 16 consecutive (tap row,
// channel, dx) of the stage's list (its k list padded to 16).  w rows are
// 16 ga TR F + 8 halfwords, box channels XSTR halfwords apart (8 mod 32,
// as the float32 box's floats).
//
// Copies: the w slice's rows by 16-byte cp.async where K % 8 == 0
// (storage::chunk8), else halfwords.  A box row by one lane, picked by
// the host from x's layout, W and alignment (XV, elements a copy moves):
// 8 (16-byte cp.async; the box from its first column aligned down to 8,
// where that box fits the float32 layout's bytes, else XV 4), 4 (8-byte
// cp.async), 2 (4-byte cp.async), or 1: halfword loads into registers,
// four 4-column copies a thread with every load issued before any store
// and no branch between them (W odd: ResNet-18's 55 and 7; a CHWN source;
// K5b's lesson).  The cp.async lanes copy whole words, in or out of [0, W)
// as a whole, since the box origin and W are multiples of XV.  int8 x
// cannot widen in flight: XV 8 (W % 8 == 0) loads 8 bytes and widens them
// in registers (storage::bf16x8), else byte by byte (bf16_bits).
//
// Products: one bf16 m16n8k16 product a term (bf16 and int8 values are
// exact in bf16), summed in fp32 in ONE chain over the whole reduction,
// straight into the fp32 sums (kernels/bf16_mma.py holds such chains over
// K 2304 and 4608 and the thin 7x7 list to one bf16 step of float64), y
// rounded once where it is stored.  A fragment register holds the k pair
// (2t, 2t + 1), which both operands map to channels t and t + 4 of the
// step (the pair 2t + 8, 2t + 9 to t + 8 and t + 12), as K5b's bf16 build
// does; neither operand suits ldmatrix (a tap's window starts at dx, and a
// weight k pair lies TR F apart), so each register is two halfword shared
// loads packed.  ``stats`` counts the FLOPs as the float32 build does, so
// the smoke's check against nchw_tiling stands.
//
// What bounds it: operations at the bf16 tensor cores' 989 TFLOP/s by
// design.  On the card the consumers take most of the time at the
// cp.async lanes (the halfword fragment loads beside mma.sync), and the
// halfword copies add to it at odd W (PERF.md §6 times the parts apart).
static_assert(16 * sizeof(bf16) == 8 * sizeof(float),
              "a 16-channel bf16 stage takes the bytes of an 8-channel "
              "float32 one");

// the bf16 build's x box of a block: the float32 box's rows, its columns
// from the first one aligned down to XV and a width rounded up to 8 (XV
// 8) or 4
template <typename A>
__device__ __forceinline__ void box_bf16(const A& a, Tile& t) {
  const int iws = t.iw0 + t.sh;
  const int span = (t.OW - 1) * a.S + a.F;
  const int m = a.XV == 8 ? 8 : 4;
  t.iw0 = iws & -a.XV;
  t.sh = iws - t.iw0;
  t.XW = (t.sh + span + m - 1) & -m;
}

// The A fragments of one k16 step: p points at (row g, channel t) of the
// warp's first 16 rows; channels t + 4, t + 8, t + 12 lie d4, 2 d4, 3 d4
// halfwords further, row g + 8 eight rows (8 SA) down
__device__ __forceinline__ void load_a16(const unsigned short* p, int SA,
                                         int d4, unsigned (&af)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const unsigned short* q = p + mt * 16 * SA;
    af[mt][0] = pack2(q[0], q[d4]);
    af[mt][1] = pack2(q[8 * SA], q[8 * SA + d4]);
    af[mt][2] = pack2(q[2 * d4], q[3 * d4]);
    af[mt][3] = pack2(q[8 * SA + 2 * d4], q[8 * SA + 3 * d4]);
  }
}

// One k16 step of a warp on its 2 x 8 mma tiles: channels t, t + 4, t + 8,
// t + 12 of column tile nt at x0, x1, x2, x3 + boff[nt]
__device__ __forceinline__ void mma_step16(
    float (&tot)[2][8][4], const unsigned (&af)[2][4],
    const unsigned short* x0, const unsigned short* x1,
    const unsigned short* x2, const unsigned short* x3, const int (&boff)[8]) {
  unsigned b0[8], b1[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    b0[nt] = pack2(x0[boff[nt]], x1[boff[nt]]);
    b1[nt] = pack2(x2[boff[nt]], x3[boff[nt]]);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_bf16(tot[mt][nt], af[mt], b0[nt], b1[nt]);
}

// A producer thread's element copies of one x box row (box_row's lane 1):
// units q0 .. qe - 1 of 4 columns from column iw0 of src, the columns sw
// elements apart (STRIDED) or contiguous (one address a unit, the loads
// at fixed offsets from it), zero outside [0, W) or where !ok; every load
// of kU units is issued before any store, with no branch between them
template <bool STRIDED, typename TX>
__device__ __forceinline__ void element_copies(unsigned short* dst,
                                               const TX* src, const TX* any,
                                               bool ok, int iw0, int q0,
                                               int qe, int W, int sw) {
  constexpr int kU = 4;  // units in flight at once
  for (int q = q0; q < qe; q += kU) {
    unsigned h[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int iw = iw0 + 4 * (q + u);
      const TX* p = src + (STRIDED ? static_cast<long long>(iw) * sw : iw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = q + u < qe && ok &&
                        static_cast<unsigned>(iw + j) <
                            static_cast<unsigned>(W);
        h[u][j] = bf16_bits(
            in ? p + (STRIDED ? static_cast<long long>(j) * sw : j) : any,
            in);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (q + u < qe)
        *reinterpret_cast<uint2*>(dst + 4 * (q + u)) =
            make_uint2(h[u][0] | (h[u][1] << 16), h[u][2] | (h[u][3] << 16));
  }
}

// A producer thread's copies of one x box row, units q0 .. qe - 1 (XV 8:
// 8 columns a unit, else 4) from column iw0 of src (ok: the row lies in x;
// else zeros), by the lane XV names
template <typename TX, int XV>
__device__ __forceinline__ void box_row(unsigned short* dst, const TX* src,
                                        const TX* any, bool ok, int iw0,
                                        int q0, int qe, int W, int sw) {
  constexpr int kU = 4;  // register copies in flight at once
  if constexpr (XV == 8 && std::is_same<TX, bf16>::value) {
    for (int q = q0; q < qe; ++q) {
      const int iw = iw0 + 8 * q;
      const bool in = ok && static_cast<unsigned>(iw) < static_cast<unsigned>(W);
      cp16(dst + 8 * q, in ? src + iw : any, in);
    }
  } else if constexpr (XV == 8) {  // int8: 8 bytes widened in registers
    for (int q = q0; q < qe; q += kU) {
      uint2 r[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int iw = iw0 + 8 * (q + u);
        const bool in = q + u < qe && ok &&
                        static_cast<unsigned>(iw) < static_cast<unsigned>(W);
        r[u] = in ? __ldg(reinterpret_cast<const uint2*>(src + iw))
                  : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (q + u < qe)
          *reinterpret_cast<uint4*>(dst + 8 * (q + u)) = bf16x8(r[u]);
    }
  } else if constexpr (XV == 4) {
    for (int q = q0; q < qe; ++q) {
      const int iw = iw0 + 4 * q;
      const bool in = ok && static_cast<unsigned>(iw) < static_cast<unsigned>(W);
      cp8(dst + 4 * q, in ? src + iw : any, in);
    }
  } else if constexpr (XV == 2) {
    for (int q = q0; q < qe; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int iw = iw0 + 4 * q + 2 * h;
        const bool in =
            ok && static_cast<unsigned>(iw) < static_cast<unsigned>(W);
        cp4(dst + 4 * q + 2 * h, in ? src + iw : any, in);
      }
    }
  } else if (sw == 1) {  // element by element along the row (NCHW)
    element_copies<false>(dst, src, any, ok, iw0, q0, qe, W, 1);
  } else {  // element by element, sw elements apart (CHWN)
    element_copies<true>(dst, src, any, ok, iw0, q0, qe, W, sw);
  }
}

template <typename TX, int BM, bool POOL, int FT, bool THIN>
__global__ void __launch_bounds__(kThreads, 1)
conv_nchw_bf16_kernel(const K2Args<TX, bf16> a) {
  constexpr int NS = BM == 256 ? 2 : 3;  // ring stages
  constexpr int WM = BM / 32;   // warps along Co, 32 rows each
  constexpr int WN = 8 / WM;    // warps along the columns
  // the ring in bf16 bits (stage s at s STAGE halfwords), then for THIN the
  // k tables; the epilogue tile over them
  extern __shared__ __align__(16) float smem[];
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem);
  int* kx = reinterpret_cast<int*>(smem + a.RING);  // [KP] x box offsets
  int* kw = kx + a.KP;                              // [KP] w offsets, or -1
  Tile t = make_tile(a);
  box_bf16(a, t);
  const int co0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int FF = a.F * a.F, CF = a.Ci * a.F;

  if (tid >= kConsumers) {
    // ---- the producer warpgroup: every stage's copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    const int XU = t.XW / (a.XV == 8 ? 8 : 4);  // copy units of a box row
    // x box channels of a stage: 16 ga (or Ci and the zero one)
    const int cv = THIN ? a.Ci + 1 : 16 * a.GA;
    if (THIN) {
      for (int k = pt; k < a.KP; k += kProducers) {
        const int dyl = k / CF, r = k - dyl * CF, ci = r / a.F;
        kw[k] = k < a.TR * CF ? ci * FF + dyl * a.F + (r - ci * a.F) : -1;
      }
      bar_sync(prod_bar<NS>(), kProducers);
    }
    auto stage = [&](int sl) {
      const int oct = sl / a.tblocks, tb = sl - oct * a.tblocks;
      const int dy0 = tb * a.TR, trc = min(a.TR, a.F - dy0);
      unsigned short* st = ring + (sl % NS) * a.STAGE;
      if (THIN) {
        // w rows co0 .. co0 + BM - 1: the k list of tap rows dy0 .. dy0 +
        // trc - 1 in pairs, zero past it
        const int kv = trc * CF, kq = a.KP / 2;
        const int segs = max(1, min(kq, kProducers / BM));
        const int len = (kq + segs - 1) / segs;
        for (int it = pt; it < BM * segs; it += kProducers) {
          const int r = it / segs, q0 = (it - r * segs) * len;
          const int co = co0 + r;
          const bf16* src =
              a.w + static_cast<long long>(co) * a.K + dy0 * a.F;
          unsigned* dst = reinterpret_cast<unsigned*>(st + r * a.SA);
          for (int q = q0; q < min(kq, q0 + len); ++q) {
            const bool ok0 = co < a.Co && 2 * q < kv;
            const bool ok1 = co < a.Co && 2 * q + 1 < kv;
            dst[q] = bf16_bits(ok0 ? src + kw[2 * q] : a.w, ok0) |
                     (bf16_bits(ok1 ? src + kw[2 * q + 1] : a.w, ok1) << 16);
          }
        }
      } else if (a.TR == a.F) {
        // w rows co0 .. co0 + BM - 1, k [oct 16 ga F^2, + 16 ga F^2):
        // contiguous, 16-byte chunks
        const int wq = 2 * a.GA * FF, k0 = oct * 16 * a.GA * FF;
        const int segs = max(1, min(wq, kProducers / BM));
        const int len = (wq + segs - 1) / segs;
        for (int it = pt; it < BM * segs; it += kProducers) {
          const int r = it / segs, q0 = (it - r * segs) * len;
          const int co = co0 + r;
          const bf16* src = a.w + static_cast<long long>(co) * a.K + k0;
          bf16* dst = reinterpret_cast<bf16*>(st + r * a.SA);
          for (int q = q0; q < min(wq, q0 + len); ++q) {
            const int c = 8 * q;
            const int valid = co < a.Co ? min(8, a.K - (k0 + c)) : 0;
            chunk8(dst + c, valid > 0 ? src + c : a.w, valid, a.vec_w);
          }
        }
      } else {
        // tap rows dy0 .. dy0 + trc - 1 of 16 channels: a run of trc F
        // weights per channel, halfword by halfword
        const int run = trc * a.F;
        for (int it = pt; it < BM * 16; it += kProducers) {
          const int r = it >> 4, c16 = it & 15;
          const int co = co0 + r, ci = oct * 16 + c16;
          const bool ok = co < a.Co && ci < a.Ci;
          const bf16* src = a.w + static_cast<long long>(co) * a.K + ci * FF +
                            dy0 * a.F;
          unsigned short* dst = st + r * a.SA + c16 * a.TF;
          for (int j = 0; j < run; ++j)
            dst[j] = static_cast<unsigned short>(
                bf16_bits(ok ? src + j : a.w, ok));
        }
      }
      // the x box of the stage's channels for these tap rows:
      // [cv][NB][XH][XW], rows (OH - 1) S + trc of each image, each row
      // cut into segments of copy units as the float32 kernel cuts it; a
      // thin slot's zero channel is filled by the slot's first stage only
      unsigned short* xs = st + BM * a.SA;
      const int xhn = (t.OH - 1) * a.S + trc;
      const int rows = (THIN && sl >= NS ? a.Ci : cv) * t.NBc * xhn;
      const int segs = max(1, min(XU, kProducers / rows));
      const int len = (XU + segs - 1) / segs;
      Radix d = radix_of(pt, segs, xhn, t.NBc);
      const Radix s = radix_of(kProducers, segs, xhn, t.NBc);
      for (int it = pt; it < rows * segs; it += kProducers) {
        const int q0 = d.d0 * len, xh = d.d1, nl = d.d2, c = d.d3;
        radix_add(d, s, segs, xhn, t.NBc);
        const int ci = THIN ? c : oct * 16 * a.GA + c;
        const int ih = t.ih0 + dy0 + xh;
        unsigned short* dst = xs + c * a.XSTR + (nl * t.XH + xh) * t.XW;
        const bool rok = ci < a.Ci && static_cast<unsigned>(ih) <
                                          static_cast<unsigned>(a.H);
        const TX* src =
            rok ? a.x + static_cast<long long>(t.n0 + nl) * a.xs.n +
                      static_cast<long long>(ci) * a.xs.c +
                      static_cast<long long>(ih) * a.xs.h
                : a.x;
        const int qe = min(XU, q0 + len);
        switch (a.XV) {
          case 8:
            box_row<TX, 8>(dst, src, a.x, rok, t.iw0, q0, qe, a.W, a.xs.w);
            break;
          case 4:
            box_row<TX, 4>(dst, src, a.x, rok, t.iw0, q0, qe, a.W, a.xs.w);
            break;
          case 2:
            box_row<TX, 2>(dst, src, a.x, rok, t.iw0, q0, qe, a.W, a.xs.w);
            break;
          default:
            box_row<TX, 1>(dst, src, a.x, rok, t.iw0, q0, qe, a.W, a.xs.w);
        }
      }
    };
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < a.nsl) stage(q);
      cp_commit();
    }
    for (int sl = 0; sl < a.nsl; ++sl) {
      cp_wait<NS - 2>();  // stage sl has landed: announce it
      bar_arrive(full_bar(sl % NS), kThreads);
      const int nx = sl + NS - 1;
      if (nx < a.nsl) {
        if (nx >= NS) bar_sync(empty_bar<NS>(nx % NS), kThreads);
        stage(nx);
      }
      cp_commit();
    }
    return;
  }

  // ---- the consumer warpgroups: the products and the epilogue ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int F = FT ? FT : a.F, TF = FT ? FT * FT : a.TF;
  const int SA = FT == 3 ? 16 * 9 + 8 : a.SA;  // 3x3 stages hold one group
  constexpr int U = FT ? FT * FT : 1;
  const int OHW = t.OH * t.OW;
  if (THIN) {
    // the x box offset of each k of a stage's list; past it, the zero
    // channel (index Ci)
    for (int k = tid; k < a.KP; k += kConsumers) {
      const int dyl = k / CF, r = k - dyl * CF, ci = r / a.F;
      kx[k] = k < a.TR * CF
                  ? ci * a.XSTR + dyl * t.XW + (r - ci * a.F)
                  : a.Ci * a.XSTR;
    }
    bar_sync(cons_bar<NS>(), kConsumers);
  }

  // the box offset of column g of each of this warp's column tiles, as the
  // float32 kernel's
  int boff[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = min((nt * WN + wn) * 8 + g, t.C - 1);
    const int nl = c / OHW, r = c - nl * OHW;
    const int ohl = r / t.OW, owl = r - ohl * t.OW;
    boff[nt] = nl * t.XH * t.XW + ohl * a.S * t.XW + owl * a.S + t.sh;
  }

  float tot[2][8][4];
  set_zero(tot);
  for (int sl = 0; sl < a.nsl; ++sl) {
    const int buf = sl % NS;
    const int tb = FT ? 0 : sl % a.tblocks;
    const int trc = FT ? FT : min(a.TR, F - tb * a.TR);
    bar_sync(full_bar(buf), kThreads);
    const unsigned short* Ws = ring + buf * a.STAGE + (wm * 32 + g) * SA;
    const unsigned short* Xs = ring + buf * a.STAGE + BM * SA;
    if (THIN) {
      // k16 steps along the stage's k list; k past this stage's list (its
      // weights are 0) reads the zero channel, never rows of an earlier
      // stage (a NaN there must not leak)
      const int kv = trc * CF, steps = (kv + 15) / 16, zx = a.Ci * a.XSTR;
      for (int ks = 0; ks < steps; ++ks) {
        const int k0 = ks * 16 + tq;
        unsigned af[2][4];
        load_a16(Ws + k0, SA, 4, af);
        mma_step16(tot, af, Xs + (k0 < kv ? kx[k0] : zx),
                   Xs + (k0 + 4 < kv ? kx[k0 + 4] : zx),
                   Xs + (k0 + 8 < kv ? kx[k0 + 8] : zx),
                   Xs + (k0 + 12 < kv ? kx[k0 + 12] : zx), boff);
      }
    } else if (FT == 1) {
      // 1x1: one tap, the stage's groups of 16 channels a step each
      for (int o2 = 0; o2 < a.GA; ++o2) {
        unsigned af[2][4];
        load_a16(Ws + o2 * 16 + tq, SA, 4, af);
        const unsigned short* xr = Xs + (o2 * 16 + tq) * a.XSTR;
        mma_step16(tot, af, xr, xr + 4 * a.XSTR, xr + 8 * a.XSTR,
                   xr + 12 * a.XSTR, boff);
      }
    } else {
      // 16 channels at one tap a step
      const int taps = trc * F;
      const unsigned short* Xq = Xs + tq * a.XSTR;
#pragma unroll U
      for (int r = 0; r < taps; ++r) {
        unsigned af[2][4];
        load_a16(Ws + tq * TF + r, SA, 4 * TF, af);
        const int dy = r / F;
        const unsigned short* xr = Xq + dy * t.XW + (r - dy * F);
        mma_step16(tot, af, xr, xr + 4 * a.XSTR, xr + 8 * a.XSTR,
                   xr + 12 * a.XSTR, boff);
      }
    }
    if (sl + NS < a.nsl) bar_arrive(empty_bar<NS>(buf), kThreads);
  }

  epilogue<BM, NS, POOL>(a, t, smem, tot, co0, tid);
}

// K2's shared-memory layout at a block tile (ops.py::k2_layout computes
// the same): a ring of stages (3; 2 at bm 256), each the w slice and the
// x box of its taps, or the epilogue tile [bm][16384 / bm + 8] over the
// ring where that is larger.  A stage holds ga groups of 8 channels at tr
// tap rows (ga > 1 only for 1x1 convs), w [bm][8 ga tr F + 4] and x
// [8 ga][nb XH XW]; thin (Ci < 8), the k list of tr tap rows, w [bm][KP +
// 4] (KP = tr Ci F padded to 8) and x [Ci + 1][nb XH XW], and after the
// ring the two k tables [2 KP] (ints)
struct Layout {
  int sa, xstr, stage, ring, kp;
  long long bytes;  // -1: no such tile
};
Layout layout(int Ci, int F, int S, int pool_F, int pool_S, int bm, int nb,
              int uth, int utw, int tr, int ga) {
  Layout l{};
  l.bytes = -1;
  const bool thin = Ci < 8;
  if ((bm != 64 && bm != 128 && bm != 256) || nb < 1 || uth < 1 ||
      utw < 1 || tr < 1 || tr > F || ga < 1 || (ga > 1 && (F != 1 || thin)) ||
      (thin && bm == 256))
    return l;
  const int oth = pool_F > 0 ? (uth - 1) * pool_S + pool_F : uth;
  const int otw = pool_F > 0 ? (utw - 1) * pool_S + pool_F : utw;
  if (static_cast<long long>(nb) * oth * otw > kTile / bm) return l;
  const int xh = (oth - 1) * S + tr, xw = (3 + (otw - 1) * S + F + 3) & ~3;
  l.kp = thin ? (tr * Ci * F + 7) / 8 * 8 : 0;
  l.sa = thin ? l.kp + 4 : 8 * ga * tr * F + 4;
  l.xstr = rows8(nb * xh * xw);
  l.stage = bm * l.sa + (thin ? Ci + 1 : 8 * ga) * l.xstr;
  const long long ring = (bm == 256 ? 2LL : 3LL) * l.stage;
  const long long tile = static_cast<long long>(bm) * (kTile / bm + 8);
  l.ring = static_cast<int>(ring > tile ? ring : tile);
  l.bytes = 4 * (static_cast<long long>(l.ring) + 2 * l.kp);
  return l;
}

// The bf16 builds' layout at the same tile (ops.py::k2_bf16_layout computes
// the same), in halfwords: a stage holds gb = ceil(ga / 2) groups of 16
// channels at tr tap rows, w [bm][16 gb tr F + 8] and x [16 gb][nb XH XW];
// thin, the k list of tr tap rows padded to 16 (KP), w [bm][KP + 8] and x
// [Ci + 1][nb XH XW]; after the ring the two k tables [2 KP] (ints), the
// epilogue tile over both.  The box's width follows the copy lane xv (8:
// from a column aligned down to 8, a multiple of 8; else of 4 from one
// aligned down to xv); where xv 8's box would take more than ``fit``
// bytes (the float32 layout's), the lane falls back to ``xv_else``.  Every
// other lane's box is no wider than the float32 box, so its stages take at
// most the float32 stages' bytes.
struct LayoutBf16 {
  int sa, xstr, stage, ring, kp, gb, xv;  // ring: floats before the tables
  long long bytes;
};
LayoutBf16 layout_bf16(int Ci, int F, int S, int pool_F, int pool_S, int bm,
                       int nb, int uth, int utw, int tr, int ga, int xv,
                       int xv_else, long long fit) {
  LayoutBf16 b{};
  const bool thin = Ci < 8;
  const int oth = pool_F > 0 ? (uth - 1) * pool_S + pool_F : uth;
  const int otw = pool_F > 0 ? (utw - 1) * pool_S + pool_F : utw;
  const int xh = (oth - 1) * S + tr, span = (otw - 1) * S + F;
  b.kp = thin ? (tr * Ci * F + 15) / 16 * 16 : 0;
  b.gb = (ga + 1) / 2;
  b.sa = thin ? b.kp + 8 : 16 * b.gb * tr * F + 8;
  const int cv = thin ? Ci + 1 : 16 * b.gb;
  const long long tile = 4LL * bm * (kTile / bm + 8);
  auto at = [&](int v) {
    const int m = v == 8 ? 8 : 4;
    b.xv = v;
    b.xstr = rows8(nb * xh * ((v - 1 + span + m - 1) & -m));
    b.stage = bm * b.sa + cv * b.xstr;
    const long long ring = (bm == 256 ? 2LL : 3LL) * b.stage;
    b.ring = static_cast<int>(ring / 2);
    b.bytes = 2 * ring + 8LL * b.kp;
    if (b.bytes < tile) b.bytes = tile;
  };
  at(xv);
  if (xv == 8 && b.bytes > fit) at(xv_else);
  return b;
}

template <int BM, bool POOL, int FT, bool THIN, typename TX, typename TW>
cudaError_t launch_f(const K2Args<TX, TW>& a, dim3 grid, int smem,
                     cudaStream_t st) {
  void (*kernel)(const K2Args<TX, TW>);
  if constexpr (std::is_same<TW, bf16>::value)
    kernel = conv_nchw_bf16_kernel<TX, BM, POOL, FT, THIN>;
  else
    kernel = conv_nchw_kernel<TX, TW, BM, POOL, FT, THIN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int BM, bool POOL, typename TX, typename TW>
cudaError_t launch(const K2Args<TX, TW>& a, dim3 grid, int smem,
                   cudaStream_t st) {
  if constexpr (BM != 256) {  // thin inputs take 64 or 128 rows
    if (a.Ci < 8) return launch_f<BM, POOL, 0, true>(a, grid, smem, st);
  }
  if (a.TR == a.F && a.F == 3)
    return launch_f<BM, POOL, 3, false>(a, grid, smem, st);
  if (a.F == 1) return launch_f<BM, POOL, 1, false>(a, grid, smem, st);
  return launch_f<BM, POOL, 0, false>(a, grid, smem, st);
}

template <typename TX, typename TW>
int forward(const void* x, const void* w, const void* bias, const void* res,
            void* y, void* z, int N, int Ci, int H, int W, int Co, int F,
            int S, int pad, int pool_F, int pool_S, int pool_avg, int relu,
            int src_nchw, int dst_nchw, int res_nchw, int bm, int nb, int uth,
            int utw, int tr, int ga, void* stats, void* stream) {
  const Layout l =
      layout(Ci, F, S, pool_F, pool_S, bm, nb, uth, utw, tr, ga);
  if (l.bytes < 0 || l.bytes > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  K2Args<TX, TW> a{};
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
  const bool pool = pool_F > 0;
  a.UH = pool ? (a.Ho - pool_F) / pool_S + 1 : a.Ho;
  a.UW = pool ? (a.Wo - pool_F) / pool_S + 1 : a.Wo;
  a.NB = nb; a.UTH = uth; a.UTW = utw;
  a.nTH = (a.UH + uth - 1) / uth;
  a.nTW = (a.UW + utw - 1) / utw;
  a.TR = tr;
  a.TF = tr * F;
  a.tblocks = (F + tr - 1) / tr;
  a.GA = ga;
  a.SA = l.sa;
  a.XSTR = l.xstr;
  a.STAGE = l.stage;
  a.RING = l.ring;
  a.KP = l.kp;
  a.nsl = (Ci < 8 ? 1 : ((Ci + 7) / 8 + ga - 1) / ga) * a.tblocks;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  a.vec_x = src_nchw && W % 4 == 0 && xa % 16 == 0;
  a.pair_x = src_nchw && W % 2 == 0 && xa % 8 == 0;
  a.vec_w = a.K % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  long long smem_bytes = l.bytes;
  if constexpr (std::is_same<TW, bf16>::value) {
    // 16-channel bf16 stages in the float32 layout's bytes; the widest box
    // lane x's layout, W and alignment allow (ops.py::k2_bf16_xv)
    constexpr bool kI8 = std::is_same<TX, int8_t>::value;
    int xv = 1;
    if (src_nchw && W % 8 == 0 && xa % (kI8 ? 8 : 16) == 0)
      xv = 8;
    else if (!kI8 && src_nchw && W % 4 == 0 && xa % 8 == 0)
      xv = 4;
    else if (!kI8 && src_nchw && W % 2 == 0 && xa % 4 == 0)
      xv = 2;
    const LayoutBf16 b = layout_bf16(Ci, F, S, pool_F, pool_S, bm, nb, uth,
                                     utw, tr, ga, xv, kI8 ? 1 : 4, l.bytes);
    if (b.bytes > l.bytes) return static_cast<int>(cudaErrorInvalidValue);
    a.GA = b.gb;
    a.SA = b.sa;
    a.XSTR = b.xstr;
    a.STAGE = b.stage;
    a.RING = b.ring;
    a.KP = b.kp;
    a.XV = b.xv;
    a.nsl = (Ci < 8 ? 1 : ((Ci + 15) / 16 + b.gb - 1) / b.gb) * a.tblocks;
    a.vec_w = a.K % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    smem_bytes = b.bytes;
  }
  a.xs = repro::layout_strides(src_nchw, N, Ci, H, W);
  a.rs = repro::layout_strides(res_nchw, N, Co, a.Ho, a.Wo);
  a.zs = repro::layout_strides(true, N, Co, a.Ho, a.Wo);
  a.ys = repro::layout_strides(dst_nchw, N, Co, a.UH, a.UW);
  a.stats = static_cast<unsigned long long*>(stats);
  if (N <= 0 || Co <= 0 || Ci <= 0 || a.UH <= 0 || a.UW <= 0)
    return static_cast<int>(cudaGetLastError());
  const long long blocks =
      static_cast<long long>((N + nb - 1) / nb) * a.nTH * a.nTW;
  if (blocks > 0x7fffffffLL || (Co + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), (Co + bm - 1) / bm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem_bytes);
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

}  // namespace

// Host entry of K2: w [Co, Ci, F, F] is [Co, K]; z (or null) is [N, Co, Ho,
// Wo], of y's type.  The block tile is bm output channels by the
// conv outputs under nb images x uth x utw units (pooled outputs with a
// pool, conv outputs without), tr tap rows and ga 8-channel groups a stage
// (ops.nchw_tiling).  stats (or null): one uint64 on the card that the
// blocks add their executed FLOPs to.  x is REPRO_XT, w, bias, res and y
// REPRO_WT (storage.cuh: conv_nchw_forward is float32,
// conv_nchw_forward_<variant> a storage variant).  Returns a cudaError_t
// code.
extern "C" int REPRO_ENTRY(conv_nchw_forward)(
    const void* x, const void* w, const void* bias, const void* res, void* y,
    void* z, int N, int Ci, int H, int W, int Co, int F, int S, int pad,
    int pool_F, int pool_S, int pool_avg, int relu, int src_nchw,
    int dst_nchw, int res_nchw, int bm, int nb, int uth, int utw, int tr,
    int ga, void* stats, void* stream) {
  return forward<REPRO_XT, REPRO_WT>(x, w, bias, res, y, z, N, Ci, H, W, Co,
                                     F, S, pad, pool_F, pool_S, pool_avg,
                                     relu, src_nchw, dst_nchw, res_nchw, bm,
                                     nb, uth, utw, tr, ga, stats, stream);
}
