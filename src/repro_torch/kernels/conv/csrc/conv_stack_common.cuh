// The tile helpers of the conv -> conv stack kernels, K5a
// (conv_stack_chwn.cu) and K5b (conv_stack_nchw.cu): the launch arguments
// (StackArgs, over the storage type E of the weights, biases, residual and
// output, float32 or bf16, and X of x, E's or int8; the mid activation
// stays float32), a block's tile of output units and the clipped mid box
// it reads (make_tile, mid_span).
//
// A block owns NB images x UTH x UTW output units (a unit is one conv2
// output, or one pooled output whose T = pF*pF taps are the conv2 outputs
// of its window).  Its mid box is the conv2 outputs' (F2-1) halo, clipped
// to the real mid extent [0, Ho1) x [0, Wo1): positions outside it are
// conv2's zero padding.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "conv_common.cuh"  // Strides, layout_strides

namespace repro {
namespace stack {

template <typename E = float, typename X = E>
struct StackArgs {
  const X* x;
  const E* w1;      // w1[cm * w1O + k1 * w1K], k1 = (ci, dy, dx)
  const E* b1;      // [Cm] or null
  const E* w2;      // w2[co * w2O + k2 * w2K], k2 = (cm, dy, dx)
  const E* b2;      // [Co] or null
  const E* res;     // conv2-output (pre-pool) shape, or null
  E* y;
  int N, Ci, H, W, Cm, F1, S1, P1, K1, Ho1, Wo1;
  int Co, F2, S2, P2, Ho2, Wo2;
  int pF, pS, pool_avg, relu1, relu2, T;
  int UH, UW;          // unit grid: the pooled output, or conv2's output
  int NB, UTH, UTW, BU;  // block tile in units (BU = NB*UTH*UTW)
  int nTH, nTW;        // tiles along the unit rows / cols
  int RSTR;            // mid slab row stride (at least the unclipped box)
  int w1O, w1K, w2O, w2K;
  Strides xs, ys, rs;
};

// one block's tile: its first image/unit, how much of it is real, and the
// clipped mid box it reads (rows [mh_lo, mh_lo + MHc), columns [mw_lo,
// mw_lo + MWc), RA = NBc * MHc * MWc positions)
struct Tile {
  int n0, uh0, uw0, NBc, UTHc, UTWc;
  int mh_lo, mw_lo, MHc, MWc, RA;
};

// mid rows [lo, lo + count) that conv2 outputs o0 .. o0+on-1 read, clipped
// to the real mid extent [0, M1)
__device__ __forceinline__ void mid_span(int o0, int on, int S2, int P2,
                                         int F2, int M1, int& lo, int& cnt) {
  const int m0 = o0 * S2 - P2, m1 = (o0 + on - 1) * S2 - P2 + F2;
  lo = m0 > 0 ? m0 : 0;
  cnt = (m1 < M1 ? m1 : M1) - lo;
  if (cnt < 0) cnt = 0;
}

template <typename E, typename X>
__device__ __forceinline__ Tile make_tile(const StackArgs<E, X>& a) {
  Tile t;
  int b = blockIdx.x;
  const int tw = b % a.nTW;
  b /= a.nTW;
  const int th = b % a.nTH, ng = b / a.nTH;
  t.n0 = ng * a.NB;
  t.uh0 = th * a.UTH;
  t.uw0 = tw * a.UTW;
  t.NBc = min(a.NB, a.N - t.n0);
  t.UTHc = min(a.UTH, a.UH - t.uh0);
  t.UTWc = min(a.UTW, a.UW - t.uw0);
  const bool pool = a.pF > 0;
  const int oh0 = pool ? t.uh0 * a.pS : t.uh0;
  const int ohn = pool ? (t.UTHc - 1) * a.pS + a.pF : t.UTHc;
  const int ow0 = pool ? t.uw0 * a.pS : t.uw0;
  const int own = pool ? (t.UTWc - 1) * a.pS + a.pF : t.UTWc;
  mid_span(oh0, ohn, a.S2, a.P2, a.F2, a.Ho1, t.mh_lo, t.MHc);
  mid_span(ow0, own, a.S2, a.P2, a.F2, a.Wo1, t.mw_lo, t.MWc);
  t.RA = t.NBc * t.MHc * t.MWc;
  return t;
}

}  // namespace stack
}  // namespace repro
