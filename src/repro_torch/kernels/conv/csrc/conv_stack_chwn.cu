// K5a: the conv -> conv stack on the CHWN engine, in one kernel.
//
// Replaces repro/kernels/conv/stack.py::conv_stack_chwn_pallas (body
// _stack_chwn_kernel): conv1 [+bias1] [+ReLU] -> conv2 with the full
// bias/residual/ReLU/max-avg-pool epilogue, the mid activation kept in
// shared memory and never written to device memory.  x is [Ci,H,W,N] or
// [N,Ci,H,W]; w1 is [Ci,F1,F1,Cm], w2 [Cm,F2,F2,Co]; y is [Co,Ho',Wo',N] or
// [N,Co,Ho',Wo'] (Ho', Wo' after the pool); the residual is read in its own
// layout, before the ReLU.
//
// What bounds it on an H100: operations.  At AlexNet's conv3 -> conv4
// (N = 128, 256 -> 384 -> 384, 13x13) both convs are far above the fp32
// ridge, so the bound is the CUDA cores' fp32 FMA rate, 67 TFLOP/s; the
// mid tensor it keeps off the device is a small share of that time.  The
// design (conv_stack_common.cuh) is two implicit GEMMs sharing one block:
// conv1 fills a shared-memory slab of 64 mid channels over the block's
// tile plus halo, conv2 accumulates that slab into an 8 x 8-per-thread
// register tile, chunk by chunk, so the slab never has to hold all Cm
// channels.  n is the fastest column, so a warp's CHWN gathers and stores
// run along n.  The price is recompute: conv1 on each tile's halo and
// once per 64/128/256-wide slice of Co; the wrapper picks the tile that
// executes the fewest FLOPs per wave.  No tensor cores (fp32 exactness);
// the TPU kernel's halo stitch, row padding, padded input copy and N tile
// have no counterpart here.
#include "conv_stack_common.cuh"

extern "C" int conv_stack_chwn_forward(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* res, void* y, int N, int Ci, int H, int W,
    int Cm, int F1, int S1, int P1, int Co, int F2, int S2, int P2,
    int pool_F, int pool_S, int pool_avg, int relu1, int relu2, int src_nchw,
    int dst_nchw, int res_nchw, int bm, int nb, int uth, int utw,
    void* stream) {
  // w1 [Ci, F1, F1, Cm] is [K1, Cm]; w2 [Cm, F2, F2, Co] is [K2, Co]
  return repro::stack::stack_forward<true>(
      x, w1, b1, w2, b2, res, y, N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2,
      pool_F, pool_S, pool_avg, relu1, relu2, src_nchw, dst_nchw, res_nchw,
      bm, nb, uth, utw, /*w1O=*/1, /*w1K=*/Cm, /*w2O=*/1, /*w2K=*/Co, stream);
}
