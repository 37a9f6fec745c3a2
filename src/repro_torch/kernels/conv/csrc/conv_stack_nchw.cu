// K5b: the conv -> conv stack on the per-sample NCHW engine, in one kernel.
//
// Replaces repro/kernels/conv/stack.py::conv_stack_nchw_pallas (body
// _stack_nchw_kernel): the same function as K5a (conv1 [+bias1] [+ReLU] ->
// conv2 with the bias/residual/ReLU/pool epilogue, mid kept on chip) with
// canonical weights w1 [Cm,Ci,F1,F1], w2 [Co,Cm,F2,F2].  x is [N,Ci,H,W]
// or [Ci,H,W,N]; y is [N,Co,Ho',Wo'] or [Co,Ho',Wo',N]; the residual is
// read in its own layout (ResNet-18's CHWN skip from a K1 projection
// folds into this NCHW stack).
//
// What bounds it on an H100: operations, as for K5a.  VGG16's three stacks
// (conv1_1 -> 1_2 and conv2_1 -> 2_2 with the 2/2 max-pool epilogue,
// conv3_1 -> 3_2) and ResNet-18's five residual stacks are all above the
// fp32 ridge: 67 TFLOP/s of fp32 FMA is the limit, and the mid tensor
// (411 MB for VGG16 conv1_1 at batch 32) is what the stack keeps out of
// device memory, not what bounds it.  The design (conv_stack_common.cuh)
// chunks the mid channels through a shared-memory slab between the two
// implicit GEMMs; the output column is the fastest column, so a warp's
// NCHW gathers and stores run along W, and the block's conv2 tile is a
// rectangle of one image so its halo stays small.  No tensor cores (fp32
// exactness).
#include "conv_stack_common.cuh"

extern "C" int conv_stack_nchw_forward(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* res, void* y, int N, int Ci, int H, int W,
    int Cm, int F1, int S1, int P1, int Co, int F2, int S2, int P2,
    int pool_F, int pool_S, int pool_avg, int relu1, int relu2, int src_nchw,
    int dst_nchw, int res_nchw, int bm, int nb, int uth, int utw,
    void* stream) {
  // w1 [Cm, Ci, F1, F1] is [Cm, K1]; w2 [Co, Cm, F2, F2] is [Co, K2]
  return repro::stack::stack_forward<false>(
      x, w1, b1, w2, b2, res, y, N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2,
      pool_F, pool_S, pool_avg, relu1, relu2, src_nchw, dst_nchw, res_nchw,
      bm, nb, uth, utw, /*w1O=*/Ci * F1 * F1, /*w1K=*/1,
      /*w2O=*/Cm * F2 * F2, /*w2K=*/1, stream);
}
