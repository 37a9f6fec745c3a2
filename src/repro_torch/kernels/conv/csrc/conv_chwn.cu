// K1: the direct CHWN convolution engine, with its fused epilogue.
//
// Replaces repro/kernels/conv/conv.py::conv_chwn_pallas (body _conv_kernel),
// the cuda-convnet analogue the paper pairs with CHWN: out[co,ho,wo,n] +=
// x[ci,ho*S+dy,wo*S+dx,n] * w[ci,dy,dx,co], fp32 accumulate, then bias ->
// residual -> ReLU -> max/avg pool, reading x in src_layout and writing y
// in dst_layout.  x is [Ci,H,W,N] or [N,Ci,H,W]; w is [Ci,F,F,Co]; y is
// [Co,Ho',Wo',N] or [N,Co,Ho',Wo'] (Ho', Wo' after the pool).
//
// What bounds it on an H100: at the paper's shapes the conv is far above
// the fp32 ridge (2*Ci*F*F FLOPs per output against a few bytes), so the
// bound is the CUDA cores' fp32 FMA rate.  The design (conv_common.cuh) is
// an implicit GEMM with shared-memory tiles and an 8 x 8 register tile per
// thread, so each operand loaded from shared memory feeds 8 FMAs, with n
// the fastest column so a warp's CHWN gathers and stores are one
// contiguous run.  It does not use the tensor cores (fp32 exactness); the
// TPU kernel's halo stitch, row/channel padding and N tiling have no
// counterpart here.
//
// With z (the save_act output, for training), it also writes the conv
// output before the pool, as [Co, Ho, Wo, N] (CHWN)
// (conv_common.cuh says how overlapping windows share the writes).
#include "conv_common.cuh"

extern "C" int conv_chwn_forward(const void* x, const void* w,
                                 const void* bias, const void* res, void* y,
                                 void* z, int N, int Ci, int H, int W, int Co,
                                 int F, int S, int pad, int pool_F,
                                 int pool_S, int pool_avg, int relu,
                                 int src_nchw, int dst_nchw, int res_nchw,
                                 void* stream) {
  // w [Ci, F, F, Co] is [K, Co]
  return repro::conv_forward<true>(x, w, bias, res, y, z, N, Ci, H, W, Co,
                                   F, S, pad, pool_F, pool_S, pool_avg, relu,
                                   src_nchw, dst_nchw, res_nchw,
                                   /*wsO=*/1, /*wsK=*/Co, stream);
}
