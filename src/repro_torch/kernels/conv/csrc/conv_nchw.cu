// K2: the NCHW convolution engine over a virtual im2col matrix, with its
// fused epilogue.
//
// Replaces repro/kernels/conv/im2col_mm.py::conv_nchw_pallas (body
// _conv_nchw_kernel), the Caffe/cuDNN analogue: per sample, the conv is the
// product of the filter matrix [Co x Ci*F*F] with the im2col patch matrix
// [Ci*F*F x Ho*Wo].  The patch matrix is never built: each block gathers
// the slice of it that it multiplies straight from x into shared memory,
// so in device memory it exists only as addresses.  Same epilogue and
// layout-fold protocol as K1 (bias -> residual -> ReLU -> max/avg pool;
// src/dst layouts NCHW or CHWN).
// x is [N,Ci,H,W] or [Ci,H,W,N]; w is canonical [Co,Ci,F,F]; y is
// [N,Co,Ho',Wo'] or [Co,Ho',Wo',N].
//
// What bounds it on an H100: as for K1, the fp32 FMA rate of the CUDA
// cores at the paper's shapes.  A block multiplies a 64-filter x 128-column
// tile through shared memory, each thread an 8 x 8 register tile of it
// (conv_common.cuh), and the output column is the fastest GEMM column, so
// a warp's NCHW gathers and stores run along W.  No tensor cores (fp32
// exactness); the TPU kernel's halo stitch and channel/row padding have no
// counterpart here.
//
// With z (the save_act output, for training), it also writes the conv
// output before the pool, as [N, Co, Ho, Wo] (NCHW)
// (conv_common.cuh says how overlapping windows share the writes).
#include "conv_common.cuh"

extern "C" int conv_nchw_forward(const void* x, const void* w,
                                 const void* bias, const void* res, void* y,
                                 void* z, int N, int Ci, int H, int W, int Co,
                                 int F, int S, int pad, int pool_F,
                                 int pool_S, int pool_avg, int relu,
                                 int src_nchw, int dst_nchw, int res_nchw,
                                 void* stream) {
  // w [Co, Ci, F, F] is [Co, K]
  return repro::conv_forward<false>(x, w, bias, res, y, z, N, Ci, H, W, Co,
                                    F, S, pad, pool_F, pool_S, pool_avg, relu,
                                    src_nchw, dst_nchw, res_nchw,
                                    /*wsO=*/Ci * F * F, /*wsK=*/1, stream);
}
