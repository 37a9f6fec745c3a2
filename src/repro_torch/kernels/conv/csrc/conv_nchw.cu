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
// What bounds it on an H100: the fp32 FMA rate of the CUDA cores at the
// paper's shapes.  A block multiplies a 64-filter x 128-column
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

using namespace repro;

// w [Co, Ci, F, F] is [Co, K]; z (or null) is [N, Co, Ho, Wo].  Returns
// cudaGetLastError().
extern "C" int conv_nchw_forward(const void* x, const void* w,
                                 const void* bias, const void* res, void* y,
                                 void* z, int N, int Ci, int H, int W, int Co,
                                 int F, int S, int pad, int pool_F,
                                 int pool_S, int pool_avg, int relu,
                                 int src_nchw, int dst_nchw, int res_nchw,
                                 void* stream) {
  ConvArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const float*>(res);
  a.y = static_cast<float*>(y);
  a.z = static_cast<float*>(z);
  a.N = N; a.Ci = Ci; a.H = H; a.W = W; a.Co = Co; a.F = F; a.S = S;
  a.pad = pad;
  a.K = Ci * F * F;
  a.Ho = (H + 2 * pad - F) / S + 1;
  a.Wo = (W + 2 * pad - F) / S + 1;
  a.pF = pool_F; a.pS = pool_S; a.pool_avg = pool_avg; a.relu = relu;
  a.xs = layout_strides(src_nchw, N, Ci, H, W);
  a.rs = layout_strides(res_nchw, N, Co, a.Ho, a.Wo);
  a.zs = layout_strides(true, N, Co, a.Ho, a.Wo);
  const bool pool = pool_F > 0;
  if (pool) {
    a.UH = (a.Ho - pool_F) / pool_S + 1;
    a.UW = (a.Wo - pool_F) / pool_S + 1;
    a.T = pool_F * pool_F;
  } else {
    a.UH = a.Ho;
    a.UW = a.Wo;
    a.T = 1;
  }
  if (a.T > BN) return static_cast<int>(cudaErrorInvalidValue);
  a.BU = BN / a.T;
  a.units = N * a.UH * a.UW;
  a.ys = layout_strides(dst_nchw, N, Co, a.UH, a.UW);
  if (a.units <= 0 || Co <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((a.units + a.BU - 1) / a.BU, (Co + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool)
    conv_gemm_kernel<true><<<grid, kThreads, 0, st>>>(a);
  else
    conv_gemm_kernel<false><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
