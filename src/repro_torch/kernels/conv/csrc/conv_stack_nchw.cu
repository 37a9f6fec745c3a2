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

namespace repro {
namespace stack {

// dynamic shared memory of one block, in bytes (ops.py::stack_tiling
// computes the same number)
template <int GM>
inline long long smem_bytes(int rstr, bool pool) {
  using S = Shape<GM>;
  long long slab = (long long)kCM * rstr;
  const long long ts = pool ? (long long)S::TBM * (S::TBN + 1) : 0;
  if (ts > slab) slab = ts;
  return 4 * ((long long)kBK * S::ASTR + (long long)kBK * S::BSTR + slab);
}

template <bool POOL, int GM>
int launch(const StackArgs& a, dim3 grid, cudaStream_t st) {
  const long long bytes = smem_bytes<GM>(a.RSTR, POOL);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_stack_kernel<POOL, GM>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, (size_t)bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Host entry of K5b: fills StackArgs from the shapes and the tile the
// wrapper chose (bm output channels; nb x uth x utw units), and launches.
// The caller passes the weight layouts.  Returns a cudaError_t code.
int stack_forward(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* res, void* y,
                  int N, int Ci, int H, int W, int Cm, int F1, int S1, int P1,
                  int Co, int F2, int S2, int P2, int pool_F, int pool_S,
                  int pool_avg, int relu1, int relu2, int src_nchw,
                  int dst_nchw, int res_nchw, int bm, int nb, int uth,
                  int utw, int w1O, int w1K, int w2O, int w2K, void* stream) {
  StackArgs a;
  a.x = static_cast<const float*>(x);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.res = static_cast<const float*>(res);
  a.y = static_cast<float*>(y);
  a.N = N; a.Ci = Ci; a.H = H; a.W = W; a.Cm = Cm;
  a.F1 = F1; a.S1 = S1; a.P1 = P1; a.K1 = Ci * F1 * F1;
  a.Ho1 = (H + 2 * P1 - F1) / S1 + 1;
  a.Wo1 = (W + 2 * P1 - F1) / S1 + 1;
  a.Co = Co; a.F2 = F2; a.S2 = S2; a.P2 = P2;
  a.Ho2 = (a.Ho1 + 2 * P2 - F2) / S2 + 1;
  a.Wo2 = (a.Wo1 + 2 * P2 - F2) / S2 + 1;
  a.pF = pool_F; a.pS = pool_S; a.pool_avg = pool_avg;
  a.relu1 = relu1; a.relu2 = relu2;
  const bool pool = pool_F > 0;
  if (pool) {
    a.UH = (a.Ho2 - pool_F) / pool_S + 1;
    a.UW = (a.Wo2 - pool_F) / pool_S + 1;
    a.T = pool_F * pool_F;
  } else {
    a.UH = a.Ho2;
    a.UW = a.Wo2;
    a.T = 1;
  }
  const int gm = bm / 64;
  if ((gm != 1 && gm != 2 && gm != 4) || bm % 64 || nb < 1 || uth < 1 ||
      utw < 1 || (long long)nb * uth * utw * a.T > kTile / bm)
    return static_cast<int>(cudaErrorInvalidValue);
  a.NB = nb; a.UTH = uth; a.UTW = utw; a.BU = nb * uth * utw;
  a.nTH = (a.UH + uth - 1) / uth;
  a.nTW = (a.UW + utw - 1) / utw;
  const int oth = pool ? (uth - 1) * pool_S + pool_F : uth;
  const int otw = pool ? (utw - 1) * pool_S + pool_F : utw;
  a.RSTR = nb * ((oth - 1) * S2 + F2) * ((otw - 1) * S2 + F2);
  a.w1O = w1O; a.w1K = w1K; a.w2O = w2O; a.w2K = w2K;
  a.xs = layout_strides(src_nchw, N, Ci, H, W);
  a.rs = layout_strides(res_nchw, N, Co, a.Ho2, a.Wo2);
  a.ys = layout_strides(dst_nchw, N, Co, a.UH, a.UW);
  if (N <= 0 || Co <= 0 || a.UH <= 0 || a.UW <= 0)
    return static_cast<int>(cudaGetLastError());
  const dim3 grid(((N + nb - 1) / nb) * a.nTH * a.nTW, (Co + bm - 1) / bm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gm) {
    case 1:
      return pool ? launch<true, 1>(a, grid, st)
                  : launch<false, 1>(a, grid, st);
    case 2:
      return pool ? launch<true, 2>(a, grid, st)
                  : launch<false, 2>(a, grid, st);
    default:
      return pool ? launch<true, 4>(a, grid, st)
                  : launch<false, 4>(a, grid, st);
  }
}

}  // namespace stack
}  // namespace repro

extern "C" int conv_stack_nchw_forward(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* res, void* y, int N, int Ci, int H, int W,
    int Cm, int F1, int S1, int P1, int Co, int F2, int S2, int P2,
    int pool_F, int pool_S, int pool_avg, int relu1, int relu2, int src_nchw,
    int dst_nchw, int res_nchw, int bm, int nb, int uth, int utw,
    void* stream) {
  // w1 [Cm, Ci, F1, F1] is [Cm, K1]; w2 [Co, Cm, F2, F2] is [Co, K2]
  return repro::stack::stack_forward(
      x, w1, b1, w2, b2, res, y, N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2,
      pool_F, pool_S, pool_avg, relu1, relu2, src_nchw, dst_nchw, res_nchw,
      bm, nb, uth, utw, /*w1O=*/Ci * F1 * F1, /*w1K=*/1,
      /*w2O=*/Cm * F2 * F2, /*w2K=*/1, stream);
}
