// The strides the conv kernels address every tensor through: K1
// (conv_chwn.cu), K2 (conv_nchw.cu), the stacks K5a/K5b (through
// conv_stack_common.cuh) and the weight gradient K6 (wgrad.cu).  Each
// logical dim (n, c, h, w) has an element stride, so a src/dst/residual
// layout fold is a stride choice, not a code path.
#pragma once

#include <cuda_runtime.h>

namespace repro {

struct Strides {
  int n, c, h, w;
};

// element strides of a [N,C,H,W] (nchw) or [C,H,W,N] tensor
inline Strides layout_strides(bool nchw, int N, int C, int H, int W) {
  if (nchw) return Strides{C * H * W, H * W, W, 1};
  return Strides{1, H * W * N, W * N, N};
}

}  // namespace repro
