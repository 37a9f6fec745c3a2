// The max every pooling in the port takes (K1/K2/K5 pool epilogues, K3):
// NaN-propagating, as jnp.maximum and torch's max_pool2d are.  fmaxf would
// drop a NaN.  Start the running max at -INFINITY.
#pragma once

__device__ __forceinline__ float nan_max(float r, float v) {
  return (v > r || v != v) ? v : r;
}
