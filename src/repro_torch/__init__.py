"""PyTorch/CUDA port of the JAX package ``repro`` (fused, layout-aware CNN
inference after Li et al., "Optimizing Memory Efficiency for Deep
Convolutional Neural Networks on GPUs").

Module names follow the reference package, so ``repro_torch.X`` is the
counterpart of ``repro.X``.  The port imports neither ``jax`` nor anything
of ``repro``.  Its kernels are hand-written CUDA for Hopper
(``repro_torch.kernels``), built with ``nvcc`` at first use.
"""
