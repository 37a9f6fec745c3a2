#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--json OUT]

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   kernels from this checkout's CUDA sources with nvcc (sm_90a), timed.
2. Kernel phase: for every distinct launch of the served plans (conv K1/K2,
   conv->conv stack K5a/K5b, softmax K4), runs the kernel and its plain
   PyTorch version on the same inputs on the card, holds them together
   (conv and stack rtol 1e-4 / atol 1e-3, softmax atol 1e-6) and times the
   kernel, the plain version and one library chain for the same function
   (cuDNN conv [+ residual] + ReLU [+ pool], twice for a stack;
   torch.softmax) with CUDA events, launches back to back (for a launch
   of a few microseconds that reading is the host's time a launch).
   K4's and K8's lines add the same reading taken again in turns with
   their plain version and library call, the median of 5 rounds
   (``median5``), each one's device time a launch (100 launches captured
   in a CUDA graph and replayed: no host between the kernels) and K4's
   the host microseconds of each step of its wrapper (the shared
   ``_build`` helpers as every wrapper runs them) beside
   ``torch.softmax``'s.  K1
   and K2 (3xTF32 on the tensor cores) are also held against a float64
   run of their plain version, within 1e-5 scale-relative, on every case
   (forward, save_act, dgrad, Table 1); their lines add that error, the
   bound of their own design
   (three TF32 products per fp32 one) and their block tile with the FLOPs
   it executes over the direct ones (K1 where it pools, ``conv_tiling``;
   K2 always, ``nchw_tiling``, and K2 runs once more counting the FLOPs
   its blocks execute, which must equal the tiling's).  K5a runs once
   more counting the FLOPs its blocks execute and the cluster they ran in,
   which must equal
   ``stack_tiling``'s; the line shows the cluster, executed/direct FLOPs,
   the executed TFLOP/s and how many clusters the card holds at once.  K5b
   (3xTF32 on the tensor cores) runs once more counting the FLOPs its
   blocks execute, which must equal ``stack_tiling``'s, and that output is
   held within 1e-5 scale-relative of a float64 run of its plain version;
   its line adds the counted FLOPs, that error, the executed TFLOP/s,
   executed/direct, its tile and the bound of its own design.
   Then the paper's Fig. 13, off the main path: its twelve (N, C)
   softmax shapes (``SOFTMAX_LAYERS``) through K4, the five-step
   baseline and ``torch.softmax``, each held against the plain version
   (atol 1e-6) with device and back-to-back times and the modeled bytes,
   one ``fig13`` line a shape; and K4 and K8 on one shape for each of
   their variants (``SOFTMAX_VARIANTS``: narrow, wide and loop, 16-byte
   and scalar access, a misaligned view), with a NaN row and an all -inf
   row, held against their plain versions (atol 1e-6; rtol/atol 1e-5).
3. Serving phase, the main path, each path with the launch counts zeroed
   just before it and read just after, through ``CNNServer(reduced=False)``
   at full width:
     stack="off" (the reference's second rung): 40 seeded VGG16 requests at
       max_bucket 32 (one batch at bucket 32, one at 8), 128 AlexNet
       requests at max_bucket 128;
     stack="auto" (its top rung, conv->conv stacks): the same VGG16 and
       AlexNet traffic, and 40 ResNet-18 requests at max_bucket 32.
   Every answer is held against the torch engine on the card (max abs
   1e-5), and each kernel's launch count must equal what the plans call
   for.  Afterwards each batch's whole forward is timed warm (CUDA events)
   through the kernels and through the torch engine.
4. Planner phase, the main path's planned part: the paper's Fig. 4 on the
   card (K1 and K2 timed by the card measure with CUDA events over its
   whole grid: Ci 1-512 at N 64, then N 16-512 at Ci 256; Co 384, 13 x 13,
   F 3), each point's K1 and K2 ms printed beside the H100 model's pick and
   held once against ``conv_ref``, and the (Ct, Nt) ``calibrate`` takes
   from those timings. Then lenet (133 requests at max_bucket 128: buckets
   128 and 8), cifarnet (128 at 128), zfnet at 224 (64 at 64) and unet_mini
   (8 at 8, 32 x 32), served through ``CNNServer`` from an empty cache, so
   every bucket is a miss the planner plans on the H100 profile; counts
   zeroed just before each run and read just after must equal the plans',
   ``planner_calls`` the distinct buckets, and the answers be within 1e-5
   of the torch engine. Then, for each served (network, bucket) and VGG16
   b32 and AlexNet b128, the H100 model's ``total_s`` for stack "auto" and
   "off" beside the warm forward ms of each plan on the kernels (both held
   against the torch engine), and whether the model orders them as the card
   does. The kernel phase holds every distinct launch of the served plans.
5. Stacked against unstacked: for VGG16 and ResNet-18 at bucket 32, the
   warm whole forward at stack "auto", at "off" and through the torch
   engine, and the peak device memory of one forward at "auto" and "off"
   (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``).
6. Unfused phase, the paper's own experiment (Fig. 14/15) and the main
   path's third part: AlexNet (227 px, batch 128) and VGG16 (224 px,
   batch 32) at full width, seed-0 weights, each in the modes
   "cuda-convnet" (every layer CHWN), "cudnn" (every layer NCHW) and "opt"
   (the port's planner's per-layer layouts on the H100 profile; the
   packaged TPU-priced assignment is timed beside it once, not counted),
   through ``plan_network``
   and ``forward(impl="cuda")``: bare convs on K1/K2, standalone pools on
   K3a/K3b, re-layouts on the tiled transpose K9a, the softmax on K4.  Each forward runs with the launch counts zeroed
   just before it; the counts must equal what the layouts call for, the
   probabilities must be within 1e-5 of the torch engine's and the
   ``RunStats`` equal to its.  Then each forward is timed warm beside the
   torch engine's.  The kernel phase also holds every distinct K3a, K3b
   and K9a launch of this path (max pool and transpose exactly, avg pool
   atol 1e-6; the library call is ``max_pool2d`` on the same data in NCHW
   and ``permute(...).contiguous()``), and one K9b case off the path
   (NCHW -> NHWC of VGG16 conv1_1's output), which is listed with 0
   launches and its per-launch times.
7. Training phase, the main path's fourth part, outside inference mode:
   VGG16 b32, AlexNet b128 and ResNet-18 b32 at full width, seed-0
   weights, seeded input and labels, the packaged stack="auto" plan, 3
   SGD-with-momentum steps of ``make_train_step_fused`` on the kernels
   (forward K1/K2 with ``save_act`` where they pool, K5, K4; backward K7a/
   K7b, dgrad on K1/K2, the weight gradient K6, the stack recompute on
   K1/K2, K9a for a residual's gradient in another layout) and the same 3
   steps on the torch engine and on it in float64.  Each step runs with
   the launch counts zeroed just before it; they must equal
   ``train_launches`` (worked out from the plan).  Every loss finite, and
   within 1e-4 of the torch engine's loss at the same parameters; the
   step-1 gradient of every parameter, against the torch engine's and a
   float64 run of it, within 1e-4 scale-relative on 99.9 % of its
   elements and within 1e-3 on all (``_step1_gradients`` says why); then
   one warm step of each engine is timed and the peak device memory of a
   step read.  The kernel phase also holds every distinct training launch:
   K6 against its plain version in float64 (1e-5 scale-relative, and two
   launches bitwise equal; library ``conv2d_weight``; its line adds the
   executed TFLOP/s and the bound of its own design, three TF32 products
   per fp32 one on the tensor cores, beside the fp32 one), K7 (max
   exactly, avg atol 1e-6; library the autograd backward of
   ``max_pool2d``/``avg_pool2d`` times the ReLU mask; K7a's and K7b's
   lines add the share of their byte bound reached), dgrad on K1/K2
   (library ``conv2d_input``, also within the conv tolerance of it) and
   K1/K2 with ``save_act``; and one K8 case off the path (VGG16's [32, 1000];
   library ``cross_entropy``; also held with labels outside [0, C), which
   give the bare logsumexp), listed with 0 launches.
8. Conv-layer phase, the paper's Fig. 3 / Table 1 comparison and the
   path of the tiled matmul K10: the 12 Table-1 layers
   (``configs/paper_table1.py``) at their published N, HW, F, Ci, Co and
   S, seeded fp32 data, each through the matrix-expansion baseline
   ``conv_im2col_nchw`` (a materialized patch matrix, its matmul one K10
   launch), K2, K1 on the CHWN copy and the FFT conv
   ``conv_forward(impl="fft")``; counts zeroed before and read after (12
   each of K10, K2, K1); each engine held against ``conv_ref`` (FFT at
   rtol 1e-3 / atol 1e-2), timed beside cuDNN, with the baseline's peak
   device memory.  K10 (3xTF32 on the tensor cores) is also held within
   1e-5 scale-relative of the float64 product on every layer; its line
   adds that error, its TFLOP/s, the bound of its own design and its tile
   and split of K (``matmul_tiling``).  The K1/K2 launches of this phase
   join their kernels' rows.
9. LM kernel phase, the path of K11 and K12, every width from
   ``get_config``: K11 on qwen2-7b's attention (one 4096-token sequence,
   28 heads of 128, its 4 KV heads repeated, causal) in fp32 and bf16 and
   on whisper-base's encoder (8 clips of 1500 frames, 8 heads of 64);
   K12 on qwen2-7b's head (4096 tokens, D 3584, V 152064) in fp32 and
   bf16 and on gemma2-27b's (1024 tokens, D 4608, V 256000, softcap 30).
   Counts zeroed before and read after (one launch a case); each case
   held against its plain version (fp32 rtol / atol 1e-4, bf16 atol 8 *
   BF16_EPS), K12 three runs bitwise equal and its largest error
   scale-relative to a float64 run reported, timed beside
   ``F.scaled_dot_product_attention`` or ``h @ tableᵀ`` +
   ``F.cross_entropy``; a line gives K11's largest bf16 error and every
   case's TFLOP/s.
10. Prints "K1 over the main path", "K2 ...", "K5b ...", "K10 ..." and
   "K12 ..." lines in the form of K6's (launches, ms, TFLOP/s, K2's and
   K5b's executed TFLOP/s and executed/direct, both bounds, library ms, the
   largest error from float64), then one JSON line of every kernel
   (launches, error, times, bound, and the 3xTF32 bound of the tensor-core
   kernels),
   the card line, and ``{"ok": true, "device": {...}}`` last.

TF32 is off throughout.  Any failure raises: the script then exits
nonzero without the last line.  ``--json`` also writes every measured
case, and the compiler's register/spill report, to OUT.
"""
from __future__ import annotations

import argparse
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as nnf

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch import kernels as K  # noqa: E402
from repro_torch.cnn.layers import conv_forward  # noqa: E402
from repro_torch.cnn.layers import layer_shapes, resolved_cfg_inputs  # noqa: E402
from repro_torch.cnn.layers import init_cnn, params_from_numpy  # noqa: E402
from repro_torch.cnn.network import (forward, forward_fused,  # noqa: E402
                                     init_velocity, input_shape,
                                     loss_fn_fused, make_train_step_fused,
                                     plan_network, plan_network_fused,
                                     value_and_grad)
from repro_torch.configs import TRAIN_4K, get_config  # noqa: E402
from repro_torch.configs.cnn_networks import CNN_CONFIGS  # noqa: E402
from repro_torch.configs.paper_table1 import (CONV_LAYERS,  # noqa: E402
                                              SOFTMAX_LAYERS, ConvLayer)
from repro_torch.core.layout import perm_between, plan_transform  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv.backward import (conv_wgrad,  # noqa: E402
                                               dgrad_problem)
from repro_torch.kernels.conv.ops import (_conv, conv_direct_chwn,  # noqa: E402
                                          conv_im2col_nchw,
                                          conv_im2col_nchw_fused,
                                          conv_im2col_nchw_fused_counted,
                                          conv_stack_chwn,
                                          conv_stack_chwn_counted,
                                          conv_stack_nchw,
                                          conv_stack_nchw_counted,
                                          conv_tiling, nchw_tiling,
                                          stack_max_clusters, stack_tiling)
from repro_torch.kernels.conv.ref import (conv_ref,  # noqa: E402
                                          conv_stack_ref, im2col_nchw,
                                          wgrad_ref)
from repro_torch.kernels.crossentropy.ops import fused_xent  # noqa: E402
from repro_torch.kernels.crossentropy.ref import xent_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.matmul.ops import (matmul,  # noqa: E402
                                            matmul_tiling)
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.pool.backward import (  # noqa: E402
    pool_backward_chwn, pool_backward_nchw)
from repro_torch.kernels.pool.ops import pool_chwn, pool_nchw  # noqa: E402
from repro_torch.kernels.pool.ref import (pool_backward_ref,  # noqa: E402
                                          pool_ref)
from repro_torch.kernels.softmax.ops import softmax, softmax_xent  # noqa: E402
from repro_torch.kernels.softmax.ref import (softmax_5step_ref,  # noqa: E402
                                             softmax_ref, softmax_xent_ref)
from repro_torch.kernels.transpose.ops import (transpose2d,  # noqa: E402
                                               transpose2d_batched)
from repro_torch.kernels.transpose.ref import (  # noqa: E402
    transpose2d_batched_ref, transpose2d_ref)
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest  # noqa: E402
from repro_torch.perfmodel import (calibrate,  # noqa: E402
                                   card_conv_measure, hardware_id,
                                   select_conv_layout_cost)
from repro_torch.perfmodel.calibration import C_SWEEP, N_SWEEP  # noqa: E402
from repro_torch.serve.plan_cache import (PlanCache,  # noqa: E402
                                          bucket_for, packaged_plans,
                                          pad_to_bucket)
from repro_torch.shapes import conv_out_hw, pool_out_hw  # noqa: E402

# NVIDIA H100 SXM data sheet (dense, at the full 700 W power limit)
PEAK_FP32_FLOPS = 67e12          # CUDA cores, fp32
PEAK_HBM_BYTES = 3.35e12         # HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12         # tensor cores, bf16
PEAK_TF32_FLOPS = 495e12         # tensor cores, TF32

CONV_RTOL, CONV_ATOL = 1e-4, 1e-3
SOFTMAX_ATOL = 1e-6
AVG_POOL_ATOL = 1e-6             # max pool and transposes: exact
PROBS_ATOL = 1e-5
LOSS_ATOL = 1e-4                 # train-step losses against the torch engine
GRAD_TOL = 1e-4                  # step-1 gradients, scale-relative ...
GRAD_OUTLIERS = 1e-3             # ... for all but this fraction of each
GRAD_OUTLIER_TOL = 1e-3          # parameter's elements, and all within this
WGRAD_TOL = 1e-5                 # K6 against float64, scale-relative
TC_FP32_TOL = 1e-5               # K1 (3xTF32) against float64, the same
FFT_RTOL, FFT_ATOL = 1e-3, 1e-2  # the FFT conv (the reference's own)
LM_TOL = 1e-4                    # K11, K12 fp32 (rtol and atol)
BF16_ATOL = 8 * 2.0 ** -8        # K11, K12 bf16: 8 * BF16_EPS

# the main path: (network, max_bucket, requests, stack policy)
SERVED = [("vgg16", 32, 40, "off"), ("alexnet", 128, 128, "off"),
          ("vgg16", 32, 40, "auto"), ("alexnet", 128, 128, "auto"),
          ("resnet18", 32, 40, "auto")]
# stacked against unstacked: (network, bucket)
COMPARED = [("vgg16", 32), ("resnet18", 32)]
# the unfused executor: (network, batch), each in every mode
UNFUSED = [("alexnet", 128), ("vgg16", 32)]
MODES = ("cuda-convnet", "cudnn", "opt")
# the planner phase: networks no packaged file plans, served from an empty
# cache (every bucket a miss planned on the H100 profile), at full width:
# (network, max_bucket, requests)
PLANNED = [("lenet", 128, 133), ("cifarnet", 128, 128), ("zfnet", 64, 64),
           ("unet_mini", 8, 8)]
# the H100 model's stack "auto" against "off", beside the card, at these
# (network, bucket) too
MODEL_VS_CARD = [("vgg16", 32), ("alexnet", 128)]
# the training phase: (network, batch), TRAIN_STEPS SGD steps each on the
# packaged stack="auto" plan
TRAINED = [("vgg16", 32), ("alexnet", 128), ("resnet18", 32)]
TRAIN_STEPS = 3
# the one K9b case, off the main path: NCHW -> NHWC of VGG16 conv1_1's
# output [32, 64, 224, 224], collapsed to [N, C, H*W]
K9B_CASE = (32, 64, 224 * 224)
# the one K8 case, off the main path: VGG16's classifier at batch 32
K8_CASE = (32, 1000)
# one (rows, cols, base offset in floats) for each variant of K4 and K8
# (``softmax.cu``'s launch()): narrow with scalar access, G = 4, 8, 16
# lanes, then 32 lanes with STEPS 1-32; narrow with 16-byte access (cols
# % 4 == 0), G = 4, 8, 16, then STEPS 1-8; wide, blocks of 128-1024
# threads, each access; loop, each access; a batch of several rows a
# block; a view 4 bytes past a 16-byte boundary
SOFTMAX_VARIANTS = (
    [(7, c, 0) for c in (3, 7, 10, 31, 63, 101, 255, 501, 1001)]
    + [(7, c, 0) for c in (12, 32, 64, 100, 200, 400, 1000)]
    + [(7, c, 0) for c in (1501, 1500, 4001, 4000, 5001, 5000, 10001,
                           10000, 20001, 20000)]
    + [(300, 1000, 0), (5, 1000, 1)])
# the LM kernel phase: whisper-base's encoder attention over a batch of 8
# clips; gemma2-27b's head over a quarter of one train_4k sequence (its
# plain version materializes [T, 256000] fp32 logits: 1 GB at T 1024)
WHISPER_CLIPS = 8
GEMMA_TOKENS = TRAIN_4K.seq_len // 4

KERNELS = {
    "conv_chwn": {"route": "cuda",
                  "source": "src/repro_torch/kernels/conv/csrc/conv_chwn.cu",
                  "replaces": "src/repro/kernels/conv/conv.py:144"},
    "conv_nchw": {"route": "cuda",
                  "source": "src/repro_torch/kernels/conv/csrc/conv_nchw.cu",
                  "replaces": "src/repro/kernels/conv/im2col_mm.py:97"},
    "softmax": {"route": "cuda",
                "source": "src/repro_torch/kernels/softmax/csrc/softmax.cu",
                "replaces": "src/repro/kernels/softmax/softmax.py:27"},
    "conv_stack_chwn": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/conv/csrc/conv_stack_chwn.cu",
        "replaces": "src/repro/kernels/conv/stack.py:192"},
    "conv_stack_nchw": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/conv/csrc/conv_stack_nchw.cu",
        "replaces": "src/repro/kernels/conv/stack.py:292"},
    "pool_chwn": {"route": "cuda",
                  "source": "src/repro_torch/kernels/pool/csrc/pool.cu",
                  "replaces": "src/repro/kernels/pool/pool.py:40"},
    "pool_nchw": {"route": "cuda",
                  "source": "src/repro_torch/kernels/pool/csrc/pool.cu",
                  "replaces": "src/repro/kernels/pool/pool.py:82"},
    "transpose2d": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/transpose/csrc/transpose.cu",
        "replaces": "src/repro/kernels/transpose/transpose.py:25"},
    "transpose2d_batched": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/transpose/csrc/transpose.cu",
        "replaces": "src/repro/kernels/transpose/transpose.py:43"},
    "wgrad": {"route": "cuda",
              "source": "src/repro_torch/kernels/conv/csrc/wgrad.cu",
              "replaces": "src/repro/kernels/conv/backward.py:149"},
    "pool_backward_chwn": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/pool/csrc/pool_backward.cu",
        "replaces": "src/repro/kernels/pool/backward.py:123"},
    "pool_backward_nchw": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/pool/csrc/pool_backward.cu",
        "replaces": "src/repro/kernels/pool/backward.py:146"},
    "softmax_xent": {"route": "cuda",
                     "source": "src/repro_torch/kernels/softmax/csrc/"
                               "softmax.cu",
                     "replaces": "src/repro/kernels/softmax/softmax.py:53"},
    "matmul": {"route": "cuda",
               "source": "src/repro_torch/kernels/matmul/csrc/matmul.cu",
               "replaces": "src/repro/kernels/matmul/matmul.py:30"},
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:62"},
    "fused_xent": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/crossentropy/csrc/crossentropy.cu",
        "replaces": "src/repro/kernels/crossentropy/crossentropy.py:59"},
}
# kernels held in the kernel phase that no path of this script launches,
# with their one case
OFF_PATH = {"transpose2d_batched": K9B_CASE, "softmax_xent": K8_CASE}
STACK_KERNELS = {"conv_stack_chwn": ("CHWN", conv_stack_chwn),
                 "conv_stack_nchw": ("NCHW", conv_stack_nchw)}
POOL_KERNELS = {"pool_chwn": ("CHWN", pool_chwn),
                "pool_nchw": ("NCHW", pool_nchw)}
TRANSPOSE_KERNELS = {"transpose2d": (transpose2d, transpose2d_ref),
                     "transpose2d_batched": (transpose2d_batched,
                                             transpose2d_batched_ref)}
POOL_BWD_KERNELS = {"pool_backward_chwn": ("CHWN", pool_backward_chwn),
                    "pool_backward_nchw": ("NCHW", pool_backward_nchw)}
_LABEL = {"conv_chwn": "K1", "conv_nchw": "K2"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def batch_sizes(n_requests: int, cap: int):
    """The admitted batch sizes of a FIFO server draining ``n_requests``."""
    sizes, left = [], n_requests
    while left:
        sizes.append(min(cap, left))
        left -= sizes[-1]
    return sizes


def cuda_ms(fn, min_reps: int = 3, max_reps: int = 50,
            budget_s: float = 0.25) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around a run of
    launches after one warm-up, the run sized to about ``budget_s``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    probe = time.perf_counter() - t0
    reps = max(min_reps, min(max_reps, int(budget_s / max(probe, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """(least time in ms, what sets it) on the card's published peaks: the
    operations at ``peak`` (fp32 on the CUDA cores, or bf16 on the tensor
    cores for bf16 inputs) and the bytes at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# -- the launches the served plans make ------------------------------------

def plan_launches(network: str, bucket: int, stack: str):
    """(kernel, case) for every kernel launch of the packaged ``stack``
    plan of ``network`` at ``bucket``, in plan order."""
    cfg = CNN_CONFIGS[network].replace(batch=bucket)
    plan = PlanCache(str(packaged_plans(network))).peek_fused(
        cfg, bucket, stack=stack)
    if plan is None:
        raise LookupError(f"no packaged {network} plan at bucket {bucket} "
                          f"(stack={stack})")
    return fused_launches(cfg, plan)


def fused_launches(cfg, plan):
    """(kernel, case) for every kernel launch of ``forward_fused`` running
    ``plan`` on ``cfg`` (at the plan's batch), in plan order: a conv op is
    one K1/K2 launch (a stack op one K5a/K5b), a pool op one K3a/K3b, a
    re-layout no kernel absorbed (before a pool, at a merge) one K9a on the
    collapsed 2-D matrix, the softmax one K4.  A conv case carries its
    folded residual's layout (None without one)."""
    bucket = cfg.batch
    shapes, rins = layer_shapes(cfg), resolved_cfg_inputs(cfg)
    held = {-1: "NCHW"}
    prev, out = -1, []

    def shape_of(p):
        return input_shape(cfg) if p < 0 else shapes[p]

    def relayout(p, cur, lay):
        if cur != lay:
            stored = tuple(shape_of(p)["NCHW".index(d)] for d in cur)
            out.append(("transpose2d",
                        plan_transform(cur, lay).collapsed_shape(stored)))

    for op in plan.ops:
        p = op.inputs[0] if op.inputs else prev
        cur = held[p]
        if op.kind == "conv":
            spec = cfg.layers[op.index]
            _, ci, h, _ = shape_of(rins[op.index][0])
            pool = None
            if op.pool_index is not None:
                ps = cfg.layers[op.pool_index]
                pool = (ps.kernel, ps.stride, ps.pool_op)
            res = op.res_layout if op.res_index is not None else None
            if op.stack_index is not None:
                spec2 = cfg.layers[op.stack_index]
                kern = ("conv_stack_chwn" if op.layout == "CHWN"
                        else "conv_stack_nchw")
                out.append((kern, (bucket, ci, h, spec.out_channels,
                                   spec2.out_channels, spec.kernel,
                                   spec.stride, spec.pad, spec2.kernel,
                                   spec2.stride, spec2.pad, pool,
                                   op.stack_relu, op.relu, res,
                                   op.src_layout, op.dst_layout)))
            else:
                kern = "conv_chwn" if op.layout == "CHWN" else "conv_nchw"
                out.append((kern, (bucket, ci, h, spec.out_channels,
                                   spec.kernel, spec.stride, spec.pad, pool,
                                   op.relu, res, op.src_layout,
                                   op.dst_layout)))
            cur = op.dst_layout
        elif op.kind == "pool":
            spec = cfg.layers[op.index]
            relayout(p, cur, op.layout)
            kern = "pool_chwn" if op.layout == "CHWN" else "pool_nchw"
            out.append((kern, (tuple(shape_of(p)), spec.kernel, spec.stride,
                               spec.pool_op)))
            cur = op.dst_layout
        elif op.kind in ("add", "concat", "upsample"):
            for q in (op.inputs or (p,)):
                relayout(q, held[q], op.layout)
            cur = op.layout
        elif op.kind == "softmax":
            out.append(("softmax", (bucket, cfg.num_classes)))
        prev = op.out_index if op.out_index >= 0 else op.index
        held[prev] = cur
    return out


def unfused_launches(network: str, batch: int, mode: str):
    """(layouts, [(kernel, case)]) of the unfused ``forward`` of
    ``network`` at ``batch`` in ``mode``, in layer order: what the layouts
    call for, worked out from the config alone.  A re-layout (before a
    conv or pool whose layout differs from its input's, never after
    flatten) is one K9a launch on the collapsed 2-D matrix."""
    cfg = CNN_CONFIGS[network].replace(batch=batch)
    layouts = plan_network(cfg, mode)
    shapes, rins = layer_shapes(cfg), resolved_cfg_inputs(cfg)
    held = {-1: "NCHW"}
    flat, out = False, []
    for i, (spec, lay) in enumerate(zip(cfg.layers, layouts)):
        p = rins[i][0]
        cur, shp = held[p], (input_shape(cfg) if p < 0 else shapes[p])
        if spec.kind in ("add", "concat", "upsample"):
            raise ValueError(f"{network}: no merge layers on this path")
        if spec.kind in ("conv", "pool") and lay != cur and not flat:
            tp = plan_transform(cur, lay)
            if not tp.is_2d_transpose:
                raise ValueError(f"{network}: {cur}->{lay} is not 2-D")
            stored = tuple(shp["NCHW".index(d)] for d in cur)
            out.append(("transpose2d", tp.collapsed_shape(stored)))
            cur = lay
        if spec.kind == "conv":
            kern = "conv_chwn" if cur == "CHWN" else "conv_nchw"
            out.append((kern, (batch, shp[1], shp[2], spec.out_channels,
                               spec.kernel, spec.stride, spec.pad, None,
                               False, None, cur, cur)))
        elif spec.kind == "pool":
            kern = "pool_chwn" if cur == "CHWN" else "pool_nchw"
            out.append((kern, (tuple(shp), spec.kernel, spec.stride,
                               spec.pool_op)))
        elif spec.kind == "softmax":
            out.append(("softmax", (batch, cfg.num_classes)))
        elif spec.kind == "flatten":
            flat = True
        held[i] = cur
    return layouts, out


def _engine_kernel(layout: str) -> str:
    return "conv_chwn" if layout == "CHWN" else "conv_nchw"


def _conv_backward_launches(N, ci, h, co, F, S, pad, engine, pool, relu,
                            res_layout, src, dst, needs_dx, save_act):
    """(kernel, case) of one fused conv's training launches, its forward
    included: the forward (with ``save_act`` where it pools), K7 through
    the pool, dgrad on the engine's kernel unless the input needs no
    gradient, K6, and the K9a re-layout of a folded residual's gradient."""
    out = []
    ho = conv_out_hw(h, F, S, pad)
    conv = (N, ci, h, co, F, S, pad, pool, relu, res_layout, src, dst)
    if save_act:
        out.append((_engine_kernel(engine), ("save_act",) + conv))
    if pool is not None:
        kern = ("pool_backward_chwn" if engine == "CHWN"
                else "pool_backward_nchw")
        out.append((kern, (N, co, ho, pool[0], pool[1], pool[2], dst,
                           relu)))
        g_lay = engine
    else:
        g_lay = dst
    if needs_dx:
        out.append((_engine_kernel(engine), ("dgrad", N, ci, h, co, F, S,
                                             pad, g_lay, src)))
    out.append(("wgrad", (N, ci, h, co, F, S, pad, src, g_lay)))
    if res_layout and res_layout != g_lay:
        tp = plan_transform(g_lay, res_layout)
        stored = tuple({"N": N, "C": co, "H": ho, "W": ho}[d] for d in g_lay)
        out.append(("transpose2d", tp.collapsed_shape(stored)))
    return out


def train_launches(network: str, batch: int):
    """(kernel, case) for every kernel launch of one training step
    (``make_train_step_fused``, impl="cuda") over the packaged
    stack="auto" plan of ``network`` at ``batch``: what the plan calls for,
    worked out from it alone.  A conv op launches its forward (with
    ``save_act`` where it pools), then in the backward K7 where it pools,
    dgrad on its engine's kernel (not for the network input, which needs no
    gradient), K6, and a K9a re-layout where a folded residual's layout
    differs from the gradient's.  A stack op launches K5, then recomputes
    conv1 (and conv2 with ``save_act`` where it pools) and runs both convs'
    backwards.  The softmax is K4 forward; its gradient is plain
    arithmetic."""
    cfg = CNN_CONFIGS[network].replace(batch=batch)
    plan = PlanCache(str(packaged_plans(network))).peek_fused(
        cfg, batch, stack="auto")
    shapes, rins = layer_shapes(cfg), resolved_cfg_inputs(cfg)
    out, prev_key = [], -1
    for op in plan.ops:
        needs_dx = (op.inputs[0] if op.inputs else prev_key) != -1
        prev_key = op.out_index if op.out_index >= 0 else op.index
        if op.kind in ("pool", "add", "concat", "upsample"):
            raise ValueError(f"{network}: a standalone {op.kind} op is not "
                             "on this path")
        if op.kind == "softmax":
            out.append(("softmax", (batch, cfg.num_classes)))
        if op.kind != "conv":
            continue
        spec = cfg.layers[op.index]
        p = rins[op.index][0]
        _, ci, h, _ = input_shape(cfg) if p < 0 else shapes[p]
        pool = None
        if op.pool_index is not None:
            ps = cfg.layers[op.pool_index]
            pool = (ps.kernel, ps.stride, ps.pool_op)
        res = op.res_layout if op.res_index is not None else None
        E = op.layout
        if op.stack_index is None:
            if pool is None:
                out.append((_engine_kernel(E), (
                    batch, ci, h, spec.out_channels, spec.kernel,
                    spec.stride, spec.pad, None, op.relu, res,
                    op.src_layout, op.dst_layout)))
            out += _conv_backward_launches(
                batch, ci, h, spec.out_channels, spec.kernel, spec.stride,
                spec.pad, E, pool, op.relu, res, op.src_layout,
                op.dst_layout, needs_dx, save_act=pool is not None)
            continue
        spec2 = cfg.layers[op.stack_index]
        cm = spec.out_channels
        h1 = conv_out_hw(h, spec.kernel, spec.stride, spec.pad)
        out.append((("conv_stack_chwn" if E == "CHWN" else "conv_stack_nchw"),
                    (batch, ci, h, cm, spec2.out_channels, spec.kernel,
                     spec.stride, spec.pad, spec2.kernel, spec2.stride,
                     spec2.pad, pool, op.stack_relu, op.relu, res,
                     op.src_layout, op.dst_layout)))
        # the backward: recompute y1, then conv2's and conv1's backwards
        out.append((_engine_kernel(E), (batch, ci, h, cm, spec.kernel,
                                        spec.stride, spec.pad, None,
                                        op.stack_relu, None, op.src_layout,
                                        E)))
        out += _conv_backward_launches(
            batch, cm, h1, spec2.out_channels, spec2.kernel, spec2.stride,
            spec2.pad, E, pool, op.relu, res, E, op.dst_layout, True,
            save_act=pool is not None)
        out += _conv_backward_launches(
            batch, ci, h, cm, spec.kernel, spec.stride, spec.pad, E, None,
            op.stack_relu, None, op.src_layout, E, needs_dx, save_act=False)
    return out


def _library_epilogue(y, r_nchw, relu: bool, pool):
    if r_nchw is not None:
        y = y + r_nchw
    if relu:
        y = torch.relu_(y)
    if pool is not None:
        y = (nnf.max_pool2d(y, pool[0], pool[1]) if pool[2] == "max"
             else nnf.avg_pool2d(y, pool[0], pool[1]))
    return y


def _measure(kernel, plain, library, flops: float, nbytes: float,
             rtol: float = CONV_RTOL, atol: float = CONV_ATOL,
             peak: float = PEAK_FP32_FLOPS, got=None) -> dict:
    """Hold ``kernel()`` (or ``got``, its output from the main path)
    against ``plain()``, then time the kernel, the plain version and the
    library call; the bound is on ``peak``."""
    got = kernel() if got is None else got
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    del got, want
    b_ms, b_by = bound_ms(flops, nbytes, peak)
    return {"max_abs_err": err, "max_rel_err": rel, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes, "peak_flops": peak}


def conv_case(kern: str, case, dev, seed: int) -> dict:
    N, Ci, H, Co, F, S, pad, pool, relu, rlay, src, dst = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    Ho = conv_out_hw(H, F, S, pad)
    x_nchw = torch.randn(N, Ci, H, H, device=dev, generator=gen)
    w = torch.randn(Co, Ci, F, F, device=dev, generator=gen) \
        / math.sqrt(Ci * F * F)
    r_nchw = (torch.randn(N, Co, Ho, Ho, device=dev, generator=gen)
              if rlay else None)
    x = x_nchw.permute(perm_between("NCHW", src)).contiguous()
    r = (r_nchw.permute(perm_between("NCHW", rlay)).contiguous()
         if rlay else None)
    engine = "CHWN" if kern == "conv_chwn" else "NCHW"
    kw = dict(relu=relu, pool=pool, res=r, res_layout=rlay or engine,
              src_layout=src, dst_layout=dst)
    if kern == "conv_chwn":
        wk = w.permute(1, 2, 3, 0).contiguous()

        def kernel():
            return conv_direct_chwn(x, wk, S, pad, **kw)
    else:
        def kernel():
            return conv_im2col_nchw_fused(x, w, S, pad, **kw)

    def plain():
        return conv_ref(x, w, S, pad, **kw)

    def library():
        return _library_epilogue(nnf.conv2d(x_nchw, w, stride=S, padding=pad),
                                 r_nchw, relu, pool)

    flops = 2.0 * N * Co * Ho * Ho * Ci * F * F
    out_hw = Ho if pool is None else (Ho - pool[0]) // pool[1] + 1
    nbytes = 4.0 * (x.numel() + w.numel() + N * Co * out_hw * out_hw
                    + (r.numel() if rlay else 0))
    m = _measure(kernel, plain, library, flops, nbytes)
    want64 = conv_ref(x.double(), w.double(), S, pad,
                      **{**kw, "res": r.double() if rlay else None})
    if kern == "conv_chwn":
        _fp32_gate(m, [(kernel(), want64)], f"K1 {case}")
        _k1_tile(m, case, N, Ci, H, Co, F, S, pad, pool)
    else:
        y = _k2_tile(m, case, x, w, S, pad, kw)
        _fp32_gate(m, [(y, want64)], f"K2 {case}")
    return m


def stack_case(kern: str, case, dev, seed: int) -> dict:
    (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, relu2, rlay,
     src, dst) = case
    engine, wrapper = STACK_KERNELS[kern]
    gen = torch.Generator(device=dev).manual_seed(seed)
    Ho1 = conv_out_hw(H, F1, S1, P1)
    Ho2 = conv_out_hw(Ho1, F2, S2, P2)
    x_nchw = torch.randn(N, Ci, H, H, device=dev, generator=gen)
    w1 = torch.randn(Cm, Ci, F1, F1, device=dev, generator=gen) \
        / math.sqrt(Ci * F1 * F1)
    w2 = torch.randn(Co, Cm, F2, F2, device=dev, generator=gen) \
        / math.sqrt(Cm * F2 * F2)
    r_nchw = (torch.randn(N, Co, Ho2, Ho2, device=dev, generator=gen)
              if rlay else None)
    x = x_nchw.permute(perm_between("NCHW", src)).contiguous()
    r = (r_nchw.permute(perm_between("NCHW", rlay)).contiguous()
         if rlay else None)
    kw = dict(relu1=relu1, relu2=relu2, pool=pool, res=r,
              res_layout=rlay or engine, src_layout=src, dst_layout=dst)
    if engine == "CHWN":
        w1k = w1.permute(1, 2, 3, 0).contiguous()
        w2k = w2.permute(1, 2, 3, 0).contiguous()
    else:
        w1k, w2k = w1, w2

    def kernel():
        return wrapper(x, w1k, w2k, S1, P1, S2, P2, **kw)

    def plain():
        return conv_stack_ref(x, w1, w2, S1, P1, S2, P2, **kw)

    def library():
        y = nnf.conv2d(x_nchw, w1, stride=S1, padding=P1)
        if relu1:
            y = torch.relu_(y)
        return _library_epilogue(nnf.conv2d(y, w2, stride=S2, padding=P2),
                                 r_nchw, relu2, pool)

    flops = 2.0 * N * (Cm * Ho1 * Ho1 * Ci * F1 * F1
                       + Co * Ho2 * Ho2 * Cm * F2 * F2)
    out_hw = Ho2 if pool is None else (Ho2 - pool[0]) // pool[1] + 1
    nbytes = 4.0 * (x.numel() + w1.numel() + w2.numel()
                    + N * Co * out_hw * out_hw + (r.numel() if rlay else 0))
    m = _measure(kernel, plain, library, flops, nbytes)
    t = stack_tiling(engine, N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2, P2,
                     pool)
    m.update(executed_flops=float(t.executed_flops),
             smem_bytes=t.smem_bytes, blocks=t.blocks, cluster=t.cluster,
             tile={"bm": t.bm, "nb": t.nb, "uth": t.uth, "utw": t.utw})
    if engine == "NCHW":
        # K5b (3xTF32 on the tensor cores) against float64, and the FLOPs
        # its blocks count against the tiling's
        y, counted = conv_stack_nchw_counted(x, w1k, w2k, S1, P1, S2, P2,
                                             **kw)
        k64 = {**kw, "res": r.double() if rlay else None}
        _fp32_gate(m, [(y, conv_stack_ref(x.double(), w1.double(),
                                          w2.double(), S1, P1, S2, P2,
                                          **k64))], f"K5b {case}")
        if counted != t.executed_flops:
            raise AssertionError(
                f"K5b {case}: the kernel executed {counted} FLOPs; "
                f"stack_tiling says {t.executed_flops}")
        m.update(counted_flops=float(counted))
    if engine == "CHWN":
        # K5a counts what its blocks execute and the cluster they ran in
        y, counted, cluster = conv_stack_chwn_counted(
            x, w1k, w2k, S1, P1, S2, P2, **kw)
        torch.testing.assert_close(y, plain(), rtol=CONV_RTOL,
                                   atol=CONV_ATOL)
        if counted != t.executed_flops or cluster != t.cluster:
            raise AssertionError(
                f"K5a {case}: the kernel executed {counted} FLOPs in "
                f"clusters of {cluster}; stack_tiling says "
                f"{t.executed_flops} in clusters of {t.cluster}")
        m.update(counted_flops=float(counted), counted_cluster=cluster,
                 resident_clusters=stack_max_clusters(
                     N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2, P2, pool, t))
    return m


def host_us(fn, reps: int = 500) -> float:
    """Mean host time of ``fn()`` in microseconds over ``reps`` calls,
    started on an idle card (``reps`` launches stay well inside the
    launch queue, so the host never waits for the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def device_ms(fn, launches: int = 100, replays: int = 5) -> float:
    """Device time of one ``fn()`` in ms: ``launches`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, per
    call.  The card runs the graph's kernels back to back with no host in
    between: the kernels' own time plus the graph's gap between nodes
    (a capture also fails on any host-device sync in ``fn``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                    # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def b2b_ms(fns: dict, rounds: int = 5) -> dict:
    """``cuda_ms`` of each function of ``fns``, taken in turns over
    ``rounds`` rounds (the order reversed every other round), the median
    of each.  For a launch of a few microseconds that back-to-back reading
    is the host's time, which drifts on a shared host: turns and medians
    keep the drift out of a comparison."""
    got = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(cuda_ms(fns[k]))
    return {k: sorted(v)[len(v) // 2] for k, v in got.items()}


def softmax_host_steps(x) -> dict:
    """Host microseconds of each step of a K4 launch (``softmax/ops.py``,
    on the helpers of ``kernels/_build.py`` that every wrapper runs), each
    timed alone, beside the whole wrapper, ``torch.softmax``, a
    ``contiguous()`` of a contiguous tensor and the stream read through
    the public ``torch.cuda.current_stream``."""
    y = torch.empty_like(x)
    dev = _build.require_cuda_f32("softmax", x)
    xp, yp, (rows, cols) = x.data_ptr(), y.data_ptr(), x.shape
    st = _build.stream_of(dev)
    launch = _build.library().softmax_forward

    class Counter:
        launches = 0

    def count():
        Counter.launches += 1

    steps = {
        "grad_mode": lambda: x.requires_grad and torch.is_grad_enabled(),
        "dim": lambda: x.dim(),
        "on_cpu": lambda: _build.on_cpu("softmax", x),
        "require_cuda_f32": lambda: _build.require_cuda_f32("softmax", x),
        "shape": lambda: x.shape,
        "alloc": lambda: torch.empty_like(x),
        "data_ptr": lambda: (x.data_ptr(), y.data_ptr()),
        "library_lookup": lambda: _build.library().softmax_forward,
        "stream_of": lambda: _build.stream_of(dev),
        "ctypes_launch": lambda: launch(xp, yp, rows, cols, st),
        "check": lambda: _build.check("softmax", 0),
        "count": count,
        "wrapper": lambda: softmax(x),
        "torch_softmax": lambda: torch.softmax(x, dim=-1),
        "contiguous": lambda: x.contiguous(),
        "stream_object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
    }
    return {k: host_us(fn) for k, fn in steps.items()}


def softmax_case(case, dev, seed: int) -> dict:
    rows, cols = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, cols, device=dev, generator=gen) * 4

    def kernel():
        return softmax(x)

    def plain():
        return softmax_ref(x)

    def library():
        return torch.softmax(x, dim=-1)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=SOFTMAX_ATOL)
    # max, shift, exp, sum, normalize: ~5 operations per element
    flops, nbytes = 5.0 * rows * cols, 4.0 * 2 * rows * cols
    b_ms, b_by = bound_ms(flops, nbytes)
    return {"max_abs_err": err, "max_rel_err": err / want.abs().max().item(),
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library),
            "median5": b2b_ms({"ms": kernel, "plain_ms": plain,
                               "library_ms": library}),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes, "device_ms": device_ms(kernel),
            "plain_device_ms": device_ms(plain),
            "library_device_ms": device_ms(library),
            "host_us": softmax_host_steps(x)}


def pool_case(kern: str, case, dev, seed: int) -> dict:
    """K3a/K3b on its own layout (dst = src, the unfused path's use); the
    folded write (dst = the other layout) is checked and timed beside."""
    (N, C, H, W), F, S, op = case
    src, wrapper = POOL_KERNELS[kern]
    other = "NCHW" if src == "CHWN" else "CHWN"
    gen = torch.Generator(device=dev).manual_seed(seed)
    x_nchw = torch.randn(N, C, H, W, device=dev, generator=gen)
    x = x_nchw.permute(perm_between("NCHW", src)).contiguous()
    tol = (0.0, 0.0) if op == "max" else (0.0, AVG_POOL_ATOL)

    def kernel(dst=src):
        return wrapper(x, F, S, op, dst_layout=dst)

    def plain():
        return pool_ref(x, F, S, op, src, src)

    def library():
        return (nnf.max_pool2d(x_nchw, F, S) if op == "max"
                else nnf.avg_pool2d(x_nchw, F, S))

    Ho, Wo = (H - F) // S + 1, (W - F) // S + 1
    out = N * C * Ho * Wo
    m = _measure(kernel, plain, library, float(F * F * out),
                 4.0 * (x.numel() + out), *tol)
    folded = kernel(other)
    torch.testing.assert_close(folded, pool_ref(x, F, S, op, src, other),
                               rtol=tol[0], atol=tol[1])
    m["folded_ms"] = cuda_ms(lambda: kernel(other))
    return m


def transpose_case(kern: str, case, dev, seed: int) -> dict:
    wrapper, ref = TRANSPOSE_KERNELS[kern]
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*case, device=dev, generator=gen)
    perm = (1, 0) if len(case) == 2 else (0, 2, 1)
    return _measure(lambda: wrapper(x), lambda: ref(x),
                    lambda: x.permute(perm).contiguous(), 0.0,
                    8.0 * x.numel(), rtol=0.0, atol=0.0)


def _scaled_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in float64."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())
            ).item()


def _fp32_gate(m: dict, pairs, what) -> dict:
    """The accuracy gate of the 3xTF32 kernels (K1, K2, K5b, K10): each
    (kernel output, the same in float64) within ``TC_FP32_TOL`` scale-relative;
    adds the largest error and the design's own bound (3xTF32: three TF32
    products per fp32 one on the tensor cores) to ``m``."""
    err = max(_scaled_err(got, want64) for got, want64 in pairs)
    if err > TC_FP32_TOL:
        raise AssertionError(f"{what}: {err:.3g} from float64 (scale-"
                             f"relative) > {TC_FP32_TOL}")
    m.update(f64_err=err, design_bound_ms=bound_ms(
        3 * m["flops"], m["bytes"], PEAK_TF32_FLOPS)[0])
    return m


def _k1_tile(m: dict, case, N, Ci, H, Co, F, S, pad, pool) -> dict:
    """K1's block tile (``conv_tiling``) and the FLOPs it executes."""
    t = conv_tiling(N, Ci, H, H, Co, F, S, pad, pool)
    m.update(executed_flops=float(t.executed_flops),
             tile={"bm": t.bm, "nb": t.nb, "ph": t.ph, "pw": t.pw},
             blocks=t.blocks, smem_bytes=t.smem_bytes)
    return m


def _k2_tile(m: dict, case, x, w, S: int, pad: int, kw) -> torch.Tensor:
    """K2 once more, counting the FLOPs its blocks execute, which must
    equal its block tile's (``nchw_tiling``); adds the tile and those FLOPs
    to ``m`` and returns that launch's output."""
    N, Ci, H, W = (x.shape[kw.get("src_layout", "NCHW").index(d)]
                   for d in "NCHW")
    Co, _, F, _ = w.shape
    pool = kw.get("pool")
    t = nchw_tiling(N, Ci, H, W, Co, F, S, pad, tuple(pool) if pool else None)
    y, counted = conv_im2col_nchw_fused_counted(x, w, S, pad, **kw)
    if counted != t.executed_flops:
        raise AssertionError(f"K2 {case}: the kernel executed {counted} "
                             f"FLOPs; nchw_tiling says {t.executed_flops}")
    m.update(executed_flops=float(counted),
             tile={"bm": t.bm, "nb": t.nb, "uth": t.uth, "utw": t.utw,
                   "tr": t.tr},
             blocks=t.blocks, smem_bytes=t.smem_bytes)
    return y


def save_act_case(kern: str, case, dev, seed: int) -> dict:
    """K1/K2 with the ``save_act`` output (the training forward of a pooled
    conv): y and z held against ``conv_ref``'s; the library is the same
    cuDNN chain as the forward's."""
    N, Ci, H, Co, F, S, pad, pool, relu, rlay, src, dst = case[1:]
    engine = "CHWN" if kern == "conv_chwn" else "NCHW"
    gen = torch.Generator(device=dev).manual_seed(seed)
    Ho = conv_out_hw(H, F, S, pad)
    x_nchw = torch.randn(N, Ci, H, H, device=dev, generator=gen)
    w = torch.randn(Co, Ci, F, F, device=dev, generator=gen) \
        / math.sqrt(Ci * F * F)
    r_nchw = (torch.randn(N, Co, Ho, Ho, device=dev, generator=gen)
              if rlay else None)
    x = x_nchw.permute(perm_between("NCHW", src)).contiguous()
    r = (r_nchw.permute(perm_between("NCHW", rlay)).contiguous()
         if rlay else None)
    wk = w.permute(1, 2, 3, 0).contiguous() if engine == "CHWN" else w
    kw = dict(relu=relu, pool=pool, res=r, res_layout=rlay or engine,
              src_layout=src, dst_layout=dst)
    y, z = _conv(engine, x, wk, S, pad, save_act=True, **kw)
    y_ref, z_ref = conv_ref(x, w, S, pad, save_act=True, act_layout=engine,
                            **kw)
    torch.testing.assert_close(y, y_ref, rtol=CONV_RTOL, atol=CONV_ATOL)

    def library():
        return _library_epilogue(nnf.conv2d(x_nchw, w, stride=S, padding=pad),
                                 r_nchw, relu, pool)

    out_hw = pool_out_hw(Ho, pool[0], pool[1])
    m = _measure(
        lambda: _conv(engine, x, wk, S, pad, save_act=True, **kw)[1],
        lambda: conv_ref(x, w, S, pad, save_act=True, act_layout=engine,
                         **kw)[1], library,
        2.0 * N * Co * Ho * Ho * Ci * F * F,
        4.0 * (x.numel() + w.numel() + N * Co * (out_hw ** 2 + Ho * Ho)
               + (r.numel() if rlay else 0)))
    y64, z64 = conv_ref(x.double(), w.double(), S, pad, save_act=True,
                        act_layout=engine,
                        **{**kw, "res": r.double() if rlay else None})
    _fp32_gate(m, [(y, y64), (z, z64)], f"{_LABEL[kern]} {case}")
    if kern == "conv_chwn":
        _k1_tile(m, case, N, Ci, H, Co, F, S, pad, pool)
    else:
        _k2_tile(m, case, x, w, S, pad, kw)
    return m


def dgrad_case(kern: str, case, dev, seed: int) -> dict:
    """dgrad on K1/K2: the kernel on the dilated, rotated problem (the
    dilation built once, outside the timing), against ``conv_ref`` on the
    same problem and against ``torch.nn.grad.conv2d_input`` (both at the
    conv tolerance)."""
    N, Ci, H, Co, F, S, pad, g_lay, dst = case[1:]
    engine = "CHWN" if kern == "conv_chwn" else "NCHW"
    gen = torch.Generator(device=dev).manual_seed(seed)
    Ho = conv_out_hw(H, F, S, pad)
    g_nchw = torch.randn(N, Co, Ho, Ho, device=dev, generator=gen)
    w = torch.randn(Co, Ci, F, F, device=dev, generator=gen) \
        / math.sqrt(Ci * F * F)
    g = g_nchw.permute(perm_between("NCHW", g_lay)).contiguous()
    gd, wt, p = dgrad_problem(g, w, (H, H), S, pad, g_lay)
    wk = wt.permute(1, 2, 3, 0).contiguous() if engine == "CHWN" else wt

    def kernel():
        return _conv(engine, gd, wk, 1, p, src_layout=g_lay, dst_layout=dst)

    def library():
        return torch.nn.grad.conv2d_input((N, Ci, H, H), w, g_nchw,
                                          stride=S, padding=pad)

    m = _measure(kernel,
                 lambda: conv_ref(gd, wt, 1, p, src_layout=g_lay,
                                  dst_layout=dst), library,
                 2.0 * N * Co * Ho * Ho * Ci * F * F,
                 4.0 * (g.numel() + w.numel() + N * Ci * H * H))
    torch.testing.assert_close(kernel().permute(perm_between(dst, "NCHW")),
                               library(), rtol=CONV_RTOL, atol=CONV_ATOL)
    want64 = conv_ref(gd.double(), wt.double(), 1, p, src_layout=g_lay,
                      dst_layout=dst)
    if kern == "conv_chwn":
        _fp32_gate(m, [(kernel(), want64)], f"K1 {case}")
    else:
        y = _k2_tile(m, case, gd, wt, 1, p,
                     dict(src_layout=g_lay, dst_layout=dst))
        _fp32_gate(m, [(y, want64)], f"K2 {case}")
    return m


def wgrad_case(case, dev, seed: int) -> dict:
    """K6 against its plain version in float64 (the error reported is the
    kernel's own, scale-relative), timed beside the plain version in
    float32 and ``torch.nn.grad.conv2d_weight``."""
    N, Ci, H, Co, F, S, pad, x_lay, g_lay = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    Ho = conv_out_hw(H, F, S, pad)
    x_nchw = torch.randn(N, Ci, H, H, device=dev, generator=gen)
    g_nchw = torch.randn(N, Co, Ho, Ho, device=dev, generator=gen)
    x = x_nchw.permute(perm_between("NCHW", x_lay)).contiguous()
    g = g_nchw.permute(perm_between("NCHW", g_lay)).contiguous()
    kw = dict(x_layout=x_lay, g_layout=g_lay)

    def kernel():
        return conv_wgrad(x, g, F, S, pad, **kw)

    got = kernel()
    want = wgrad_ref(x, g, F, S, pad, dtype=torch.float64, **kw)
    abs_err = (got.double() - want).abs().max().item()
    err = _scaled_err(got, want)
    del want
    if err > WGRAD_TOL:
        raise AssertionError(f"K6 {case}: {err:.3g} from float64 (scale-"
                             f"relative) > {WGRAD_TOL}")
    if not torch.equal(got, kernel()):
        raise AssertionError(f"K6 {case}: two launches differ")
    flops = 2.0 * Co * Ci * F * F * N * Ho * Ho
    nbytes = 4.0 * (x.numel() + g.numel() + Co * Ci * F * F)
    b_ms, b_by = bound_ms(flops, nbytes)
    return {"max_abs_err": abs_err, "max_rel_err": err, "f64_err": err,
            # the design's own bound: 3xTF32 runs 3 TF32 products per term
            "design_bound_ms": bound_ms(3 * flops, nbytes,
                                        PEAK_TF32_FLOPS)[0],
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: wgrad_ref(x, g, F, S, pad, **kw)),
            "library_ms": cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw, (Co, Ci, F, F), g_nchw, stride=S, padding=pad)),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": 4.0 * (x.numel() + g.numel() + Co * Ci * F * F)}


def pool_bwd_case(kern: str, case, dev, seed: int) -> dict:
    """K7a/K7b on a seeded pre-pool activation z (half of it negative, so
    the ReLU mask matters) and gradient, against ``pool_backward_ref``:
    max exactly, avg within atol 1e-6.  The library is the autograd
    backward of ``max_pool2d``/``avg_pool2d`` in NCHW times the mask."""
    N, C, H, F, S, op, g_lay, relu = case
    layout, wrapper = POOL_BWD_KERNELS[kern]
    gen = torch.Generator(device=dev).manual_seed(seed)
    Ho = pool_out_hw(H, F, S)
    z_nchw = torch.randn(N, C, H, H, device=dev, generator=gen)
    g_nchw = torch.randn(N, C, Ho, Ho, device=dev, generator=gen)
    z = z_nchw.permute(perm_between("NCHW", layout)).contiguous()
    g = g_nchw.permute(perm_between("NCHW", g_lay)).contiguous()
    mask = (z_nchw > 0).float() if relu else None
    if op == "max":
        _, idx = nnf.max_pool2d(z_nchw, F, S, return_indices=True)

        def library():
            d = torch.ops.aten.max_pool2d_with_indices_backward(
                g_nchw, z_nchw, [F, F], [S, S], [0, 0], [1, 1], False, idx)
            return d * mask if relu else d
    else:
        def library():
            d = torch.ops.aten.avg_pool2d_backward(
                g_nchw, z_nchw, [F, F], [S, S], [0, 0], False, True, None)
            return d * mask if relu else d

    windows = (-(-F // S)) ** 2
    tol = (0.0, 0.0) if op == "max" else (0.0, AVG_POOL_ATOL)
    return _measure(
        lambda: wrapper(z, g, F, S, op, g_layout=g_lay, relu_mask=relu),
        lambda: pool_backward_ref(z, g, F, S, op, layout, g_lay, relu),
        library, float(N * C * H * H * windows * (F * F if op == "max"
                                                  else 1)),
        4.0 * (2 * z.numel() + g.numel()), *tol)


def xent_case(case, dev, seed: int) -> dict:
    """K8 against ``softmax_xent_ref`` (rtol/atol 1e-5), also with labels
    outside [0, C) (the bare logsumexp); the library is
    ``F.cross_entropy(reduction="none")``.  Device times from graph
    replays beside the back-to-back ones."""
    rows, cols = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, cols, device=dev, generator=gen) * 4
    labels = torch.randint(0, cols, (rows,), device=dev, generator=gen)
    outside = labels.clone()
    outside[::3], outside[1::3] = -1, cols
    got = softmax_xent(x, outside)
    torch.testing.assert_close(got, softmax_xent_ref(x, outside), rtol=1e-5,
                               atol=1e-5)
    bare = torch.logsumexp(x, dim=-1)
    torch.testing.assert_close(got[::3], bare[::3], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1::3], bare[1::3], rtol=1e-5, atol=1e-5)

    def kernel():
        return softmax_xent(x, labels)

    def plain():
        return softmax_xent_ref(x, labels)

    def library():
        return nnf.cross_entropy(x, labels, reduction="none")

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    flops, nbytes = 3.0 * rows * cols, 4.0 * rows * cols + 12.0 * rows
    b_ms, b_by = bound_ms(flops, nbytes)
    return {"max_abs_err": err, "max_rel_err": err / want.abs().max().item(),
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library),
            "median5": b2b_ms({"ms": kernel, "plain_ms": plain,
                               "library_ms": library}),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes, "device_ms": device_ms(kernel),
            "plain_device_ms": device_ms(plain),
            "library_device_ms": device_ms(library),
            "host_us": {"wrapper": host_us(kernel),
                        "cross_entropy": host_us(library)}}


def fig13_phase(dev) -> list:
    """Paper Fig. 13: the twelve (N, C) softmax shapes of
    ``SOFTMAX_LAYERS`` on standard normal logits (as the reference's
    ``benchmarks/softmax_bench.py`` draws them), each through K4, the
    paper's five-step baseline ``softmax_5step_ref`` and
    ``torch.softmax``: both held against the plain version (atol 1e-6),
    device times from graph replays and back-to-back times, and the modeled
    bytes (fused 2 x N·C·4, five-step 10 x N·C·4).  Off the main path: not
    in the kernels line."""
    out = []
    for i, l in enumerate(SOFTMAX_LAYERS):
        gen = torch.Generator(device=dev).manual_seed(1300 + i)
        x = torch.randn(l.N, l.C, device=dev, generator=gen)
        want = softmax_ref(x)
        got, five = softmax(x), softmax_5step_ref(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=SOFTMAX_ATOL)
        torch.testing.assert_close(five, want, rtol=0, atol=SOFTMAX_ATOL)
        fns = {"k4": lambda: softmax(x),
               "five_step": lambda: softmax_5step_ref(x),
               "torch": lambda: torch.softmax(x, dim=-1)}
        row = {"name": l.name, "N": l.N, "C": l.C,
               "max_abs_err": (got - want).abs().max().item(),
               "fused_bytes": 2 * l.N * l.C * 4,
               "five_step_bytes": 10 * l.N * l.C * 4}
        for k, fn in fns.items():
            row[f"{k}_device_ms"] = device_ms(fn)
        row.update({f"{k}_ms": v for k, v in b2b_ms(fns).items()})
        row["bound_ms"] = 1e3 * row["fused_bytes"] / PEAK_HBM_BYTES
        row["bound_share"] = row["bound_ms"] / row["k4_device_ms"]
        print(f"fig13 {l.name}: N={l.N} C={l.C} "
              f"max_abs_err={row['max_abs_err']:.3g} device_ms: "
              f"k4={row['k4_device_ms']:.5f} "
              f"five_step={row['five_step_device_ms']:.5f} "
              f"torch={row['torch_device_ms']:.5f}; back-to-back ms: "
              f"k4={row['k4_ms']:.5f} five_step={row['five_step_ms']:.5f} "
              f"torch={row['torch_ms']:.5f}; "
              f"MB fused={row['fused_bytes'] / 1e6:.3f} "
              f"five_step={row['five_step_bytes'] / 1e6:.3f}; "
              f"bound_ms={row['bound_ms']:.5f} "
              f"bound_share={row['bound_share']:.3f} "
              f"k4/torch={row['k4_device_ms'] / row['torch_device_ms']:.3f}",
              flush=True)
        out.append(row)
    return out


def softmax_variants(dev) -> dict:
    """K4 and K8 on one shape for each of their variants
    (``SOFTMAX_VARIANTS``), off the main path: K4 held against the plain
    version at atol 1e-6, K8 at rtol/atol 1e-5 with labels inside and
    outside [0, C).  Row 1 holds a NaN and row 2 is all -inf: both come
    out NaN, K8's row 2 with a label outside the row."""
    err4 = err8 = 0.0
    for i, (rows, cols, off) in enumerate(SOFTMAX_VARIANTS):
        gen = torch.Generator(device=dev).manual_seed(1400 + i)
        flat = torch.randn(rows * cols + off, device=dev, generator=gen) * 4
        x = flat[off:].view(rows, cols)
        x[1, cols // 2] = float("nan")
        x[2] = float("-inf")
        labels = torch.randint(-1, cols + 1, (rows,), device=dev,
                               generator=gen)
        labels[2] = cols
        y, want = softmax(x), softmax_ref(x)
        loss, want8 = softmax_xent(x, labels), softmax_xent_ref(x, labels)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, want, rtol=0, atol=SOFTMAX_ATOL,
                                   equal_nan=True)
        torch.testing.assert_close(loss, want8, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
        if not (torch.isnan(y[1:3]).all() and torch.isnan(loss[1:3]).all()):
            raise AssertionError(f"softmax {rows}x{cols}: a NaN or all -inf "
                                 "row did not come out NaN")
        fin = torch.ones(rows, dtype=torch.bool, device=dev)
        fin[1:3] = False
        err4 = max(err4, (y[fin] - want[fin]).abs().max().item())
        err8 = max(err8, (loss[fin] - want8[fin]).abs().max().item())
    print(f"softmax variants: {len(SOFTMAX_VARIANTS)} shapes "
          f"(rows, cols, offset) {SOFTMAX_VARIANTS} held: K4 "
          f"max_abs_err={err4:.3g} (atol {SOFTMAX_ATOL}), K8 "
          f"max_abs_err={err8:.3g} (rtol/atol 1e-5); NaN and all -inf rows "
          f"NaN", flush=True)
    return {"shapes": SOFTMAX_VARIANTS, "k4_max_abs_err": err4,
            "k8_max_abs_err": err8}


def kernel_phase(dev):
    """Measure every distinct launch of the main path once; returns the
    cases with their multiplicity (launches on the main path)."""
    mult, batches = {}, []

    def add(network, label, keys, kind="forward", times=1):
        batches.append((kind, network, label, keys))
        for kern, case in keys:
            row = mult.setdefault((kern, case), {
                "network": network, "kernel": kern, "case": case,
                "launches": 0})
            row["launches"] += times

    for network, cap, n_req, stack in SERVED:
        for B in batch_sizes(n_req, cap):
            bucket = PlanCache(str(packaged_plans(network)),
                               max_bucket=cap).bucket(B)
            add(network, f"bucket={bucket} stack={stack}",
                plan_launches(network, bucket, stack))
    for network, cap, n_req in PLANNED:
        for bucket in sorted({bucket_for(B, max_bucket=cap)
                              for B in batch_sizes(n_req, cap)}):
            cfg, plan = planned(network, bucket)
            times = sum(bucket_for(B, max_bucket=cap) == bucket
                        for B in batch_sizes(n_req, cap))
            add(network, f"bucket={bucket} planned on the H100 profile",
                fused_launches(cfg, plan), times=times)
    for network, batch in UNFUSED:
        for mode in MODES:
            add(network, f"batch={batch} unfused {mode}",
                unfused_launches(network, batch, mode)[1])
    for network, batch in TRAINED:
        add(network, f"batch={batch} stack=auto", train_launches(
            network, batch), kind="training step", times=TRAIN_STEPS)
    for kern, case in OFF_PATH.items():
        mult[(kern, case)] = {"network": "vgg16", "kernel": kern,
                              "case": case, "launches": 0}
    for i, ((kern, case), row) in enumerate(mult.items()):
        t0 = time.perf_counter()
        if kern == "softmax":
            m = softmax_case(case, dev, i)
        elif kern == "softmax_xent":
            m = xent_case(case, dev, i)
        elif kern == "wgrad":
            m = wgrad_case(case, dev, i)
        elif kern in POOL_BWD_KERNELS:
            m = pool_bwd_case(kern, case, dev, i)
        elif case[0] == "save_act":
            m = save_act_case(kern, case, dev, i)
        elif case[0] == "dgrad":
            m = dgrad_case(kern, case, dev, i)
        elif kern in STACK_KERNELS:
            m = stack_case(kern, case, dev, i)
        elif kern in POOL_KERNELS:
            m = pool_case(kern, case, dev, i)
        elif kern in TRANSPOSE_KERNELS:
            m = transpose_case(kern, case, dev, i)
        else:
            m = conv_case(kern, case, dev, i)
        row.update(m)
        extra = ""
        if kern in STACK_KERNELS:
            extra = (f" executed_GFLOP={m['executed_flops'] / 1e9:.2f} "
                     f"direct_GFLOP={m['flops'] / 1e9:.2f} "
                     f"executed/direct="
                     f"{m['executed_flops'] / m['flops']:.3f} "
                     f"executed_TFLOP/s="
                     f"{m['executed_flops'] / m['ms'] / 1e9:.1f} "
                     f"smem_per_block={m['smem_bytes']} "
                     f"blocks={m['blocks']} cluster={m['cluster']} "
                     f"tile={m['tile']}")
            if kern == "conv_stack_chwn":
                extra += (f" counted_GFLOP={m['counted_flops'] / 1e9:.2f} "
                          f"counted_cluster={m['counted_cluster']} "
                          f"resident_clusters={m['resident_clusters']}")
            else:
                extra += (f" counted_GFLOP={m['counted_flops'] / 1e9:.2f} "
                          f"f64_err={m['f64_err']:.3g} "
                          f"bound_3xtf32_ms={m['design_bound_ms']:.4f}")
        if kern in POOL_KERNELS:
            extra = f" folded_dst_ms={m['folded_ms']:.4f}"
        if kern == "wgrad":
            extra = (f" TFLOP/s={m['flops'] / m['ms'] / 1e9:.1f} "
                     f"bound_3xtf32_ms={m['design_bound_ms']:.4f}")
        if kern in POOL_BWD_KERNELS:
            extra = f" bound_share={m['bound_ms'] / m['ms']:.3f}"
        if kern in ("softmax", "softmax_xent"):
            host = " ".join(f"{k}={v:.3f}" for k, v in m["host_us"].items())
            med = " ".join(f"{k}={v:.4f}" for k, v in m["median5"].items())
            extra = (f" median5: {med} device_ms={m['device_ms']:.5f} "
                     f"plain_device_ms={m['plain_device_ms']:.5f} "
                     f"library_device_ms={m['library_device_ms']:.5f} "
                     f"host_us: {host}")
        if kern in ("conv_chwn", "conv_nchw"):
            extra = (f" f64_err={m['f64_err']:.3g} TFLOP/s="
                     f"{m['flops'] / m['ms'] / 1e9:.1f} "
                     f"bound_3xtf32_ms={m['design_bound_ms']:.4f}")
            if "tile" in m and (kern == "conv_nchw" or m["tile"]["nb"]):
                extra += (f" executed/direct="
                          f"{m['executed_flops'] / m['flops']:.3f} "
                          f"tile={m['tile']} blocks={m['blocks']}")
        print(f"kernel {kern:<15s} {row['network']:<8s} case={case} "
              f"x{row['launches']}: max_abs_err={m['max_abs_err']:.3g} "
              f"max_rel_err={m['max_rel_err']:.3g} ms={m['ms']:.4f} "
              f"plain_ms={m['plain_ms']:.4f} "
              f"library_ms={m['library_ms']:.4f} "
              f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']}){extra} "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    print(tensor_core_line("K6", [r for r in mult.values()
                                  if r["kernel"] == "wgrad"]), flush=True)
    # per forward (and training step): each kernel's launches summed
    for kind, network, label, keys in batches:
        for kern in KERNELS:
            rows = [mult[k] for k in keys if k[0] == kern]
            if rows:
                tot = {f: sum(r[f] for r in rows)
                       for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "flops", "bytes")}
                print(f"{kind} {network} {label} {kern}: "
                      f"launches={len(rows)} ms={tot['ms']:.4f} "
                      f"plain_ms={tot['plain_ms']:.4f} "
                      f"library_ms={tot['library_ms']:.4f} "
                      f"bound_ms={tot['bound_ms']:.4f} "
                      f"GFLOP={tot['flops'] / 1e9:.2f} "
                      f"MB={tot['bytes'] / 1e6:.1f}")
    return list(mult.values())


# -- the main path ----------------------------------------------------------

def serving_phase(dev, th):
    """Serve the main path through CNNServer (thresholds ``th``, the
    card's); returns launches per kernel over the whole main path."""
    total = {k: 0 for k in K.WRAPPERS}
    for network, cap, n_req, stack in SERVED:
        srv = CNNServer(network, reduced=False, max_bucket=cap, seed=0,
                        stack=stack, thresholds=th)
        rng = np.random.default_rng(1)
        c, h = srv.cfg.in_channels, srv.cfg.image_hw
        images = [rng.standard_normal((c, h, h), np.float32)
                  for _ in range(n_req)]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        done = srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()

        want_counts = {k: 0 for k in K.WRAPPERS}
        start, worst, warm = 0, 0.0, []
        params = srv.model.params()
        for B in batch_sizes(n_req, cap):
            bucket = srv.cache.bucket(B)
            for kern, _ in plan_launches(network, bucket, stack):
                want_counts[kern] += 1
            plan = srv.cache.peek_fused(srv.cfg, B, stack=stack)
            x = torch.from_numpy(np.stack(images[start:start + B])).to(dev)
            xb = pad_to_bucket(x, bucket)
            y, _ = forward_fused(params, xb, srv.cfg, plan, impl="torch")
            want = y[:B].cpu().numpy()
            # warm whole-forward device time of both engines on this batch
            # (after the counted run: these launches are not the main path's)
            warm.append((bucket, *(cuda_ms(
                lambda impl=impl: forward_fused(params, xb, srv.cfg, plan,
                                                impl=impl), max_reps=20)
                for impl in ("cuda", "torch"))))
            got = np.stack([done[i] for i in range(start, start + B)])
            if got.shape != (B, srv.cfg.num_classes):
                raise AssertionError(f"{network}: answers of shape "
                                     f"{got.shape}")
            if not np.isfinite(got).all():
                raise AssertionError(f"{network}: non-finite answers")
            err = float(np.abs(got - want).max())
            if err > PROBS_ATOL:
                raise AssertionError(
                    f"{network} bucket {bucket} stack={stack}: served "
                    f"probabilities differ "
                    f"from the torch engine by {err:.3g} > {PROBS_ATOL}")
            worst = max(worst, err)
            start += B
        if counts != want_counts:
            raise AssertionError(f"{network} stack={stack}: launches "
                                 f"{counts} != the plans' {want_counts}")
        print(f"serve {network} stack={stack}: {n_req} requests in "
              f"{wall:.3f}s, launches {counts} (= the plans'), max |probs - "
              f"torch engine| = {worst:.3g}")
        for line in srv.report_lines():
            print(line)
        for bucket, ms_k, ms_t in warm:
            print(f"warm forward {network} bucket={bucket} stack={stack}: "
                  f"kernels "
                  f"{ms_k:.3f} ms ({1e3 * bucket / ms_k:.1f} img/s), torch "
                  f"engine (cuDNN, TF32 off) {ms_t:.3f} ms "
                  f"({1e3 * bucket / ms_t:.1f} img/s)")
        for k, v in counts.items():
            total[k] += v
        del srv
        torch.cuda.empty_cache()
    return total


def stack_compare(dev, th):
    """Warm whole-forward time and peak device memory of one forward,
    stacked ("auto") against unstacked ("off") plans, on the same weights
    and batch; the torch engine's forward beside them.  Outside the main
    path: these launches are not counted."""
    out = []
    for network, bucket in COMPARED:
        srv = CNNServer(network, reduced=False, max_bucket=bucket, seed=0,
                        thresholds=th)
        cfg, params = srv.cfg, srv.model.params()
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal(
            (bucket, cfg.in_channels, cfg.image_hw, cfg.image_hw),
            np.float32)).to(dev)
        plans = {s: srv.cache.peek_fused(cfg, bucket, stack=s)
                 for s in ("auto", "off")}
        row = {"network": network, "bucket": bucket}
        ys = {}
        for s, plan in plans.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y, st = forward_fused(params, x, cfg, plan)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            ys[s] = y
            row[s] = {"peak_bytes": peak, "peak_over_base_bytes": peak - base,
                      "modeled_bytes": st.hbm_bytes,
                      "stacks": plan.stacked_convs,
                      "ms": cuda_ms(lambda plan=plan: forward_fused(
                          params, x, cfg, plan), max_reps=20)}
        row["torch_ms"] = cuda_ms(lambda: forward_fused(
            params, x, cfg, plans["off"], impl="torch"), max_reps=20)
        diff = (ys["auto"] - ys["off"]).abs().max().item()
        if diff > PROBS_ATOL:
            raise AssertionError(f"{network}: stacked and unstacked "
                                 f"forwards differ by {diff:.3g}")
        a, o = row["auto"], row["off"]
        print(f"stacked vs unstacked {network} bucket={bucket}: warm "
              f"forward auto {a['ms']:.3f} ms, off {o['ms']:.3f} ms, torch "
              f"engine {row['torch_ms']:.3f} ms; peak device memory of one "
              f"forward auto {a['peak_bytes'] / 2**20:.1f} MiB (+"
              f"{a['peak_over_base_bytes'] / 2**20:.1f} over weights and "
              f"input), off {o['peak_bytes'] / 2**20:.1f} MiB (+"
              f"{o['peak_over_base_bytes'] / 2**20:.1f}); modeled MB auto "
              f"{a['modeled_bytes'] / 1e6:.1f}, off "
              f"{o['modeled_bytes'] / 1e6:.1f}; stacks {a['stacks']}; "
              f"max |auto - off| = {diff:.3g}", flush=True)
        out.append(row)
        del srv, params, ys, x
        torch.cuda.empty_cache()
    return out


def planned(network: str, bucket: int, stack: str = "auto"):
    """(cfg at ``bucket``, the fused plan the port's planner makes for it
    on its default, H100, profile): what a plan-cache miss plans."""
    cfg = CNN_CONFIGS[network].replace(batch=bucket)
    return cfg, plan_network_fused(cfg, stack_policy=stack)


def calibration_sweep(dev):
    """The paper's Fig. 4 on the card: K1 and K2 timed by the card measure
    (CUDA events) over its whole grid (Ci 1-512 at N 64, then N 16-512 at
    Ci 256; ``calibrate``'s base layer, Co 384, 13 x 13, F 3), each point
    printed beside the H100 model's pick and held once against
    ``conv_ref`` (not counted: a calibration is a measurement, not a
    served path); then ``calibrate`` over those timings (measuring any
    point it asks for beyond the grid) gives the (Ct, Nt) the card's
    servers plan under."""
    measure, points = card_conv_measure(device=dev), {}

    def recorded(l, layout):
        pt = points.setdefault((l.N, l.Ci), {"layer": l})
        if layout not in pt:
            pt[layout] = measure(l, layout)
        return pt[layout]

    t0 = time.perf_counter()
    grid = ([ConvLayer("CAL", 64, 384, 13, 3, c, 1, "cal") for c in C_SWEEP]
            + [ConvLayer("CAL", n, 384, 13, 3, 256, 1, "cal")
               for n in N_SWEEP])
    for l in grid:
        for layout in ("CHWN", "NCHW"):
            recorded(l, layout)
    th = calibrate(measure=recorded, dtype_bytes=4)
    sweep_s = time.perf_counter() - t0
    hw = hardware_id(dev)
    worst = 0.0
    for (n, ci), pt in points.items():
        l = pt["layer"]
        gen = torch.Generator(device=dev).manual_seed(n * 1000 + ci)
        x = torch.randn(n, ci, l.HW, l.HW, device=dev, generator=gen)
        w = 0.1 * torch.randn(l.Co, ci, l.F, l.F, device=dev, generator=gen)
        want = conv_ref(x, w, l.S, 0)
        for layout in ("CHWN", "NCHW"):
            got = conv_forward(x.permute(perm_between("NCHW", layout))
                               .contiguous(), w, layout, l.S, 0)
            got = got.permute(perm_between(layout, "NCHW"))
            torch.testing.assert_close(got, want, rtol=CONV_RTOL,
                                       atol=CONV_ATOL)
            worst = max(worst, (got - want).abs().max().item())
        pt["model"] = select_conv_layout_cost(l, 4)
        print(f"calibrate {hw}: N={n} Ci={ci} Co={l.Co} {l.HW}x{l.HW} "
              f"F={l.F}: K1 (CHWN) {1e3 * pt['CHWN']:.4f} ms, K2 (NCHW) "
              f"{1e3 * pt['NCHW']:.4f} ms -> "
              f"{'CHWN' if pt['CHWN'] <= pt['NCHW'] else 'NCHW'} (the "
              f"model: {pt['model']})", flush=True)
    model = calibrate(dtype_bytes=4)
    print(f"calibrate {hw}: measured Ct={th.Ct} Nt={th.Nt} in "
          f"{sweep_s:.2f}s ({len(points)} points, K1/K2 within "
          f"{worst:.3g} of conv_ref); the H100 model's Ct={model.Ct} "
          f"Nt={model.Nt}", flush=True)
    return th, {"hardware": hw, "Ct": th.Ct, "Nt": th.Nt,
                "model_Ct": model.Ct, "model_Nt": model.Nt,
                "points": [{"N": n, "Ci": ci, "chwn_s": pt["CHWN"],
                            "nchw_s": pt["NCHW"], "model": pt["model"]}
                           for (n, ci), pt in points.items()]}


def model_vs_card(dev, network: str, bucket: int, params) -> dict:
    """The H100 model's seconds for stack "auto" and "off" beside the
    warm forward of each plan on the kernels (CUDA events); both outputs
    held against the torch engine.  Not counted on the main path."""
    row = {"network": network, "bucket": bucket}
    cfg = CNN_CONFIGS[network].replace(batch=bucket)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        input_shape(cfg), np.float32)).to(dev)
    for stack in ("auto", "off"):
        _, plan = planned(network, bucket, stack)
        y, _ = forward_fused(params, x, cfg, plan)
        y_t, _ = forward_fused(params, x, cfg, plan, impl="torch")
        err = (y - y_t).abs().max().item()
        if err > PROBS_ATOL:
            raise AssertionError(f"{network} bucket {bucket} {stack}: the "
                                 f"planned forward differs from the torch "
                                 f"engine by {err:.3g}")
        row[stack] = {"model_s": plan.total_s, "stacks": plan.stacked_convs,
                      "layouts": plan.conv_signature,
                      "ms": cuda_ms(lambda plan=plan: forward_fused(
                          params, x, cfg, plan), max_reps=20)}
    a, o = row["auto"], row["off"]
    same = (a["layouts"], a["stacks"]) == (o["layouts"], o["stacks"])
    model_first = "auto" if a["model_s"] < o["model_s"] else "off"
    card_first = "auto" if a["ms"] < o["ms"] else "off"
    row["agree"] = same or model_first == card_first
    verdict = ("one plan (no stack pays)" if same else
               f"model orders {model_first} first, the card {card_first}: "
               + ("agree" if row["agree"] else "DISAGREE"))
    print(f"model vs card {network} bucket={bucket}: auto "
          f"{a['layouts']}+{a['stacks']} stacks model "
          f"{1e3 * a['model_s']:.4f} ms card {a['ms']:.3f} ms; off "
          f"{o['layouts']} model {1e3 * o['model_s']:.4f} ms card "
          f"{o['ms']:.3f} ms; {verdict}", flush=True)
    return row


def planner_phase(dev, th):
    """Under the card's thresholds ``th``, serve each ``PLANNED`` network
    from an empty cache: every bucket is a miss that the planner plans on
    the H100 profile (counts zeroed just before each run and read just
    after; they must equal the plans', and ``planner_calls`` the distinct
    buckets), each answer within 1e-5 of the torch engine.  Then the
    model's "auto"/"off" seconds beside the card's, for the served
    buckets and ``MODEL_VS_CARD``.  Returns (launches per kernel over the
    served runs, a record)."""
    total = {k: 0 for k in K.WRAPPERS}
    served, rows = [], []
    for network, cap, n_req in PLANNED:
        srv = CNNServer(network, reduced=False, max_bucket=cap, seed=0,
                        thresholds=th)
        if srv.cache.planner_calls or srv.cache.peek_fused(srv.cfg, cap):
            raise AssertionError(f"{network}: the cache is not empty")
        rng = np.random.default_rng(5)
        c, h = srv.cfg.in_channels, srv.cfg.image_hw
        images = [rng.standard_normal((c, h, h), np.float32)
                  for _ in range(n_req)]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        done = srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        want_counts = {k: 0 for k in K.WRAPPERS}
        params, start, worst = srv.model.params(), 0, 0.0
        buckets = []
        for B in batch_sizes(n_req, cap):
            bucket = srv.cache.bucket(B)
            buckets.append(bucket)
            cfg, plan = planned(network, bucket)
            if srv.cache.peek_fused(srv.cfg, bucket) != plan:
                raise AssertionError(f"{network} bucket {bucket}: the "
                                     f"server planned another plan")
            for kern, _ in fused_launches(cfg, plan):
                want_counts[kern] += 1
            x = torch.from_numpy(np.stack(images[start:start + B])).to(dev)
            y, _ = forward_fused(params, pad_to_bucket(x, bucket), srv.cfg,
                                 plan, impl="torch")
            got = np.stack([done[i] for i in range(start, start + B)])
            if got.shape != (B, srv.cfg.num_classes) or not \
                    np.isfinite(got).all():
                raise AssertionError(f"{network}: answers of shape "
                                     f"{got.shape}, or not finite")
            err = float(np.abs(got - y[:B].cpu().numpy()).max())
            if err > PROBS_ATOL:
                raise AssertionError(
                    f"{network} bucket {bucket}: served probabilities "
                    f"differ from the torch engine by {err:.3g}")
            worst = max(worst, err)
            start += B
        if counts != want_counts:
            raise AssertionError(f"{network}: launches {counts} != the "
                                 f"plans' {want_counts}")
        if srv.cache.planner_calls != len(set(buckets)):
            raise AssertionError(
                f"{network}: {srv.cache.planner_calls} planner calls for "
                f"{len(set(buckets))} distinct buckets")
        launched = {k: v for k, v in counts.items() if v}
        print(f"planner serve {network}: {n_req} requests in {wall:.3f}s, "
              f"planner_calls={srv.cache.planner_calls} (= the distinct "
              f"buckets {sorted(set(buckets))}), launches {launched} (= "
              f"the plans'), max |probs - torch engine| = {worst:.3g}",
              flush=True)
        for line in srv.report_lines():
            print(line)
        for k, v in counts.items():
            total[k] += v
        served.append({"network": network, "buckets": buckets,
                       "planner_calls": srv.cache.planner_calls,
                       "launches": launched, "max_abs_err": worst,
                       "seconds": wall})
        for bucket in sorted(set(buckets)):
            rows.append(model_vs_card(dev, network, bucket, params))
        del srv, params
        torch.cuda.empty_cache()
    for network, bucket in MODEL_VS_CARD:
        cfg = CNN_CONFIGS[network]
        params = params_from_numpy(init_cnn(cfg, 0), dev)
        rows.append(model_vs_card(dev, network, bucket, params))
        del params
        torch.cuda.empty_cache()
    wrong = [f"{r['network']} b{r['bucket']}" for r in rows
             if not r["agree"]]
    print(f"model vs card: the H100 model orders stack auto/off as the "
          f"card does on {len(rows) - len(wrong)} of {len(rows)}"
          + (f"; wrong on {', '.join(wrong)}" if wrong else ""), flush=True)
    return total, {"served": served, "model_vs_card": rows}


def unfused_phase(dev):
    """Run the unfused executor in every mode (the main path's third part;
    each forward is its own path, counts zeroed just before it and read
    just after); returns (launches per kernel over all of them, rows)."""
    total = {k: 0 for k in K.WRAPPERS}
    rows = []
    for network, batch in UNFUSED:
        cfg = CNN_CONFIGS[network].replace(batch=batch)
        params = params_from_numpy(init_cnn(cfg, 0), dev)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            input_shape(cfg), np.float32)).to(dev)
        for mode in MODES:
            layouts, keys = unfused_launches(network, batch, mode)
            want_counts = {k: 0 for k in K.WRAPPERS}
            for kern, _ in keys:
                want_counts[kern] += 1
            K.reset_launch_counts()
            y, st = forward(params, x, cfg, layouts, impl="cuda")
            torch.cuda.synchronize()
            counts = K.launch_counts()
            y_t, st_t = forward(params, x, cfg, layouts, impl="torch")
            torch.cuda.synchronize()
            if tuple(y.shape) != (batch, cfg.num_classes):
                raise AssertionError(f"{network} {mode}: output shape "
                                     f"{tuple(y.shape)}")
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{network} {mode}: non-finite output")
            err = (y - y_t).abs().max().item()
            if err > PROBS_ATOL:
                raise AssertionError(
                    f"{network} {mode}: probabilities differ from the torch "
                    f"engine by {err:.3g} > {PROBS_ATOL}")
            if st != st_t:
                raise AssertionError(f"{network} {mode}: RunStats {st} != "
                                     f"the torch engine's {st_t}")
            if st.transforms != want_counts["transpose2d"]:
                raise AssertionError(
                    f"{network} {mode}: {st.transforms} transforms, the "
                    f"layouts call for {want_counts['transpose2d']}")
            if counts != want_counts:
                raise AssertionError(f"{network} {mode}: launches {counts} "
                                     f"!= the layouts' {want_counts}")
            ms_k = cuda_ms(lambda: forward(params, x, cfg, layouts,
                                           impl="cuda"), max_reps=20)
            ms_t = cuda_ms(lambda: forward(params, x, cfg, layouts,
                                           impl="torch"), max_reps=20)
            sig = "".join(l[0] for l in layouts)
            launched = {k: v for k, v in counts.items() if v}
            print(f"unfused {network} batch={batch} mode={mode} layouts="
                  f"{sig} transforms={st.transforms} "
                  f"transform_MB={st.transform_bytes / 1e6:.1f} "
                  f"modeled_MB={st.hbm_bytes / 1e6:.1f}: kernels "
                  f"{ms_k:.3f} ms ({1e3 * batch / ms_k:.1f} img/s), torch "
                  f"engine (cuDNN, TF32 off) {ms_t:.3f} ms "
                  f"({1e3 * batch / ms_t:.1f} img/s); launches {launched} "
                  f"(= the layouts'); max |probs - torch engine| = "
                  f"{err:.3g}", flush=True)
            rows.append({"network": network, "batch": batch, "mode": mode,
                         "layouts": sig, "transforms": st.transforms,
                         "transform_bytes": st.transform_bytes,
                         "hbm_bytes": st.hbm_bytes, "ms": ms_k,
                         "torch_ms": ms_t, "launches": launched,
                         "max_abs_err": err})
            if mode == "opt":
                # beside the H100-priced layouts, once: the packaged
                # assignment the reference priced for its TPU (not counted)
                tpu = PlanCache(str(packaged_plans(network))).assignment(
                    cfg, batch)[0].layouts
                y_p, _ = forward(params, x, cfg, tpu, impl="cuda")
                err_p = (y_p - y_t).abs().max().item()
                if err_p > PROBS_ATOL:
                    raise AssertionError(
                        f"{network} packaged opt: probabilities differ "
                        f"from the torch engine by {err_p:.3g}")
                ms_p = cuda_ms(lambda: forward(params, x, cfg, tpu,
                                               impl="cuda"), max_reps=20)
                rows[-1]["packaged_tpu_priced"] = {
                    "layouts": "".join(l[0] for l in tpu), "ms": ms_p}
                print(f"unfused {network} batch={batch} opt, the packaged "
                      f"TPU-priced assignment: layouts="
                      f"{''.join(l[0] for l in tpu)}: kernels {ms_p:.3f} ms "
                      f"against {ms_k:.3f} for the H100-priced layouts",
                      flush=True)
            for k, v in counts.items():
                total[k] += v
        mine = [r for r in rows if r["network"] == network]
        best = min(mine, key=lambda r: r["ms"])
        best_t = min(mine, key=lambda r: r["torch_ms"])
        print(f"unfused {network}: fastest mode on the kernels "
              f"{best['mode']} ({best['ms']:.3f} ms); on the torch engine "
              f"{best_t['mode']} ({best_t['torch_ms']:.3f} ms)", flush=True)
        del params, x, y, y_t
        torch.cuda.empty_cache()
    return total, rows


def _step1_gradients(network, cfg, plan, params, x, labels) -> dict:
    """The step-1 gradient of every parameter on the kernels, on the torch
    engine, and on the torch engine in float64 (the oracle); not counted
    on the main path.  For each pair, the largest max-abs scale-relative
    difference over the parameters (|d| / max(1, max|ref|)) and the largest
    fraction of a parameter's elements beyond ``GRAD_TOL`` in that form.
    Fails unless, against the torch engine and against float64, at least
    ``1 - GRAD_OUTLIERS`` of every parameter's elements are within
    ``GRAD_TOL`` and all within ``GRAD_OUTLIER_TOL``: a ReLU pre-activation
    within rounding of zero lands on the other side of the mask in one of
    two fp32 evaluations, and that one element moves a few weight-gradient
    entries by |g|*|x| (the torch engine's own distance to float64 shows
    the same outliers)."""
    p64 = {l: {k: v.double() for k, v in p.items()}
           for l, p in params.items()}
    runs = {"cuda": (params, x, "cuda"), "torch": (params, x, "torch"),
            "f64": (p64, x.double(), "torch")}
    g = {name: value_and_grad(
        lambda p, a, b, impl=impl: loss_fn_fused(p, a, b, cfg, plan, impl),
        ps, xs, labels)[1] for name, (ps, xs, impl) in runs.items()}
    del p64
    out = {}
    for a, b in (("cuda", "torch"), ("cuda", "f64"), ("torch", "f64")):
        worst, frac = 0.0, 0.0
        for layer, gs in g[b].items():
            for k, ref in gs.items():
                ref = ref.double()
                d = (g[a][layer][k].double() - ref).abs() / max(
                    1.0, ref.abs().max().item())
                worst = max(worst, d.max().item())
                frac = max(frac, (d > GRAD_TOL).double().mean().item())
        out[f"{a}_vs_{b}_max"] = float(f"{worst:.3g}")
        out[f"{a}_vs_{b}_frac_over_tol"] = float(f"{frac:.3g}")
        if a == "cuda" and (frac > GRAD_OUTLIERS
                            or worst > GRAD_OUTLIER_TOL):
            raise AssertionError(
                f"train {network}: step-1 gradients {a} vs {b}: "
                f"{frac:.3g} of a parameter's elements beyond {GRAD_TOL} "
                f"(at most {GRAD_OUTLIERS}), largest {worst:.3g} (at most "
                f"{GRAD_OUTLIER_TOL}), scale-relative")
    return out


def training_phase(dev):
    """Train each of ``TRAINED`` at full width from the seed-0 weights on
    its packaged stack="auto" plan: ``TRAIN_STEPS`` SGD-with-momentum steps
    of ``make_train_step_fused`` on the kernels (the main path's training
    part: counts zeroed just before each step and read just after, equal
    to ``train_launches``), and the same steps from the same start on the
    torch engine and on the torch engine in float64.  Every loss finite;
    at every step the kernels' loss within ``LOSS_ATOL`` of the torch
    engine's loss at the same parameters (the kernels' trajectory); the
    step-1 gradients held as ``_step1_gradients`` says.  The three
    independent trajectories are reported beside, not gated: from step 3
    on, a ReLU mask flip in one fp32 run moves a loss that falls by
    tenths a step by ~1e-4, and the torch engine departs from its own
    float64 run by that much.  Then one warm step on each engine is timed
    (CUDA events) and the peak device memory of a step is read.  Runs
    outside inference mode (autograd needs it).  Returns (launches per
    kernel over the counted steps, rows)."""
    total = {k: 0 for k in K.WRAPPERS}
    rows = []
    for network, batch in TRAINED:
        cfg = CNN_CONFIGS[network].replace(batch=batch)
        plan = PlanCache(str(packaged_plans(network))).peek_fused(
            cfg, batch, stack="auto")
        want = {k: 0 for k in K.WRAPPERS}
        for kern, _ in train_launches(network, batch):
            want[kern] += 1
        params = params_from_numpy(init_cnn(cfg, 0), dev)
        rng = np.random.default_rng(4)
        x = torch.from_numpy(rng.standard_normal(
            input_shape(cfg), np.float32)).to(dev)
        labels = torch.from_numpy(rng.integers(
            0, cfg.num_classes, batch)).to(dev)
        grad = _step1_gradients(network, cfg, plan, params, x, labels)
        losses, same_point = {}, []
        for run in ("cuda", "torch", "f64"):
            impl = "torch" if run == "f64" else run
            dt = torch.float64 if run == "f64" else torch.float32
            step = make_train_step_fused(cfg, plan, impl=impl)
            p = {l: {k: v.to(dt) for k, v in q.items()}
                 for l, q in params.items()}
            v, xr, ls = init_velocity(p), x.to(dt), []
            for _ in range(TRAIN_STEPS):
                if run == "cuda":   # the torch engine at the same point
                    with torch.no_grad():
                        same_point.append(loss_fn_fused(
                            p, x, labels, cfg, plan, "torch").item())
                K.reset_launch_counts()
                p, v, loss = step(p, v, xr, labels)
                torch.cuda.synchronize()
                counts = K.launch_counts()
                if run != "cuda" and any(counts.values()):
                    raise AssertionError(f"train {network}: the torch engine "
                                         f"launched {counts}")
                if run == "cuda":
                    if counts != want:
                        raise AssertionError(
                            f"train {network}: launches {counts} != the "
                            f"plan's {want}")
                    for k, n in counts.items():
                        total[k] += n
                ls.append(loss.item())
            losses[run] = ls
            del p, v, xr
        if not all(math.isfinite(v) for ls in losses.values() for v in ls):
            raise AssertionError(f"train {network}: non-finite loss {losses}")
        diffs = [abs(a - b) for a, b in zip(losses["cuda"], same_point)]
        if max(diffs) >= LOSS_ATOL:
            raise AssertionError(
                f"train {network}: losses {losses['cuda']} differ from the "
                f"torch engine's at the same parameters {same_point} by "
                f"{max(diffs):.3g} >= {LOSS_ATOL}")
        apart = {f"{a}_vs_{b}": [float(f"{abs(u - w):.3g}") for u, w in
                                 zip(losses[a], losses[b])]
                 for a, b in (("cuda", "torch"), ("cuda", "f64"),
                              ("torch", "f64"))}
        row = {"network": network, "batch": batch, "losses": losses,
               "torch_at_same_params": same_point, "loss_diffs": diffs,
               "trajectories_apart": apart, "grad": grad,
               "launches": {k: v for k, v in want.items() if v}}
        vel = init_velocity(params)
        for impl in ("cuda", "torch"):
            step = make_train_step_fused(cfg, plan, impl=impl)
            row[f"{impl}_ms"] = cuda_ms(lambda: step(params, vel, x, labels),
                                        max_reps=10)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = step(params, vel, x, labels)
            torch.cuda.synchronize()
            row[f"{impl}_peak_bytes"] = torch.cuda.max_memory_allocated()
            row[f"{impl}_peak_over_base_bytes"] = (
                row[f"{impl}_peak_bytes"] - base)
            del out
        print(f"train {network} batch={batch} stack=auto: losses kernels "
              f"{losses['cuda']}, torch engine at the same parameters "
              f"{same_point} (max diff {max(diffs):.3g}); independent "
              f"trajectories torch engine {losses['torch']}, float64 "
              f"{losses['f64']}, apart {apart}; step-1 gradients {grad}; "
              f"launches per step {row['launches']} (= "
              f"the plan's); warm step kernels {row['cuda_ms']:.3f} ms "
              f"({1e3 * batch / row['cuda_ms']:.1f} img/s), torch engine "
              f"(cuDNN, TF32 off) {row['torch_ms']:.3f} ms "
              f"({1e3 * batch / row['torch_ms']:.1f} img/s); peak device "
              f"memory of a step kernels "
              f"{row['cuda_peak_bytes'] / 2**20:.1f} MiB (+"
              f"{row['cuda_peak_over_base_bytes'] / 2**20:.1f} over weights "
              f"and input), torch engine "
              f"{row['torch_peak_bytes'] / 2**20:.1f} MiB (+"
              f"{row['torch_peak_over_base_bytes'] / 2**20:.1f})",
              flush=True)
        rows.append(row)
        del params, vel, x, labels
        torch.cuda.empty_cache()
    return total, rows


def _expect_counts(label: str, counts, want) -> None:
    full = {k: want.get(k, 0) for k in K.WRAPPERS}
    if counts != full:
        raise AssertionError(f"{label}: launches {counts} != {full}")


def _peak_over_base(fn) -> int:
    """Device memory ``fn`` allocates at its peak, over what was allocated
    before it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def conv_layer_phase(dev):
    """The paper's Fig. 3 / Table 1 comparison of conv engines, the K10
    path: every Table-1 layer at its published shape (pad 0, seeded fp32
    data) through the matrix-expansion baseline ``conv_im2col_nchw`` (its
    matmul one K10 launch), the virtual-im2col K2, the direct K1 on the
    CHWN copy and the FFT conv ``conv_forward(impl="fft")``, each held
    against ``conv_ref`` (K10/K2/K1 at the conv tolerance, FFT at the
    reference's rtol 1e-3 / atol 1e-2).  The launch counts are zeroed just
    before the layers run and read just after: K10, K2 and K1 12 each.
    Then each engine is timed warm beside cuDNN (``F.conv2d``, TF32 off),
    K10 alone on the materialized patch matrix beside its plain version
    and ``torch.matmul``, and the baseline's peak device memory read.
    Returns (launches per kernel, kernel cases, per-layer rows)."""
    data = []
    for i, layer in enumerate(CONV_LAYERS):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn(layer.N, layer.Ci, layer.HW, layer.HW, device=dev,
                        generator=gen)
        w = torch.randn(layer.Co, layer.Ci, layer.F, layer.F, device=dev,
                        generator=gen) / math.sqrt(layer.Ci * layer.F ** 2)
        data.append((x, w))
    errs = []
    K.reset_launch_counts()
    for layer, (x, w) in zip(CONV_LAYERS, data):
        S, pad = layer.S, layer.pad
        want = conv_ref(x, w, S, pad)
        xc = x.permute(1, 2, 3, 0).contiguous()
        wc = w.permute(1, 2, 3, 0).contiguous()
        got = {"im2col+K10": conv_im2col_nchw(x, w, S, pad),
               "K2": conv_im2col_nchw_fused(x, w, S, pad),
               "K1": conv_direct_chwn(xc, wc, S, pad).permute(3, 0, 1, 2),
               "fft": conv_forward(x, w, "NCHW", S, pad, impl="fft")}
        err = {}
        for engine, y in got.items():
            if tuple(y.shape) != tuple(want.shape):
                raise AssertionError(f"{layer.name} {engine}: shape "
                                     f"{tuple(y.shape)} != "
                                     f"{tuple(want.shape)}")
            err[engine] = (y - want).abs().max().item()
            print(f"table1 {layer.name} {engine}: max |y - conv_ref| = "
                  f"{err[engine]:.3g} (max |conv_ref| "
                  f"{want.abs().max().item():.3g})", flush=True)
            rtol, atol = ((FFT_RTOL, FFT_ATOL) if engine == "fft"
                          else (CONV_RTOL, CONV_ATOL))
            torch.testing.assert_close(y, want, rtol=rtol, atol=atol)
        errs.append(err)
        del got, want, xc, wc
    torch.cuda.synchronize()
    counts = K.launch_counts()
    n = len(CONV_LAYERS)
    _expect_counts("table1", counts,
                   {"matmul": n, "conv_nchw": n, "conv_chwn": n})

    cases, rows = [], []
    for layer, (x, w), err in zip(CONV_LAYERS, data, errs):
        t0 = time.perf_counter()
        S, pad, F = layer.S, layer.pad, layer.F
        Ho = layer.out_hw
        patches, _ = im2col_nchw(x, F, S, pad)
        wmat = w.reshape(layer.Co, -1).T
        M, Kd = patches.shape
        out = layer.N * layer.Co * Ho * Ho
        flops = 2.0 * out * Kd
        conv_bytes = 4.0 * (x.numel() + w.numel() + out)
        mm = _measure(lambda: matmul(patches, wmat),
                      lambda: matmul_ref(patches, wmat),
                      lambda: torch.matmul(patches, wmat), flops,
                      4.0 * (M * Kd + Kd * layer.Co + M * layer.Co))
        _fp32_gate(mm, [(matmul(patches, wmat),
                         patches.double() @ wmat.double())],
                   f"K10 {layer.name}")
        mt = matmul_tiling(M, layer.Co, Kd)
        mm.update(tile={"bm": mt.bm, "bn": mt.bn, "splits": mt.splits},
                  blocks=mt.blocks)
        xc = x.permute(1, 2, 3, 0).contiguous()
        wc = w.permute(1, 2, 3, 0).contiguous()

        def cudnn():
            return nnf.conv2d(x, w, stride=S, padding=pad)

        k2 = _measure(lambda: conv_im2col_nchw_fused(x, w, S, pad),
                      lambda: conv_ref(x, w, S, pad), cudnn, flops,
                      conv_bytes)
        k1 = _measure(lambda: conv_direct_chwn(xc, wc, S, pad),
                      lambda: conv_ref(xc, w, S, pad, src_layout="CHWN",
                                       dst_layout="CHWN"),
                      cudnn, flops, conv_bytes)
        want64 = conv_ref(x.double(), w.double(), S, pad)
        _fp32_gate(k1, [(conv_direct_chwn(xc, wc, S, pad).permute(
            3, 0, 1, 2), want64)], f"K1 {layer.name}")
        _fp32_gate(k2, [(_k2_tile(k2, layer.name, x, w, S, pad, {}),
                         want64)], f"K2 {layer.name}")
        del want64
        tag = {"network": "table1", "case": layer.name, "launches": 1}
        cases += [{**tag, "kernel": "matmul", **mm},
                  {**tag, "kernel": "conv_nchw", **k2},
                  {**tag, "kernel": "conv_chwn", **k1}]
        row = {"layer": layer.name, "net": layer.net, "N": layer.N,
               "Ci": layer.Ci, "HW": layer.HW, "F": F, "Co": layer.Co,
               "S": S, "M": M, "K": Kd, "gflop": flops / 1e9,
               "patch_bytes": 4 * M * Kd, "errors": err,
               "k10_ms": mm["ms"], "k10_plain_ms": mm["plain_ms"],
               "k10_bound_ms": mm["bound_ms"],
               "baseline_ms": cuda_ms(lambda: conv_im2col_nchw(x, w, S,
                                                               pad)),
               "k2_ms": k2["ms"], "k1_ms": k1["ms"],
               "fft_ms": cuda_ms(lambda: conv_forward(x, w, "NCHW", S, pad,
                                                      impl="fft")),
               "cudnn_ms": k2["library_ms"],
               "conv_bound_ms": k2["bound_ms"],
               "baseline_peak_bytes": _peak_over_base(
                   lambda: conv_im2col_nchw(x, w, S, pad)),
               "fft_peak_bytes": _peak_over_base(
                   lambda: conv_forward(x, w, "NCHW", S, pad, impl="fft"))}
        rows.append(row)
        print(f"table1 {layer.name} ({layer.net}) N={layer.N} Ci={layer.Ci} "
              f"HW={layer.HW} F={F} Co={layer.Co} S={S}: "
              f"{row['gflop']:.2f} GFLOP, patch matrix [{M}, {Kd}] "
              f"{row['patch_bytes'] / 2**20:.1f} MiB; ms: baseline "
              f"(im2col + K10) {row['baseline_ms']:.3f} (K10 alone "
              f"{mm['ms']:.3f}, its plain {mm['plain_ms']:.3f}, "
              f"torch.matmul {mm['library_ms']:.3f}), K2 {k2['ms']:.3f}, "
              f"K1 {k1['ms']:.3f}, FFT {row['fft_ms']:.3f}, cuDNN "
              f"{row['cudnn_ms']:.3f}, bound {k2['bound_ms']:.3f} "
              f"({k2['bound_by']}); peak over base: baseline "
              f"{row['baseline_peak_bytes'] / 2**20:.1f} MiB, FFT "
              f"{row['fft_peak_bytes'] / 2**20:.1f} MiB; K10 vs plain "
              f"{mm['max_abs_err']:.3g}, from float64 {mm['f64_err']:.3g}, "
              f"{flops / mm['ms'] / 1e9:.1f} TFLOP/s, 3xTF32 bound "
              f"{mm['design_bound_ms']:.3f}, tile {mm['tile']} "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
        del patches, wmat, xc, wc
    tot = {k: sum(r[k] for r in rows) for k in
           ("gflop", "patch_bytes", "baseline_ms", "k10_ms", "k2_ms",
            "k1_ms", "fft_ms", "cudnn_ms", "k10_bound_ms", "conv_bound_ms")}
    print(f"table1 total: {tot['gflop']:.1f} GFLOP, patch matrices "
          f"{tot['patch_bytes'] / 1e9:.2f} GB; ms: baseline "
          f"{tot['baseline_ms']:.3f} (K10 {tot['k10_ms']:.3f}, bound "
          f"{tot['k10_bound_ms']:.3f}), K2 {tot['k2_ms']:.3f}, K1 "
          f"{tot['k1_ms']:.3f}, FFT {tot['fft_ms']:.3f}, cuDNN "
          f"{tot['cudnn_ms']:.3f}; launches {counts['matmul']} K10, "
          f"{counts['conv_nchw']} K2, {counts['conv_chwn']} K1", flush=True)
    del data
    torch.cuda.empty_cache()
    return counts, cases, rows


def lm_cases():
    """The LM kernel phase's cases, every width from the configs: K11 on
    qwen2-7b's attention (one train_4k sequence, its KV heads repeated to
    its query heads, causal) in fp32 and bf16 and on whisper-base's encoder
    (``WHISPER_CLIPS`` clips of ``encoder_seq`` frames, not causal); K12 on
    qwen2-7b's head (train_4k tokens) in fp32 and bf16 and on gemma2-27b's
    (``GEMMA_TOKENS`` tokens, its final-logit softcap)."""
    qwen, gemma, whisper = (get_config(a) for a in
                            ("qwen2_7b", "gemma2_27b", "whisper_base"))
    S = TRAIN_4K.seq_len
    attn = [("qwen2_7b", 1, qwen.num_heads, qwen.num_kv_heads, S,
             qwen.head_dim, True, torch.float32),
            ("qwen2_7b", 1, qwen.num_heads, qwen.num_kv_heads, S,
             qwen.head_dim, True, torch.bfloat16),
            ("whisper_base encoder", WHISPER_CLIPS, whisper.num_heads,
             whisper.num_kv_heads, whisper.encoder_seq, whisper.head_dim,
             False, torch.float32)]
    xent = [("qwen2_7b", S, qwen.d_model, qwen.vocab_size,
             qwen.final_logit_softcap, torch.float32),
            ("qwen2_7b", S, qwen.d_model, qwen.vocab_size,
             qwen.final_logit_softcap, torch.bfloat16),
            ("gemma2_27b", GEMMA_TOKENS, gemma.d_model, gemma.vocab_size,
             gemma.final_logit_softcap, torch.float32)]
    return attn, xent


def _attn_inputs(case, dev, seed):
    _, B, H, Hkv, S, D, _, dtype = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, S, D, device=dev, generator=gen).to(dtype)
    # K11 has no GQA: the caller repeats each KV head over its query group
    k, v = (torch.randn(B, Hkv, S, D, device=dev, generator=gen).to(dtype)
            .repeat_interleave(H // Hkv, dim=1) for _ in range(2))
    return q, k, v


def _xent_inputs(case, dev, seed):
    _, T, D, V, _, dtype = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(T, D, device=dev, generator=gen).to(dtype)
    table = (torch.randn(V, D, device=dev, generator=gen) * 0.02).to(dtype)
    labels = torch.randint(0, V, (T,), device=dev, generator=gen)
    return h, table, labels


def lm_phase(dev):
    """The LM kernel path: each case of ``lm_cases`` once through its
    wrapper, the launch counts zeroed just before and read just after (K11
    and K12 one launch a case).  Then each case is held against its plain
    version on the card (fp32 rtol / atol 1e-4, bf16 atol 8 * BF16_EPS),
    K12 run twice more for bitwise equality, and each is timed beside the
    plain version and the library (``F.scaled_dot_product_attention``;
    ``h @ tableᵀ``, softcapped, then ``F.cross_entropy``), TF32 off.
    Returns (launches per kernel, kernel cases)."""
    attn, xent = lm_cases()
    a_in = [_attn_inputs(c, dev, 200 + i) for i, c in enumerate(attn)]
    x_in = [_xent_inputs(c, dev, 300 + i) for i, c in enumerate(xent)]
    K.reset_launch_counts()
    a_out = [flash_attention(q, k, v, causal=c[6])
             for c, (q, k, v) in zip(attn, a_in)]
    x_out = [fused_xent(h, t, lab, softcap=c[4])
             for c, (h, t, lab) in zip(xent, x_in)]
    torch.cuda.synchronize()
    counts = K.launch_counts()
    _expect_counts("lm", counts, {"flash_attention": len(attn),
                                  "fused_xent": len(xent)})
    cases = []
    for c, (q, k, v), got in zip(attn, a_in, a_out):
        t0 = time.perf_counter()
        name, B, H, _, S, D, causal, dtype = c
        bf16 = dtype == torch.bfloat16
        tol = (0.0, BF16_ATOL) if bf16 else (LM_TOL, LM_TOL)
        shape = (B, H, S, D)
        if tuple(got.shape) != shape or got.dtype != dtype or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K11 {name}: {tuple(got.shape)} "
                                 f"{got.dtype}, or non-finite")
        q3, k3, v3 = (t.reshape(B * H, S, D) for t in (q, k, v))
        pairs = S * (S + 1) // 2 if causal else S * S
        m = _measure(lambda: flash_attention(q, k, v, causal=causal),
                     lambda: flash_attention_ref(q3, k3, v3, causal),
                     lambda: nnf.scaled_dot_product_attention(
                         q, k, v, is_causal=causal),
                     4.0 * B * H * pairs * D,
                     q.element_size() * 4.0 * q.numel(), *tol,
                     peak=PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS,
                     got=got.reshape(B * H, S, D))
        lib_err = (got.float() - nnf.scaled_dot_product_attention(
            q, k, v, is_causal=causal).float()).abs().max().item()
        m.update(network=name, kernel="flash_attention", launches=1,
                 case=(B, H, S, D, causal, str(dtype)), library_err=lib_err)
        cases.append(m)
        print(f"lm K11 {name} B={B} H={H} S={S} D={D} causal={causal} "
              f"{dtype}: {m['flops'] / 1e9:.1f} GFLOP; ms {m['ms']:.3f} "
              f"({m['flops'] / m['ms'] / 1e9:.1f} TFLOP/s), plain "
              f"{m['plain_ms']:.3f}, SDPA {m['library_ms']:.3f}, bound "
              f"{m['bound_ms']:.3f} ({m['bound_by']}); max |kernel - "
              f"plain| {m['max_abs_err']:.3g}, |kernel - SDPA| "
              f"{lib_err:.3g} [{time.perf_counter() - t0:.1f}s]", flush=True)
    bf16_errs = [r["max_abs_err"] for r in cases
                 if r["kernel"] == "flash_attention" and "bfloat16" in
                 r["case"][-1]]
    print(f"lm K11 largest bf16 error against the plain version "
          f"{max(bf16_errs):.3g} (tolerance {BF16_ATOL:.3g}); TFLOP/s "
          + ", ".join(f"{r['case'][-1].split('.')[-1]} "
                      f"{r['flops'] / r['ms'] / 1e9:.1f}"
                      for r in cases if r["kernel"] == "flash_attention"),
          flush=True)
    for c, (h, table, labels), got in zip(xent, x_in, x_out):
        t0 = time.perf_counter()
        name, T, D, V, cap, dtype = c
        bf16 = dtype == torch.bfloat16
        tol = (0.0, BF16_ATOL) if bf16 else (LM_TOL, LM_TOL)
        if tuple(got.shape) != (T,) or got.dtype != torch.float32 or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K12 {name}: {tuple(got.shape)} "
                                 f"{got.dtype}, or non-finite")
        for _ in range(2):
            if not torch.equal(got, fused_xent(h, table, labels, cap)):
                raise AssertionError(f"K12 {name}: two runs differ")

        def library():
            z = h @ table.T
            if cap is not None:
                z = cap * torch.tanh(z / cap)
            return nnf.cross_entropy(z.float(), labels, reduction="none")

        m = _measure(lambda: fused_xent(h, table, labels, cap),
                     lambda: xent_ref(h, table, labels, cap), library,
                     2.0 * T * V * D,
                     h.element_size() * float(T * D + V * D) + 12.0 * T,
                     *tol, peak=PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS,
                     got=got)
        # the largest error scale-relative to a float64 run (512 tokens at
        # a time: the float64 logits of all of them would not fit)
        want64 = torch.cat([xent_ref(h[i:i + 512].double(), table.double(),
                                     labels[i:i + 512], cap)
                            for i in range(0, T, 512)])
        m.update(network=name, kernel="fused_xent", launches=1,
                 case=(T, D, V, cap, str(dtype)), bitwise_equal_runs=3,
                 f64_err=_scaled_err(got, want64),
                 # the design's own bound: bf16 on the tensor cores, or
                 # 3xTF32 (three TF32 products per fp32 one)
                 design_bound_ms=(m["bound_ms"] if bf16 else bound_ms(
                     3 * m["flops"], m["bytes"], PEAK_TF32_FLOPS)[0]))
        del want64
        cases.append(m)
        print(f"lm K12 {name} T={T} D={D} V={V} softcap={cap} {dtype}: "
              f"{m['flops'] / 1e12:.2f} TFLOP; ms {m['ms']:.3f} "
              f"({m['flops'] / m['ms'] / 1e9:.1f} TFLOP/s), plain "
              f"{m['plain_ms']:.3f}, matmul+cross_entropy "
              f"{m['library_ms']:.3f}, bound {m['bound_ms']:.3f} "
              f"({m['bound_by']}); max |kernel - plain| "
              f"{m['max_abs_err']:.3g}, from float64 {m['f64_err']:.3g} "
              f"(scale-relative); 3 runs bitwise equal "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    del a_in, x_in, a_out, x_out
    torch.cuda.empty_cache()
    return counts, cases


def tensor_core_line(label: str, rows) -> str:
    """One tensor-core kernel (K1, K5b, K6, K10, K12) summed over the main
    path's launches: ms, TFLOP/s (direct FLOPs; where the rows know what
    the kernel executed, also the executed rate), the bound on the fp32
    peak (the bf16 one for bf16 cases) and the design's own (3xTF32: three
    TF32 products at 495 TFLOP/s; bf16 cases their bf16 bound), the library
    time and the largest error scale-relative to float64."""
    def tot(f):
        return sum(r[f] * (r["launches"] or 1) for r in rows)
    executed = ""
    if all("executed_flops" in r for r in rows):
        executed = (f"executed_TFLOP/s="
                    f"{tot('executed_flops') / tot('ms') / 1e9:.1f} "
                    f"executed/direct="
                    f"{tot('executed_flops') / tot('flops'):.3f} ")
    return (f"{label} over the main path: launches="
            f"{sum(r['launches'] for r in rows)} ms={tot('ms'):.3f} "
            f"TFLOP/s={tot('flops') / tot('ms') / 1e9:.1f} {executed}"
            f"bound_fp32_ms={tot('bound_ms'):.3f} "
            f"bound_3xtf32_ms={tot('design_bound_ms'):.3f} "
            f"library_ms={tot('library_ms'):.3f} "
            f"max_rel_err={max(r['f64_err'] for r in rows):.3g}")


def kernels_line(cases, launches) -> dict:
    """One entry per kernel: times and bound summed over the main path's
    launches (each distinct launch timed once, times its multiplicity).  A
    kernel off the path (``OFF_PATH``) shows 0 launches and the times of
    its one case."""
    out = []
    for kern, meta in KERNELS.items():
        rows = [r for r in cases if r["kernel"] == kern]
        if sum(r["launches"] for r in rows) != launches[kern]:
            raise AssertionError(f"{kern}: measured cases cover "
                                 f"{sum(r['launches'] for r in rows)} "
                                 f"launches, the main path made "
                                 f"{launches[kern]}")
        if kern in OFF_PATH:
            if launches[kern] or len(rows) != 1:
                raise AssertionError(f"{kern}: expected one case off the "
                                     f"main path, got {len(rows)} cases "
                                     f"and {launches[kern]} launches")
        elif launches[kern] == 0:
            raise AssertionError(f"{kern} was not launched on the main path")

        def total(key):
            return sum(r[key] * (r["launches"] or 1) for r in rows)

        t_ops = sum(r["flops"] * (r["launches"] or 1)
                    / r.get("peak_flops", PEAK_FP32_FLOPS) for r in rows)
        t_bytes = total("bytes") / PEAK_HBM_BYTES
        entry = {"name": kern, **meta, "launches": launches[kern],
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 "ms": total("ms"), "plain_ms": total("plain_ms"),
                 "bound_ms": total("bound_ms"),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "library_ms": total("library_ms")}
        if all("device_ms" in r for r in rows):
            # the kernels' time replayed from a CUDA graph, beside "ms", the
            # back-to-back reading that a short launch's host time sets
            entry["device_ms"] = total("device_ms")
        if all("median5" in r for r in rows):
            # back to back again: the median of 5 rounds in turns with the
            # plain version and the library call (``b2b_ms``)
            entry["median5"] = {
                k: sum(r["median5"][k] * (r["launches"] or 1) for r in rows)
                for k in rows[0]["median5"]}
        if all("design_bound_ms" in r for r in rows):
            # the bound of the kernel's own arithmetic (3xTF32: three TF32
            # products per fp32 one on the tensor cores)
            entry["bound_3xtf32_ms"] = total("design_bound_ms")
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None,
                    help="also write every measured case here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    t_start = t0 = time.perf_counter()
    ptxas = io.StringIO()
    lib = _build.build(log=ptxas)
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f}s -> {lib.relative_to(REPO)}", flush=True)

    with torch.inference_mode():
        t0 = time.perf_counter()
        cases = kernel_phase(dev)
        print(f"kernel phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        fig13 = fig13_phase(dev)
        variants = softmax_variants(dev)
        print(f"fig13 phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        th, calib = calibration_sweep(dev)
        print(f"calibration: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        launches = serving_phase(dev, th)
        print(f"serving phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        planner_counts, planner = planner_phase(dev, th)
        planner["calibration"] = calib
        for k, v in planner_counts.items():
            launches[k] += v
        print(f"planner phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        compared = stack_compare(dev, th)
        print(f"stack comparison: {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        unfused_counts, unfused = unfused_phase(dev)
        for k, v in unfused_counts.items():
            launches[k] += v
        print(f"unfused phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        t1_counts, t1_cases, table1 = conv_layer_phase(dev)
        print(f"conv-layer phase: {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        lm_counts, lm_rows = lm_phase(dev)
        print(f"LM kernel phase: {time.perf_counter() - t0:.1f}s",
              flush=True)
        for counts in (t1_counts, lm_counts):
            for k, v in counts.items():
                launches[k] += v
        cases += t1_cases + lm_rows
        for kern, label in (("conv_chwn", "K1"), ("conv_nchw", "K2"),
                            ("conv_stack_nchw", "K5b"), ("matmul", "K10"),
                            ("fused_xent", "K12")):
            print(tensor_core_line(label, [r for r in cases
                                           if r["kernel"] == kern]),
                  flush=True)
    # autograd needs tensors made outside inference mode
    t0 = time.perf_counter()
    train_counts, trained = training_phase(dev)
    for k, v in train_counts.items():
        launches[k] += v
    print(f"training phase: {time.perf_counter() - t0:.1f}s", flush=True)
    line = kernels_line(cases, launches)
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "build_s": build_s,
                                   "seconds": time.perf_counter() - t_start,
                                   "cases": cases, **line,
                                   "stack_compare": compared,
                                   "planner": planner,
                                   "unfused": unfused,
                                   "table1": table1, "fig13": fig13,
                                   "softmax_variants": variants,
                                   "training": trained,
                                   "ptxas": ptxas.getvalue()}, indent=1))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
