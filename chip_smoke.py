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
   for.  Every server of the serving, dtype and planner phases is guarded
   (a degradation ladder, no fault injected) and must end with no
   incident, nothing quarantined and every bucket served on its ladder's
   top rung.  Afterwards each batch's whole forward is timed warm (CUDA
   events) through the kernels and through the torch engine, and the
   guarded step's host time a batch around a stub forward (one image, the
   forward's output kept from a real step, nothing launched) beside its
   data path and its plan lookup alone, in turns: the step less both
   bounds the guard's own cost a batch (``guard host cost`` lines).
3b. Dtype phase, the main path at narrow storage dtypes: VGG16 b32 bf16
   stack "auto" (K1 + K5a + K4) and "off", AlexNet b128 and ResNet-18 b32
   bf16 with ``dtype_policy="mixed"`` (int8 boundaries into K1), unet_mini
   b8 bf16 (K1, its standalone pools on K3a, K4; its float32 reference the
   H100 planner's plan, none being packaged), each one
   batch through ``CNNServer(reduced=False, dtype="bf16")`` from an empty
   plan cache (a miss planned on the H100 profile), calibration
   "measured" into one threshold file the phase shares: the first server
   measures the bf16 row on K1 and K2 in bf16, the first mixed one the
   int8 row on K1 and K2 on int8 x with float32 w (their calibration
   launches counted and printed with the rows' (Ct, Nt)).  Counts zeroed
   just before each batch must equal the plan's by storage variant
   ("conv_chwn.bf16", "conv_chwn.i8bf16", ...), with no float32 launch.
   On the same seed-0 weights, bf16 uniform probabilities within 8 *
   eps(bf16) = 0.0625 of the float32 forward (the packaged plan), mixed
   ones within ``INT8_FORWARD_ATOL`` = 2e-2 of the bf16 stack="off"
   forward, both differences printed; the warm forward ms and peak device
   memory of the served plan, bf16 uniform "off" and float32 beside it.
   The kernel phase holds every distinct launch of these plans against
   its plain version on the card (bf16 within one bf16 step, 2^-7 |want|
   + 1e-5 max|want|; int8 x with float32 w at the conv tolerance; library
   the same PyTorch call in the output's dtype), and one case of each
   variant that only the calibration launches (K2 in bf16, K1 and K2 on
   int8 x with float32 w; their kernels-line launches are the
   calibration's, their times the one case's) and of K2 on int8 x with
   bf16 w (no path launches it: 0 launches).  K1's bf16, int8->bf16 and
   int8->fp32 builds and K5a's bf16 build (the bf16 tensor cores) run
   each case three times, bitwise equal; K1 int8->fp32 is also held
   within 1e-5 scale-relative of float64 and timed by graph replay beside
   cuDNN ("K1 int8→fp32 on its case (the calibration's)", with the bound
   of its design, three bf16 products a term); K5a bf16 also counts the
   FLOPs its blocks execute and the cluster they ran in, which must equal
   ``stack_tiling``'s, and prints how many of its clusters the card holds
   (``stack_max_clusters`` of the bf16 build).  The four int8 builds of
   the stacks (K5a and K5b, int8->fp32 and int8->bf16), which no plan
   launches, run one case each (``STACK_INT8_OFF_PATH``: VGG16 b32's
   conv1 pair on K5a, a ResNet-18 layer1 block on K5b), x quantized per
   channel with its scale folded into w1: int8->fp32 within 1e-5
   scale-relative of float64 and the conv tolerance of the plain version,
   int8->bf16 within one bf16 step; counted FLOPs (and K5a's cluster)
   equal to ``stack_tiling``'s, three runs bitwise equal; library cuDNN's
   two convs on the dequantized x in w's dtype.  Each int8 row also
   times its float twin on the same values (``twin_ms``: x widened
   beforehand, exactly) and says whether the two outputs are bitwise
   equal (``twin_bitwise``; K5b's must be: its int8 builds' consumers
   are the twin's).
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
4b. Resilience phase, the guarded server under faults: the reference's
   ``tools/resilience_smoke.py`` scenario on the card (lenet, mixed,
   max_bucket 8: a warm server persists its plan cache and threshold
   table, both files are corrupted, a server with
   ``kernel=0.1,nan@mixed=1.0`` at seed 0 must count two corrupt_state
   incidents, rename both aside, measure its rows again on K1 and K2 and
   serve 48 seeded requests in bursty chunks), then the same injection on
   AlexNet at 227 px (128 requests, max_bucket 128).  Each scenario: all
   answers finite, each bit-equal to ``forward_fused(impl="cuda")`` of
   the serving rung's plan on the same padded batch and within 1e-5 of
   the torch engine; ``kernel_fault`` and ``nonfinite`` equal to the
   injector's own counts; every bucket served on the ``cuda`` rung; the
   launches (counts zeroed before the run) equal to the plans of the
   rungs whose forward ran.  These launches are checked within the phase
   and not added to the kernels line.
5. Stacked against unstacked: for VGG16 and ResNet-18 at bucket 32, the
   warm whole forward at stack "auto", at "off" and through the torch
   engine, and the peak device memory of one forward at "auto" and "off"
   (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``).
5b. Mesh phase (``mesh_phase``): ``CNNServer(devices=1)`` bit-equal to
   the default server and to its plan's forward; then AlexNet b128 and
   ResNet-18 b32 served over a mesh of two shards on the one card (every
   card where there are more), answers bit-equal to the per-shard
   forwards, launches twice a shard's, ``per_chip_MB`` and img/s printed
   beside the unsharded warm forwards.
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
   step read.
7b. bf16 training phase, the main path's fifth part, outside inference
   mode: VGG16 b32 (the H100 planner's bf16 "auto" plan: all CHWN, two
   K5a stacks), ResNet-18 b32 (the plan the reference's own profile makes:
   NCHW with three K5b stacks, CHWN shortcuts whose residual gradients
   cross layouts on K9a, conv1's folded pool and the final average pool)
   and unet_mini b8 (H100 plan: standalone pools on K3a, their gradients on
   K7a), each from the seed-0 weights cast once to bf16 and a bf16 input:
   5 SGD steps of ``make_train_step_fused`` on the kernels in bf16 (K1/K2
   forward, ``save_act`` z and dgrad, K5a/K5b and the recompute, K6 on
   bf16 x and g, K7, K3, K9a, K4), counts zeroed just before each step and
   equal by variant to ``plan_train_launches`` with no float32 launch; the
   same 5 steps on the torch engine in bf16.  Every loss finite; each
   step's loss within 8 eps(bf16) of the torch engine's bf16 loss at the
   same parameters; each parameter's step-1 gradient no further from the
   float64 gradient of the same bf16 weights and input (L2) than twice the
   torch engine's bf16 one, plus 2^-5 of its norm.  Reported: the torch
   engine's trajectory, whether the loss falls, the warm step and the peak
   device memory of a step on the kernels in bf16, on the torch engine in
   bf16 and on the kernels over the same planner's float32 plan.
   The kernel phase also holds every distinct training launch:
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
   give the bare logsumexp), listed with 0 launches.  And every distinct
   bf16 training launch against its plain version in bf16: max pools, max
   pool backwards and transposes exactly, K6 within 1e-5 scale-relative of
   float64, the rest (avg pools and their backwards, K5b, ``save_act``
   z, dgrad) within one bf16 step; with K3b, K9b and K8 in bf16 off the
   path (one case each, 0 launches; K8 on bf16 logits, a float32 loss,
   rtol and atol 1e-5, labels outside [0, C) too); K5b bf16 also counts
   the FLOPs its blocks execute (equal to ``stack_tiling``'s), three runs
   bitwise equal, and reports its error against float64; a "K6 bf16 over
   the main path" line in K6's form (its bound at the bf16 peak: one bf16
   product a term).  The bf16 pools K3a and K3b, their backwards K7a and
   K7b, and K8 bf16 add their device time (graph replays) and the library
   call's beside the back-to-back readings, on each launch's line and,
   for the pools and their backwards, summed in "K3a bf16 over the main
   path", "K3b bf16 on its case (off every path)", "K7a bf16 over the
   main path" and "K7b bf16 over the main path" lines with the share of
   the byte bound the device time reaches.  K3a bf16 and K3b bf16 are
   also held and timed on every launch of the float32 K3a and K3b rows
   cast to bf16 (a line each, and "K3a bf16 on the float32 K3a row's
   shapes", "K3b bf16 on the float32 K3b row's shapes"), where bytes, not
   the host, set the time.  K4 bf16 and the bf16 transposes K9a and K9b
   do the same ("K4 bf16 over the main path", "K9a bf16 over the main
   path", "K9b bf16 on its case (off every path)"); and a "pool host_us"
   line gives the host microseconds of each step of a K3a bf16 launch
   (unet_mini's first pool) beside the wrapper's and the library call's.
7c. Unfused and mixed training (``unfused_training_phase``,
   ``mixed_training_phase``): ``make_train_step(impl="cuda")`` on AlexNet
   b128 ("cudnn") and VGG16 b32 (the packaged layouts) in fp32 and bf16,
   held as the fused steps are, launches equal to
   ``unfused_train_counts``; ``make_train_step_fused`` over AlexNet b128's
   mixed plan (``fake_quant`` at its int8 boundaries), the gates of
   ``MIXED_TRAINED``.  These phases, like the mesh's and the resilience
   phase's, check their own launches and add none to the kernels line.
7d. Runner phase, outside inference mode: ``FaultTolerantRunner`` over
   ``make_train_step_fused`` on ResNet-18 b32 fp32 (the training phase's
   plan), 6 steps, ``save_every=2``, an asynchronous ``Checkpointer``:
   uninterrupted; a ``StepFailure`` at step 3 (restored from step 2);
   step 4's manifest corrupted before a failure at step 5 (restored from
   step 2 after step 4 fails).  Both restarted runs must end with
   parameters and velocity bit-equal to the uninterrupted run; one bf16
   checkpoint of the ResNet-18 b32 bf16 step round trips bit for bit.
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
9b. LM serve phase (``lm_serve_phase``, last, outside the kernels line):
   the LM serving path ``launch/serve.Server`` on the card
   at full width, seed-0 weights: qwen2-7b whole (28 layers, 7.6 B
   parameters), gemma2-27b cut to 2 periods (4 layers; local window,
   softcaps, post-norms, tied embeddings) and whisper-base whole (its
   encoder over 1500 zero frames), in bf16, then qwen2-7b whole in
   float32 (the bf16 model freed first).  Each serves 4 seeded prompts of
   32, 48, 64 and 96 tokens, 16 new tokens each, in both KV layouts
   (float32: the layout ``select_kv_layout`` picks): every token in [0,
   V), and the logits of prefill and of each decode step held against one
   teacher-forced ``forward`` over the left-padded prompts and the
   generated tokens (bf16 within the reference's decode tolerance, atol
   0.15 / rtol 0.05; float32 within 1e-4 scale-relative), and the two
   layouts' logits against each other (the same tolerance) over the steps
   whose input tokens agree.  The path is plain torch (cuBLAS products;
   the reference's is plain jnp): no kernel of the port may launch in it.
   A line a model (beside the card's name and power limit): parameter
   GB, prefill ms and decode ms a step (CUDA events, medians of 5),
   ``Server.run``'s tokens/s on the host clock and its peak device
   memory in each layout, ``select_kv_layout``'s pick beside the layout
   whose decode step ran faster, and the largest deviation beside its
   tolerance.  Then the four recurrent and MoE architectures, each
   model freed before the next: rwkv6-7b whole (32 layers, 7.58 B
   parameters; no KV cache, so one layout), dbrx-132b cut to 2 periods
   (16 experts top-4) in bf16 and float32, llama4-maverick cut to 1
   period (128 experts top-1 and a shared expert) and jamba-1.5-large at
   ``reduced_config``'s widths (its hybrid cache list of Mamba states
   and KV caches; no full-width period fits).  An MoE model's capacity
   follows its token count, so at its published capacity factor only
   prefill is held against a forward (over the prompts alone: the same
   tokens, capacity and drops), beside the tokens' range and the two
   layouts' agreement; then at the drop-free factor E/k every step is
   held against the forward, where a bf16 step out of tolerance passes
   only at or past a token whose routing left the forward's at a router
   margin under 1e-2 (counted and printed; float32 allows none).  Last
   the full-width mixers alone in bf16: jamba's Mamba mixer (d_inner
   16384), prefill then 16 decode steps against one ``mamba_fwd``, and
   rwkv6's WKV scan against its chunk-parallel form (5e-3).
10. Prints "K1 over the main path", "K2 ...", "K5b ...", "K10 ...",
   "K12 ..." and "K5b bf16 ..." lines in the form of K6's (launches, ms,
   TFLOP/s, K2's and K5b's executed TFLOP/s and executed/direct, both
   bounds, library ms, the largest error from float64; K5b bf16's design
   bound counts one bf16 product a conv1 term and three a conv2 term),
   then one JSON line of every kernel
   (launches, error, times, bound, and the 3xTF32 bound of the tensor-core
   kernels; the storage variants as "<kernel>.<variant>", their bounds at
   the narrow element sizes and the bf16 peak where w is bf16),
   the card line, and ``{"ok": true, "device": {...}}`` last.

TF32 and bf16 reduced-precision reductions are off throughout.  Any
failure raises: the script then exits nonzero without the last line.
``--json`` also writes every measured case, and the compiler's
register/spill report, to OUT.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
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
from repro_torch.cnn.network import (batch_output_ok,  # noqa: E402
                                     forward, forward_fused,
                                     init_velocity, input_shape, loss_fn,
                                     loss_fn_fused, make_train_step,
                                     make_train_step_fused,
                                     plan_network, plan_network_fused,
                                     value_and_grad)
from repro_torch.configs import TRAIN_4K, ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.cnn_networks import CNN_CONFIGS  # noqa: E402
from repro_torch.distributed.cnn_mesh import (  # noqa: E402
    forward_fused_sharded, replicate_params, verify_shard_plan)
from repro_torch.dtypes import torch_dtype  # noqa: E402
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
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest  # noqa: E402
from repro_torch.launch.serve import Request as LMRequest  # noqa: E402
from repro_torch.launch.serve import Server as LMServer  # noqa: E402
from repro_torch.models import layers as LML  # noqa: E402
from repro_torch.models import mamba as LMM  # noqa: E402
from repro_torch.models import rwkv as LMR  # noqa: E402
from repro_torch.models import transformer as LMT  # noqa: E402
from repro_torch.models.registry import leaves_with_path  # noqa: E402
from repro_torch.perfmodel import (AnalyticCostModel,  # noqa: E402
                                   calibrate, card_conv_measure,
                                   hardware_id, reference_hardware,
                                   select_conv_layout_cost,
                                   select_kv_layout)
from repro_torch.perfmodel.calibration import (C_SWEEP,  # noqa: E402
                                               N_SWEEP, Thresholds,
                                               save_thresholds)
from repro_torch.quant import (INT8_FORWARD_ATOL,  # noqa: E402
                               dequantize, fold_scale_into_weights,
                               quantize)
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FaultTolerantRunner, StepFailure)
from repro_torch.runtime.resilience import (FaultInjector,  # noqa: E402
                                            parse_inject_spec)
from repro_torch.serve.plan_cache import (PlanCache,  # noqa: E402
                                          bucket_for, packaged_plans,
                                          pad_to_bucket)
from repro_torch.shapes import conv_out_hw, pool_out_hw  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    make_decode_step as make_lm_decode_step,
    make_prefill_step as make_lm_prefill_step)

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
# the resilience phase's fault injection (the reference's smoke's), and
# the fault-tolerant runner's steps (ResNet-18 b32 fp32)
INJECT_SPEC = "kernel=0.1,nan@mixed=1.0"
# its full-width scenario: (network, max_bucket, requests), at 227 px
RESILIENT = ("alexnet", 128, 128)
RUNNER = ("resnet18", 32)
RUNNER_STEPS = 6
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
# the dtype phase: (network, bucket, dtype policy, stack policy), each one
# full batch served in bf16 at full width from an empty plan cache (a miss
# planned on the H100 profile), its threshold rows measured on the card
# (bf16, and int8 for a mixed server) into one file the phase shares
DTYPE_SERVED = [("vgg16", 32, "uniform", "auto"),
                ("vgg16", 32, "uniform", "off"),
                ("alexnet", 128, "mixed", "auto"),
                ("resnet18", 32, "mixed", "auto"),
                ("unet_mini", 8, "uniform", "auto")]
BF16_STEP = 2.0 ** -7            # eps(bf16): one step relative to a value
BF16_PROBS_ATOL = 8 * BF16_STEP  # bf16 against fp32 probabilities
# the storage variants' (x, w) dtypes (``_build.CONV_VARIANTS``)
VARIANT_DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16),
                  "i8f32": (torch.int8, torch.float32),
                  "i8bf16": (torch.int8, torch.bfloat16)}
# Fig. 4's base layer (N 64, Ci 256, Co 384, 13 x 13, F 3): the case of
# each variant only the calibration launches (the bf16 and int8 rows time
# K2 in bf16 and K1/K2 on int8 x with fp32 w), and of K2 on int8 x with
# bf16 w, which no plan or calibration launches
CAL_CASE = {"CHWN": (64, 256, 13, 384, 3, 1, 0, None, False, None, "CHWN",
                     "CHWN"),
            "NCHW": (64, 256, 13, 384, 3, 1, 0, None, False, None, "NCHW",
                     "NCHW")}
CALIBRATION_ONLY = {"conv_nchw.bf16": CAL_CASE["NCHW"],
                    "conv_chwn.i8f32": CAL_CASE["CHWN"],
                    "conv_nchw.i8f32": CAL_CASE["NCHW"]}
# the launch the planner phase's plans never make: ResNet-18's 3x3 l3
# conv at b32 with int8 input, bf16 weights and its residual
DTYPE_OFF_PATH = {"conv_nchw.i8bf16": (32, 256, 14, 256, 3, 1, 1, None,
                                       True, "NCHW", "NCHW", "NCHW")}
# the LM kernel phase: whisper-base's encoder attention over a batch of 8
# clips; gemma2-27b's head over a quarter of one train_4k sequence (its
# plain version materializes [T, 256000] fp32 logits: 1 GB at T 1024)
WHISPER_CLIPS = 8
GEMMA_TOKENS = TRAIN_4K.seq_len // 4
# the LM serving phase: (arch, periods kept, None for all or LM_REDUCED for
# reduced_config's widths, dtype or None for the config's bf16, how the
# served steps are held against the teacher-forced forward: LM_WHOLE, the
# whole model's logits, or LM_BLOCKS, each block alone, fed the forward's
# input to it, then the head), batch 4 of these prompt lengths, 16 new
# tokens.  What one 80 GB card holds at full width: gemma2 and dbrx 2
# periods, llama4 one (128 experts); no full-width period of jamba fits
# (45.2 B parameters a period).  rwkv6-7b whole is held block by block: at
# random init its 32 layers amplify a rounding ~2x a layer, so far that
# its forward of one row alone lies 16.4 times the bf16 decode tolerance
# from the batch's; at LM_RWKV_CUT periods its whole model is held
LM_GEMMA_PERIODS = 2
LM_DBRX_PERIODS = 2
LM_RWKV_CUT = 2
LM_LLAMA4_PERIODS = 1
LM_REDUCED = "reduced"
LM_WHOLE, LM_BLOCKS = "whole model", "block by block"
LM_SERVED = (("qwen2_7b", None, None, LM_WHOLE),
             ("gemma2_27b", LM_GEMMA_PERIODS, None, LM_WHOLE),
             ("whisper_base", None, None, LM_WHOLE),
             ("qwen2_7b", None, "float32", LM_WHOLE),
             ("rwkv6_7b", None, None, LM_BLOCKS),
             ("rwkv6_7b", None, "float32", LM_BLOCKS),
             ("rwkv6_7b", LM_RWKV_CUT, None, LM_WHOLE),
             ("rwkv6_7b", LM_RWKV_CUT, "float32", LM_WHOLE),
             ("dbrx_132b", LM_DBRX_PERIODS, None, LM_WHOLE),
             ("dbrx_132b", LM_DBRX_PERIODS, "float32", LM_WHOLE),
             ("llama4_maverick_400b", LM_LLAMA4_PERIODS, None, LM_WHOLE),
             ("jamba_1p5_large_398b", LM_REDUCED, None, LM_WHOLE))
# a bf16 step's MoE layer, dispatching as the forward did, would have
# chosen other experts only where the forward's k-th and (k+1)-th router
# probabilities lie within this (decode and forward round bf16 hidden
# states differently)
LM_ROUTE_MARGIN = 1e-2
# the full-width mixers alone: the WKV scan against its chunk-parallel
# form within the reference's own tolerance (tests/test_perf_features.py)
LM_WKV_TOL = 5e-3
LM_WKV_CHUNK = 16
LM_PROMPTS = (32, 48, 64, 96)
LM_MAX_NEW = 16
LM_MAX_LEN = 256
LM_SEED = 0
# (rtol, atol): the reference's decode-vs-forward tolerance
# (tests/test_models.py:105-113); float32 scale-relative
LM_DECODE_TOL = (0.05, 0.15)
LM_F32_TOL = 1e-4

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
# the storage variants of the serving and training paths' kernels
# (``_build.VARIANTS``): the same sources, built again for bf16 and int8
# input
for _base, _variants in (("conv_chwn", ("bf16", "i8bf16", "i8f32")),
                         ("conv_nchw", ("bf16", "i8f32", "i8bf16")),
                         ("conv_stack_chwn", ("bf16", "i8f32", "i8bf16")),
                         ("conv_stack_nchw", ("bf16", "i8f32", "i8bf16")),
                         ("softmax", ("bf16",)), ("softmax_xent", ("bf16",)),
                         ("pool_chwn", ("bf16",)),
                         ("pool_nchw", ("bf16",)), ("wgrad", ("bf16",)),
                         ("pool_backward_chwn", ("bf16",)),
                         ("pool_backward_nchw", ("bf16",)),
                         ("transpose2d", ("bf16",)),
                         ("transpose2d_batched", ("bf16",))):
    for _v in _variants:
        KERNELS[f"{_base}.{_v}"] = KERNELS[_base]
# the bf16 training phase: (network, batch, the profile its bf16 "auto"
# plan is priced on: the port's H100 one, or the reference's own, under
# which ResNet-18 plans NCHW with K5b stacks and CHWN shortcuts), each
# BF16_TRAIN_STEPS SGD steps from the seed-0 weights cast once to bf16
BF16_TRAINED = [("vgg16", 32, "h100"), ("resnet18", 32, "reference"),
                ("unet_mini", 8, "h100")]
BF16_TRAIN_STEPS = 5
# its gates (PERF.md §2): each step's loss within 8 eps(bf16) of the torch
# engine's bf16 loss at the same parameters; each parameter's step-1
# gradient no further from the float64 gradient of the same bf16 weights
# and input, in the L2 norm, than BF16_GRAD_FACTOR times the torch
# engine's bf16 gradient is, plus BF16_GRAD_SLACK of the float64 norm
# (``_bf16_step1_gradients`` says why the bound is relative)
BF16_LOSS_TOL = 8 * 2.0 ** -8
BF16_GRAD_FACTOR, BF16_GRAD_SLACK = 2.0, 2.0 ** -5
# the bf16 kernels no path of this script launches, with their one case:
# K3b (no bf16 plan pools NCHW on its own: unet_mini's pools are CHWN) on
# unet_mini's first pool in NCHW, K9b on the fp32 K9b case, K8 on the fp32
# K8 case
BF16_OFF_PATH = {"pool_nchw.bf16": ((8, 32, 32, 32), 2, 2, "max"),
                 "transpose2d_batched.bf16": K9B_CASE,
                 "softmax_xent.bf16": K8_CASE}
# int8 x into the stacks (K5a and K5b, int8->fp32 and int8->bf16): no plan
# makes one (the executor folds no scale into a stack, as the reference's
# does not), so each build is held on one case off every path: VGG16 b32's
# conv1 pair with its pool on K5a, a ResNet-18 layer1 block (64 -> 64 ->
# 64 at 56 x 56, its residual) on K5b; x quantized per channel, the scale
# folded into w1
VGG16_CONV1_PAIR = (32, 3, 224, 64, 64, 3, 1, 1, 3, 1, 1, (2, 2, "max"),
                    True, True, None, "CHWN", "CHWN")
RESNET18_BLOCK = (32, 64, 56, 64, 64, 3, 1, 1, 3, 1, 1, None, True, True,
                  "NCHW", "NCHW", "NCHW")
STACK_INT8_OFF_PATH = {
    f"{kern}.{v}": case
    for kern, case in (("conv_stack_chwn", VGG16_CONV1_PAIR),
                       ("conv_stack_nchw", RESNET18_BLOCK))
    for v in ("i8f32", "i8bf16")}
# kernels held in the kernel phase that no path of this script launches,
# with their one case
OFF_PATH = {"transpose2d_batched": K9B_CASE, "softmax_xent": K8_CASE,
            **DTYPE_OFF_PATH, **BF16_OFF_PATH, **STACK_INT8_OFF_PATH}
# the unfused training step (``make_train_step``, autodiff of the unfused
# forward): (network, batch, layouts: a mode of ``plan_network``, or
# "packaged", the reference's TPU-priced assignment, whose CHWN and NCHW
# runs re-lay out on K9a both ways), each in float32 and bf16
UNFUSED_TRAINED = [("alexnet", 128, "cudnn"), ("vgg16", 32, "packaged")]
# the mixed-dtype training step: AlexNet b128's float32 "mixed" plan on
# the H100 profile (int8 boundaries, fake_quant on the float carrier),
# MIXED_TRAIN_STEPS steps.  Its gates are the reference's
# tests/test_mixed_dtype.py ones: the loss falls over the steps, stays
# finite and the parameters float32 (test_int8_train_step_differentiable),
# and the mixed forward's probabilities within INT8_FORWARD_ATOL = 2e-2 of
# the uniform float32 forward's (test_int8_fused_forward_matches_fp32);
# and each loss within that tolerance of the torch engine's over the same
# plan at the same parameters: a conv output within rounding of a
# quantization boundary lands one int8 level apart in two float32
# evaluations (K1's 3xTF32 order and cuDNN's), which moved the loss by up
# to 9.4e-5 a step on the card, at the fp32 steps' LOSS_ATOL
MIXED_TRAINED = ("alexnet", 128)
MIXED_TRAIN_STEPS = 5
# the serving mesh: a rehearsal of two shards on the one card (all the
# cards where there are more), each network's global batch split in two
# shard buckets
MESHED = [("alexnet", 128), ("resnet18", 32)]
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
    folded residual's layout (None without one).  A narrow plan's launches
    name their storage variant, "<kernel>.<variant>": "bf16", or "i8bf16"
    for a conv whose input is an int8 boundary (``launch_variant``)."""
    bucket = cfg.batch
    shapes, rins = layer_shapes(cfg), resolved_cfg_inputs(cfg)
    held = {-1: "NCHW"}
    prev, out = -1, []

    def shape_of(p):
        return input_shape(cfg) if p < 0 else shapes[p]

    def relayout(p, cur, lay):
        if cur != lay:
            stored = tuple(shape_of(p)["NCHW".index(d)] for d in cur)
            out.append(("transpose2d" + float_variant(plan),
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
                        else "conv_stack_nchw") + launch_variant(plan, op)
                out.append((kern, (bucket, ci, h, spec.out_channels,
                                   spec2.out_channels, spec.kernel,
                                   spec.stride, spec.pad, spec2.kernel,
                                   spec2.stride, spec2.pad, pool,
                                   op.stack_relu, op.relu, res,
                                   op.src_layout, op.dst_layout)))
            else:
                kern = ("conv_chwn" if op.layout == "CHWN"
                        else "conv_nchw") + launch_variant(plan, op)
                out.append((kern, (bucket, ci, h, spec.out_channels,
                                   spec.kernel, spec.stride, spec.pad, pool,
                                   op.relu, res, op.src_layout,
                                   op.dst_layout)))
            cur = op.dst_layout
        elif op.kind == "pool":
            spec = cfg.layers[op.index]
            relayout(p, cur, op.layout)
            kern = "pool_chwn" if op.layout == "CHWN" else "pool_nchw"
            out.append((kern + float_variant(plan),
                        (tuple(shape_of(p)), spec.kernel, spec.stride,
                         spec.pool_op)))
            cur = op.dst_layout
        elif op.kind in ("add", "concat", "upsample"):
            for q in (op.inputs or (p,)):
                relayout(q, held[q], op.layout)
            cur = op.layout
        elif op.kind == "softmax":
            out.append(("softmax" + launch_variant(plan, op),
                        (bucket, cfg.num_classes)))
        prev = op.out_index if op.out_index >= 0 else op.index
        held[prev] = cur
    return out


def float_variant(plan) -> str:
    """The storage variant suffix of a float kernel's launch (pool, pool
    backward, transpose, weight gradient, stack, softmax) under ``plan``:
    "" at float32, ".bf16" at bf16."""
    return {"float32": "", "bfloat16": ".bf16"}[plan.base_dtype or "float32"]


def launch_variant(plan, op) -> str:
    """The storage variant suffix of ``op``'s launch under ``plan``: "" at
    float32, ".bf16" at bf16, ".i8bf16" (".i8f32" at a float32 base) for a
    conv that takes an int8 boundary."""
    base = {"float32": "", "bfloat16": "bf16"}[plan.base_dtype or "float32"]
    if op.kind == "conv" and op.src_dtype == "int8":
        return ".i8" + (base or "f32")
    return "." + base if base else ""


def unfused_launches(network: str, batch: int, mode: str):
    """(layouts, [(kernel, case)]) of the unfused ``forward`` of
    ``network`` at ``batch`` in ``mode``, in layer order
    (``layout_launches``)."""
    cfg = CNN_CONFIGS[network].replace(batch=batch)
    layouts = plan_network(cfg, mode)
    return layouts, layout_launches(cfg, layouts)


def layout_launches(cfg, layouts):
    """[(kernel, case)] of the unfused ``forward`` of ``cfg`` in the
    per-layer ``layouts``, in layer order: what the layouts call for,
    worked out from the config alone.  A re-layout (before a conv or pool
    whose layout differs from its input's, never after flatten) is one
    K9a launch on the collapsed 2-D matrix."""
    network, batch = cfg.name, cfg.batch
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
    return out


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
    stack="auto" plan of ``network`` at ``batch`` (``plan_train_launches``)."""
    cfg = CNN_CONFIGS[network].replace(batch=batch)
    plan = PlanCache(str(packaged_plans(network))).peek_fused(
        cfg, batch, stack="auto")
    return plan_train_launches(cfg, plan)


def plan_train_launches(cfg, plan):
    """(kernel, case) for every kernel launch of one training step
    (``make_train_step_fused``, impl="cuda") over ``plan`` on ``cfg``: what
    the plan calls for, worked out from it alone.  A conv op launches its
    forward (with ``save_act`` where it pools), then in the backward K7
    where it pools, dgrad on its engine's kernel (not for the network
    input, which needs no gradient), K6, and a K9a re-layout where a folded
    residual's layout differs from the gradient's.  A stack op launches K5,
    then recomputes conv1 (and conv2 with ``save_act`` where it pools) and
    runs both convs' backwards.  A standalone pool launches K3 and, in the
    backward, K7 (g in the pool's output layout, no ReLU mask); a
    re-layout no kernel absorbed (before a pool, at a merge) one K9a each
    way.  The softmax is K4 forward; its gradient is plain arithmetic.  A
    bf16 plan's launches name their variant, "<kernel>.bf16"."""
    batch, v = cfg.batch, float_variant(plan)
    shapes, rins = layer_shapes(cfg), resolved_cfg_inputs(cfg)
    held = {-1: "NCHW"}
    out, prev_key = [], -1

    def shape_of(p):
        return input_shape(cfg) if p < 0 else shapes[p]

    def relayout(p, cur, lay):   # forward and backward, both on K9a
        if cur != lay:
            stored = tuple(shape_of(p)["NCHW".index(d)] for d in cur)
            back = tuple(shape_of(p)["NCHW".index(d)] for d in lay)
            out.append(("transpose2d" + v,
                        plan_transform(cur, lay).collapsed_shape(stored)))
            out.append(("transpose2d" + v,
                        plan_transform(lay, cur).collapsed_shape(back)))

    def conv_backward(N, ci, h, co, F, S, pad, E, pool, relu, res, src,
                      dst, needs_dx, save_act):
        return [(k + v, c) for k, c in _conv_backward_launches(
            N, ci, h, co, F, S, pad, E, pool, relu, res, src, dst, needs_dx,
            save_act)]

    for op in plan.ops:
        p = op.inputs[0] if op.inputs else prev_key
        needs_dx = p != -1
        cur = held[p]
        prev_key = op.out_index if op.out_index >= 0 else op.index
        spec = cfg.layers[op.index]
        if op.kind == "pool":
            relayout(p, cur, op.layout)
            n, c, h, _ = shape_of(p)
            src = "pool_chwn" if op.layout == "CHWN" else "pool_nchw"
            out.append((src + v, (tuple(shape_of(p)), spec.kernel,
                                  spec.stride, spec.pool_op)))
            out.append((("pool_backward_chwn" if op.layout == "CHWN"
                         else "pool_backward_nchw") + v,
                        (n, c, h, spec.kernel, spec.stride, spec.pool_op,
                         op.dst_layout, False)))
            held[prev_key] = op.dst_layout
            continue
        if op.kind in ("add", "concat", "upsample"):
            for q in (op.inputs or (p,)):
                relayout(q, held[q], op.layout)
            held[prev_key] = op.layout
            continue
        if op.kind == "softmax":
            out.append(("softmax" + v, (batch, cfg.num_classes)))
        if op.kind != "conv":
            held[prev_key] = cur
            continue
        _, ci, h, _ = shape_of(rins[op.index][0])
        pool = None
        if op.pool_index is not None:
            ps = cfg.layers[op.pool_index]
            pool = (ps.kernel, ps.stride, ps.pool_op)
        res = op.res_layout if op.res_index is not None else None
        E = op.layout
        held[prev_key] = op.dst_layout
        if op.stack_index is None:
            if pool is None:
                out.append((_engine_kernel(E) + v, (
                    batch, ci, h, spec.out_channels, spec.kernel,
                    spec.stride, spec.pad, None, op.relu, res,
                    op.src_layout, op.dst_layout)))
            out += conv_backward(
                batch, ci, h, spec.out_channels, spec.kernel, spec.stride,
                spec.pad, E, pool, op.relu, res, op.src_layout,
                op.dst_layout, needs_dx, save_act=pool is not None)
            continue
        spec2 = cfg.layers[op.stack_index]
        cm = spec.out_channels
        h1 = conv_out_hw(h, spec.kernel, spec.stride, spec.pad)
        out.append((("conv_stack_chwn" if E == "CHWN" else "conv_stack_nchw")
                    + v, (batch, ci, h, cm, spec2.out_channels, spec.kernel,
                          spec.stride, spec.pad, spec2.kernel, spec2.stride,
                          spec2.pad, pool, op.stack_relu, op.relu, res,
                          op.src_layout, op.dst_layout)))
        # the backward: recompute y1, then conv2's and conv1's backwards
        out.append((_engine_kernel(E) + v, (batch, ci, h, cm, spec.kernel,
                                            spec.stride, spec.pad, None,
                                            op.stack_relu, None,
                                            op.src_layout, E)))
        out += conv_backward(
            batch, cm, h1, spec2.out_channels, spec2.kernel, spec2.stride,
            spec2.pad, E, pool, op.relu, res, E, op.dst_layout, True,
            save_act=pool is not None)
        out += conv_backward(
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
             peak: float = PEAK_FP32_FLOPS, got=None, check=None) -> dict:
    """Hold ``kernel()`` (or ``got``, its output from the main path)
    against ``plain()`` (rtol/atol, or ``check(got, want)``), then time the
    kernel, the plain version and the library call; the bound is on
    ``peak``."""
    got = kernel() if got is None else got
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    if check is None:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    else:
        check(got, want)
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


def bf16_check(got, want) -> None:
    """A bf16 output against its plain version: both accumulate in
    float32 and round once, so within one bf16 step, |got - want| <=
    2^-7 |want| + 1e-5 max|want| (NaN where the plain version has it)."""
    got, want = got.double(), want.double()
    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        raise AssertionError("bf16: NaN where the plain version has none, "
                             "or the other way")
    got, want = got[~nan], want[~nan]
    bound = BF16_STEP * want.abs() + 1e-5 * want.abs().max()
    over = ((got - want).abs() - bound).max().item()
    if over > 0:
        raise AssertionError(f"bf16: {over:.3g} past one bf16 step")


def conv_check(got, want) -> None:
    """A float32 conv or stack output (int8 x with float32 w) against its
    plain version at the conv tolerance."""
    torch.testing.assert_close(got, want, rtol=CONV_RTOL, atol=CONV_ATOL)


def exact_check(got, want) -> None:
    """A bf16 max pool, max pool backward or transpose against its plain
    version: bit for bit (a max is exact; each dx element sums its
    windows' shares in float32 in the same order and rounds once)."""
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0,
                               equal_nan=True)


def dtype_case(kern: str, case, dev, seed: int) -> dict:
    """One launch of a storage variant ("<kernel>.<variant>") against its
    plain version on the same card inputs: bf16 (or int8 x with bf16 w)
    within one bf16 step (``bf16_check``), except max pools, max pool
    backwards and transposes, exactly, and K6, within ``WGRAD_TOL``
    scale-relative of float64 (a product of two bf16 values is exact);
    int8 x with float32 w at the conv tolerance.  Library: the same
    PyTorch call in the output's dtype (cuDNN ``conv2d`` [+ its epilogue],
    twice for a stack; ``conv2d_input`` for dgrad, ``conv2d_weight`` for
    K6; the pools and their aten backwards times the ReLU mask;
    ``permute().contiguous()``; ``torch.softmax``), an int8 x cast to it
    beforehand, untimed.  The bound takes each tensor at its element size
    and the operations at the peak of the inputs' type (bf16 on the tensor
    cores where w is bf16, fp32 where it is float32)."""
    base, variant = kern.split(".")
    xdt, wdt = VARIANT_DTYPES[variant]
    gen = torch.Generator(device=dev).manual_seed(seed)
    peak = PEAK_BF16_FLOPS if wdt is torch.bfloat16 else PEAK_FP32_FLOPS
    check = bf16_check if wdt is torch.bfloat16 else None

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(wdt)

    def nbytes(*ts):
        return float(sum(t.numel() * t.element_size() for t in ts))

    if base in POOL_KERNELS:
        (N, C, H, W), F, S, op = case
        src, wrapper = POOL_KERNELS[base]
        x_nchw = rand(N, C, H, W)
        x = x_nchw.permute(perm_between("NCHW", src)).contiguous()
        Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
        pool_fn = nnf.max_pool2d if op == "max" else nnf.avg_pool2d

        def kernel():
            return wrapper(x, F, S, op)

        def library():
            return pool_fn(x_nchw, F, S)

        m = _measure(kernel, lambda: pool_ref(x, F, S, op, src, src),
                     library, float(F * F * N * C * Ho * Wo),
                     nbytes(x) * (1 + 1 / (S * S)), peak=peak,
                     check=exact_check if op == "max" else check)
        # K3a and K3b bf16: the card's share, not the host's
        m.update(device_ms=device_ms(kernel),
                 library_device_ms=device_ms(library))
        return m
    if base in POOL_BWD_KERNELS:
        N, C, H, F, S, op, g_lay, relu = case
        layout, wrapper = POOL_BWD_KERNELS[base]
        Ho = pool_out_hw(H, F, S)
        z_nchw, g_nchw = rand(N, C, H, H), rand(N, C, Ho, Ho)
        z = z_nchw.permute(perm_between("NCHW", layout)).contiguous()
        g = g_nchw.permute(perm_between("NCHW", g_lay)).contiguous()
        library = _pool_bwd_library(z_nchw, g_nchw, F, S, op, relu)

        def kernel():
            return wrapper(z, g, F, S, op, g_layout=g_lay, relu_mask=relu)

        m = _measure(
            kernel,
            lambda: pool_backward_ref(z, g, F, S, op, layout, g_lay, relu),
            library, float(N * C * H * H * (-(-F // S)) ** 2
                           * (F * F if op == "max" else 1)),
            2 * nbytes(z) + nbytes(g), peak=peak,
            check=exact_check if op == "max" else check)
        # K7a and K7b bf16, as the pools
        m.update(device_ms=device_ms(kernel),
                 library_device_ms=device_ms(library))
        return m
    if base in TRANSPOSE_KERNELS:
        wrapper, ref = TRANSPOSE_KERNELS[base]
        x = rand(*case)
        perm = (1, 0) if len(case) == 2 else (0, 2, 1)

        def library():
            return x.permute(perm).contiguous()

        m = _measure(lambda: wrapper(x), lambda: ref(x), library, 0.0,
                     2 * nbytes(x), peak=peak, check=exact_check)
        # K9a and K9b bf16: the card's share, not the host's
        m.update(device_ms=device_ms(lambda: wrapper(x)),
                 library_device_ms=device_ms(library))
        return m
    if base == "wgrad":
        return wgrad_case(case, dev, seed, dtype=wdt)
    if base == "softmax_xent":
        # K8 on bf16 logits: a float32 loss, held as the float32 K8 (rtol
        # and atol 1e-5), labels outside [0, C) too; its operations run on
        # the CUDA cores in float32
        rows, cols = case
        x = rand(rows, cols, scale=4.0)
        labels = torch.randint(0, cols, (rows,), device=dev, generator=gen)
        outside = labels.clone()
        outside[::3], outside[1::3] = -1, cols
        torch.testing.assert_close(softmax_xent(x, outside),
                                   softmax_xent_ref(x, outside), rtol=1e-5,
                                   atol=1e-5)

        def kernel():
            return softmax_xent(x, labels)

        def library():
            return nnf.cross_entropy(x, labels, reduction="none")

        m = _measure(kernel, lambda: softmax_xent_ref(x, labels), library,
                     3.0 * rows * cols, nbytes(x) + 12.0 * rows, rtol=1e-5,
                     atol=1e-5)
        m.update(device_ms=device_ms(kernel),
                 library_device_ms=device_ms(library))
        return m
    if base == "softmax":
        rows, cols = case
        x = rand(rows, cols, scale=4.0)
        m = _measure(lambda: softmax(x), lambda: softmax_ref(x),
                     lambda: torch.softmax(x, dim=-1), 5.0 * rows * cols,
                     2.0 * nbytes(x), peak=peak, check=check)
        m.update(device_ms=device_ms(lambda: softmax(x)),
                 library_device_ms=device_ms(
                     lambda: torch.softmax(x, dim=-1)))
        return m
    if base in STACK_KERNELS:
        (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, relu2, rlay,
         src, dst) = case
        engine, wrapper = STACK_KERNELS[base]
        Ho1 = conv_out_hw(H, F1, S1, P1)
        Ho2 = conv_out_hw(Ho1, F2, S2, P2)
        if xdt is torch.int8:
            # x quantized per channel, its scale folded into w1; the
            # library runs on the dequantized x and the unfolded w1
            q, scale = quantize(torch.randn(N, Ci, H, H, device=dev,
                                            generator=gen), 1)
            w1_lib = torch.randn(Cm, Ci, F1, F1, device=dev, generator=gen) \
                / math.sqrt(Ci * F1 * F1)
            w1 = fold_scale_into_weights(w1_lib, scale).to(wdt)
            w1_lib = w1_lib.to(wdt)
            x_nchw, x_lib = q, dequantize(q, scale, 1, wdt)
        else:
            x_nchw = x_lib = rand(N, Ci, H, H)
            w1 = w1_lib = rand(Cm, Ci, F1, F1,
                               scale=1 / math.sqrt(Ci * F1 * F1))
        w2 = rand(Co, Cm, F2, F2, scale=1 / math.sqrt(Cm * F2 * F2))
        r_nchw = rand(N, Co, Ho2, Ho2) if rlay else None
        x = x_nchw.permute(perm_between("NCHW", src)).contiguous()
        r = (r_nchw.permute(perm_between("NCHW", rlay)).contiguous()
             if rlay else None)
        kw = dict(relu1=relu1, relu2=relu2, pool=pool, res=r,
                  res_layout=rlay or engine, src_layout=src, dst_layout=dst)
        w1k, w2k = ((w1.permute(1, 2, 3, 0).contiguous(),
                     w2.permute(1, 2, 3, 0).contiguous())
                    if engine == "CHWN" else (w1, w2))

        def library():
            y = nnf.conv2d(x_lib, w1_lib, stride=S1, padding=P1)
            if relu1:
                y = torch.relu_(y)
            return _library_epilogue(nnf.conv2d(y, w2, stride=S2,
                                                padding=P2),
                                     r_nchw, relu2, pool)

        flops = 2.0 * N * (Cm * Ho1 * Ho1 * Ci * F1 * F1
                           + Co * Ho2 * Ho2 * Cm * F2 * F2)
        out_hw = Ho2 if pool is None else (Ho2 - pool[0]) // pool[1] + 1
        y_bytes = N * Co * out_hw * out_hw * w1.element_size()
        m = _measure(lambda: wrapper(x, w1k, w2k, S1, P1, S2, P2, **kw),
                     lambda: conv_stack_ref(x, w1, w2, S1, P1, S2, P2,
                                            **kw),
                     library, flops,
                     nbytes(x, w1, w2, *([r] if rlay else [])) + y_bytes,
                     peak=peak, check=check)
        t = stack_tiling(engine, N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2, P2,
                         pool)
        m.update(executed_flops=float(t.executed_flops), cluster=t.cluster)
        if check is None:   # int8->fp32: the plain version's tolerance
            check = conv_check
        k64 = {**kw, "res": r.double() if rlay else None}
        conv1 = 2.0 * N * Cm * Ho1 * Ho1 * Ci * F1 * F1
        if engine == "CHWN":
            # K5a bf16 and int8 count what their blocks execute and the
            # cluster they ran in, as the float32 build does; its runs are
            # bitwise equal
            y, counted, cluster = conv_stack_chwn_counted(
                x, w1k, w2k, S1, P1, S2, P2, **kw)
            check(y, conv_stack_ref(x, w1, w2, S1, P1, S2, P2, **kw))
            if counted != t.executed_flops or cluster != t.cluster:
                raise AssertionError(
                    f"{kern} {case}: the kernel executed {counted} FLOPs in "
                    f"clusters of {cluster}; stack_tiling says "
                    f"{t.executed_flops} in clusters of {t.cluster}")
            bitwise_runs(lambda: wrapper(x, w1k, w2k, S1, P1, S2, P2, **kw),
                         f"{kern} {case}", first=y)
            m.update(counted_flops=float(counted), counted_cluster=cluster,
                     bitwise_equal_runs=3,
                     resident_clusters=stack_max_clusters(
                         N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2, P2, pool,
                         t, dtype=xdt, w_dtype=wdt))
            if variant == "i8f32":
                # K1 int8->fp32's gate against float64
                _fp32_gate(m, [(y, conv_stack_ref(
                    x, w1.double(), w2.double(), S1, P1, S2, P2, **k64))],
                    f"{kern} {case}")
                # its design's bound: three bf16 products a conv1 term (w1
                # in three parts, x exact), three TF32 ones a conv2 term
                m.update(design_bound_ms=max(
                    1e3 * (3 * conv1 / PEAK_BF16_FLOPS
                           + 3 * (flops - conv1) / PEAK_TF32_FLOPS),
                    bound_ms(0.0, m["bytes"])[0]), design="split3_3xtf32")
        else:
            # K5b bf16 and int8 count the FLOPs their blocks execute as
            # the float32 build does; its runs are bitwise equal; its error
            # against float64 of the same values is reported (the gate is
            # one bf16 step of the plain version, above; int8->fp32 is held
            # within 1e-5 scale-relative of float64, as K1 int8->fp32)
            y, counted = conv_stack_nchw_counted(x, w1k, w2k, S1, P1, S2,
                                                 P2, **kw)
            check(y, conv_stack_ref(x, w1, w2, S1, P1, S2, P2, **kw))
            if counted != t.executed_flops:
                raise AssertionError(
                    f"{kern} {case}: the kernel executed {counted} FLOPs; "
                    f"stack_tiling says {t.executed_flops}")
            bitwise_runs(lambda: wrapper(x, w1k, w2k, S1, P1, S2, P2, **kw),
                         f"{kern} {case}", first=y)
            y64 = conv_stack_ref(x, w1.double(), w2.double(), S1, P1, S2,
                                 P2, **k64)
            m.update(counted_flops=float(counted), bitwise_equal_runs=3)
            if variant == "i8f32":   # 3xTF32, x exact: two a conv1 term
                _fp32_gate(m, [(y, y64)], f"{kern} {case}")
                m.update(design_bound_ms=bound_ms(
                    2 * conv1 + 3 * (flops - conv1), m["bytes"],
                    PEAK_TF32_FLOPS)[0], design="3xtf32")
            else:
                m.update(f64_err=_scaled_err(y, y64),
                         # the design's own bound: one bf16 product a conv1
                         # term, three a conv2 term (the float32 mid in
                         # three bf16 parts)
                         design_bound_ms=bound_ms(
                             conv1 + 3 * (flops - conv1), m["bytes"],
                             PEAK_BF16_FLOPS)[0],
                         design="bf16_split3")
        if variant in ("i8bf16", "i8f32"):
            # the float twin on the same values (x widened beforehand,
            # exactly, to w's dtype): what the int8 build's copy path costs
            # beside the twin's; K5b's int8 builds run the twin's consumers
            # (int8->fp32 without x's small-part product, which is zero),
            # so their output is the twin's bit for bit
            x_twin = x.to(wdt)

            def twin():
                return wrapper(x_twin, w1k, w2k, S1, P1, S2, P2, **kw)

            y_twin = twin()
            m.update(twin_ms=cuda_ms(twin),
                     twin_bitwise=bool(torch.equal(y_twin, y)))
            if engine == "NCHW":
                exact_check(y, y_twin)
        return m
    engine = "CHWN" if base == "conv_chwn" else "NCHW"
    if case[0] == "dgrad":
        N, Ci, H, Co, F, S, pad, g_lay, dst = case[1:]
        Ho = conv_out_hw(H, F, S, pad)
        g_nchw = rand(N, Co, Ho, Ho)
        w = rand(Co, Ci, F, F, scale=1 / math.sqrt(Ci * F * F))
        g = g_nchw.permute(perm_between("NCHW", g_lay)).contiguous()
        gd, wt, pd = dgrad_problem(g, w, (H, H), S, pad, g_lay)
        wk = wt.permute(1, 2, 3, 0).contiguous() if engine == "CHWN" else wt
        kw = dict(src_layout=g_lay, dst_layout=dst)
        m = _measure(
            lambda: _conv(engine, gd, wk, 1, pd, **kw),
            lambda: conv_ref(gd, wt, 1, pd, **kw),
            lambda: torch.nn.grad.conv2d_input((N, Ci, H, H), w, g_nchw,
                                               stride=S, padding=pad),
            2.0 * N * Co * Ho * Ho * Ci * F * F,
            nbytes(g, w) + N * Ci * H * H * w.element_size(), peak=peak,
            check=check)
        if base == "conv_nchw":
            _k2_narrow(m, kern, case, gd, wt, 1, pd, kw, check,
                       lambda: _conv(engine, gd, wk, 1, pd, **kw))
        return m
    save_act = case[0] == "save_act"
    N, Ci, H, Co, F, S, pad, pool, relu, rlay, src, dst = case[save_act:]
    Ho = conv_out_hw(H, F, S, pad)
    if xdt is torch.int8:   # quantized levels; the scale rides w
        x_nchw = torch.randint(-127, 128, (N, Ci, H, H), device=dev,
                               generator=gen, dtype=torch.int8)
        w = rand(Co, Ci, F, F, scale=1 / (127 * math.sqrt(Ci * F * F)))
    else:
        x_nchw = rand(N, Ci, H, H)
        w = rand(Co, Ci, F, F, scale=1 / math.sqrt(Ci * F * F))
    r_nchw = rand(N, Co, Ho, Ho) if rlay else None
    x = x_nchw.permute(perm_between("NCHW", src)).contiguous()
    r = (r_nchw.permute(perm_between("NCHW", rlay)).contiguous()
         if rlay else None)
    kw = dict(relu=relu, pool=pool, res=r, res_layout=rlay or engine,
              src_layout=src, dst_layout=dst)
    wk = w.permute(1, 2, 3, 0).contiguous() if engine == "CHWN" else w
    if save_act:   # the training forward: z held, y checked beside
        y, _ = _conv(engine, x, wk, S, pad, save_act=True, **kw)
        check(y, conv_ref(x, w, S, pad, **kw))

        def kernel():
            return _conv(engine, x, wk, S, pad, save_act=True, **kw)[1]

        def plain():
            return conv_ref(x, w, S, pad, save_act=True, act_layout=engine,
                            **kw)[1]
    else:
        def kernel():
            return _conv(engine, x, wk, S, pad, **kw)

        def plain():
            return conv_ref(x, w, S, pad, **kw)

    x_lib = x_nchw.to(wdt)

    def library():
        return _library_epilogue(nnf.conv2d(x_lib, w, stride=S, padding=pad),
                                 r_nchw, relu, pool)

    out_hw = Ho if pool is None else (Ho - pool[0]) // pool[1] + 1
    y_bytes = N * Co * (out_hw * out_hw + (Ho * Ho if save_act else 0)) \
        * w.element_size()
    m = _measure(kernel, plain, library,
                 2.0 * N * Co * Ho * Ho * Ci * F * F,
                 nbytes(x, w, *([r] if rlay else [])) + y_bytes, peak=peak,
                 check=check)
    if base == "conv_chwn":
        _k1_tile(m, case, N, Ci, H, Co, F, S, pad, pool)
        # the narrow and int8->fp32 builds' runs: bitwise equal
        bitwise_runs(kernel, f"{kern} {case}")
        m["bitwise_equal_runs"] = 3
        if variant == "i8f32" and not save_act:
            # fp32 accuracy from three bf16 products a term: the 3xTF32
            # kernels' gate against float64; the card's time by graph
            # replay beside the host's
            k64 = {**kw, "res": r.double() if rlay else None}
            _fp32_gate(m, [(kernel(), conv_ref(x, w.double(), S, pad,
                                               **k64))], f"{kern} {case}")
            m.update(design_bound_ms=bound_ms(3 * m["flops"], m["bytes"],
                                              PEAK_BF16_FLOPS)[0],
                     design="bf16_split3", device_ms=device_ms(kernel),
                     library_device_ms=device_ms(library))
    else:
        _k2_narrow(m, kern, case, x, w, S, pad, kw, check, kernel)
    return m


def _k2_narrow(m: dict, kern: str, case, x, w, S: int, pad: int, kw,
               check, kernel) -> None:
    """A narrow K2 launch (``kernel()`` runs it) once more counting the
    FLOPs its blocks execute, which must equal ``nchw_tiling``'s, its
    output held as the launch's (``check``); where w is bf16 (the bf16
    tensor cores) also three runs bitwise equal and the error against
    float64 of the same values, scale-relative (its gate is one bf16 step
    of the plain version)."""
    y = _k2_tile(m, case, x, w, S, pad, kw)
    plain = conv_ref(x, w, S, pad, **kw)
    if check is None:
        torch.testing.assert_close(y, plain, rtol=CONV_RTOL, atol=CONV_ATOL)
        return
    check(y, plain)
    bitwise_runs(kernel, f"{kern} {case}")
    res = kw.get("res")
    want = conv_ref(x.double(), w.double(), S, pad,
                    **{**kw, "res": None if res is None else res.double()})
    m.update(bitwise_equal_runs=3, f64_err=_scaled_err(y, want))


def bitwise_runs(fn, what: str, first=None, runs: int = 3) -> None:
    """``runs`` outputs of ``fn()`` (``first`` the first, if given) bit for
    bit equal: a kernel that sums in a fixed order."""
    want = fn() if first is None else first
    for _ in range(runs - 1):
        if not torch.equal(fn(), want):
            raise AssertionError(f"{what}: two runs differ")


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
    dev, variant = _build.require_cuda_storage("softmax", x)
    xp, yp, (rows, cols) = x.data_ptr(), y.data_ptr(), x.shape
    st = _build.stream_of(dev)
    launch = _build.entry("softmax_forward", variant)

    class Counter:
        launches = 0

    def count():
        Counter.launches += 1

    steps = {
        "grad_mode": lambda: x.requires_grad and torch.is_grad_enabled(),
        "dim": lambda: x.dim(),
        "on_cpu": lambda: _build.on_cpu("softmax", x),
        "require_cuda_storage": lambda: _build.require_cuda_storage(
            "softmax", x),
        "shape": lambda: x.shape,
        "alloc": lambda: torch.empty_like(x),
        "data_ptr": lambda: (x.data_ptr(), y.data_ptr()),
        "library_lookup": lambda: _build.entry("softmax_forward", variant),
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


def wgrad_case(case, dev, seed: int, dtype=torch.float32) -> dict:
    """K6 against its plain version in float64 (the error reported is the
    kernel's own, scale-relative), timed beside the plain version in
    float32 and ``torch.nn.grad.conv2d_weight``, all on x and g of
    ``dtype`` (float32, or bf16: the bf16 build; dw float32 either way;
    its bound at the bf16 peak)."""
    N, Ci, H, Co, F, S, pad, x_lay, g_lay = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    Ho = conv_out_hw(H, F, S, pad)
    x_nchw = torch.randn(N, Ci, H, H, device=dev, generator=gen).to(dtype)
    g_nchw = torch.randn(N, Co, Ho, Ho, device=dev, generator=gen).to(dtype)
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
    bitwise_runs(kernel, f"K6 {case}", first=got)
    flops = 2.0 * Co * Ci * F * F * N * Ho * Ho
    nbytes = float(x.element_size() * (x.numel() + g.numel())
                   + 4 * Co * Ci * F * F)
    peak = PEAK_FP32_FLOPS if dtype is torch.float32 else PEAK_BF16_FLOPS
    b_ms, b_by = bound_ms(flops, nbytes, peak)
    # the design's own bound: 3xTF32 runs 3 TF32 products per term, the
    # bf16 build one bf16 product (its peak bound)
    fp32 = dtype is torch.float32
    return {"max_abs_err": abs_err, "max_rel_err": err, "f64_err": err,
            "design_bound_ms": (bound_ms(3 * flops, nbytes,
                                         PEAK_TF32_FLOPS)[0] if fp32
                                else b_ms),
            "design": "3xtf32" if fp32 else "bf16",
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: wgrad_ref(x, g, F, S, pad, **kw)),
            "library_ms": cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw, (Co, Ci, F, F), g_nchw, stride=S, padding=pad)),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes, "peak_flops": peak}


def _pool_bwd_library(z_nchw, g_nchw, F: int, S: int, op: str, relu: bool):
    """The library call for a pool backward: aten's backward of
    ``max_pool2d``/``avg_pool2d`` in NCHW, times the ReLU mask."""
    mask = (z_nchw > 0).to(z_nchw.dtype) if relu else None
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
    return library


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
    library = _pool_bwd_library(z_nchw, g_nchw, F, S, op, relu)
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


def device_line(label: str, rows, what: str = "over the main path") -> str:
    """A kernel also timed by graph replay (K1 int8→fp32, the bf16 pools
    and their backwards, K4 bf16, the bf16 transposes) summed over
    ``rows``' launches: the back-to-back ms (the host's time where a
    launch is short) beside the device ms (``device_ms``: graph replays),
    each with the library call's, the bound (bytes; K1's operations) and
    the share of it the device time reaches."""
    def tot(f):
        return sum(r[f] * (r["launches"] or 1) for r in rows)
    return (f"{label} {what}: launches={sum(r['launches'] for r in rows)} "
            f"ms={tot('ms'):.4f} device_ms={tot('device_ms'):.4f} "
            f"library_ms={tot('library_ms'):.4f} "
            f"library_device_ms={tot('library_device_ms'):.4f} "
            f"bound_ms={tot('bound_ms'):.5f} device_bound_share="
            f"{tot('bound_ms') / tot('device_ms'):.3f} "
            f"x_lib={tot('ms') / tot('library_ms'):.3f} device_x_lib="
            f"{tot('device_ms') / tot('library_device_ms'):.3f}")


def pool_host_steps(x, F: int, S: int, op: str) -> dict:
    """Host microseconds of each step of a K3a launch (``pool/ops.py``'s
    ``_pool`` on the ``_build`` helpers), each timed alone, beside the
    whole wrapper and the library call (``max_pool2d``/``avg_pool2d`` on
    the NCHW view of x)."""
    dev, variant = _build.require_cuda_storage("pool_chwn", x)
    C, H, W, N = x.shape
    Ho, Wo = (H - F) // S + 1, (W - F) // S + 1
    y = x.new_empty((C, Ho, Wo, N))
    xp, yp = x.data_ptr(), y.data_ptr()
    st = _build.stream_of(dev)
    launch = _build.entry("pool_chwn_forward", variant)
    x_nchw = x.permute(3, 0, 1, 2)
    pool_fn = nnf.max_pool2d if op == "max" else nnf.avg_pool2d

    class Counter:
        launches = 0

    def count():
        Counter.launches += 1

    steps = {
        "grad_mode": lambda: torch.is_grad_enabled() and x.requires_grad,
        "shape": lambda: x.shape,
        "out_hw": lambda: ((H - F) // S + 1, (W - F) // S + 1),
        "on_cpu": lambda: _build.on_cpu("pool_chwn", x),
        "require_cuda_storage": lambda: _build.require_cuda_storage(
            "pool_chwn", x),
        "alloc": lambda: x.new_empty((C, Ho, Wo, N)),
        "data_ptr": lambda: (x.data_ptr(), y.data_ptr()),
        "library_lookup": lambda: _build.entry("pool_chwn_forward", variant),
        "stream_of": lambda: _build.stream_of(dev),
        "ctypes_launch": lambda: launch(xp, yp, N, C, H, W, F, S,
                                        op == "avg", False, st),
        "check": lambda: _build.check("pool_chwn", 0),
        "count": count,
        "wrapper": lambda: pool_chwn(x, F, S, op),
        "library": lambda: pool_fn(x_nchw, F, S),
    }
    return {k: host_us(fn) for k, fn in steps.items()}


def pool_bf16_fp32_shapes(cases, dev, kern: str, label: str) -> dict:
    """K3a bf16 (``kern`` "pool_chwn", ``label`` "K3a") or K3b bf16
    ("pool_nchw", "K3b") on every launch of the float32 row (the unfused
    path's AlexNet b128 and VGG16 b32 pools, and for K3a unet_mini's), each
    cast to bf16, held and timed as the dtype phase's bf16 launches; one
    line a shape and a sum weighted by the float32 row's launches.  There
    bytes, not the host, set the time."""
    rows = []
    for i, r in enumerate(c for c in cases if c["kernel"] == kern):
        m = dtype_case(f"{kern}.bf16", r["case"], dev, 1000 + i)
        m.update(case=r["case"], launches=r["launches"],
                 network=r["network"])
        rows.append(m)
        print(f"{label} bf16 on {r['network']} case={r['case']} "
              f"x{r['launches']}: ms={m['ms']:.4f} "
              f"device_ms={m['device_ms']:.5f} "
              f"library_device_ms={m['library_device_ms']:.5f} "
              f"bound_ms={m['bound_ms']:.5f} device_bound_share="
              f"{m['bound_ms'] / m['device_ms']:.3f}", flush=True)
    print(device_line(f"{label} bf16", rows,
                      f"on the float32 {label} row's shapes"), flush=True)
    return {"cases": rows}


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
    for network, batch, profile in BF16_TRAINED:
        cfg, plan = bf16_train_plan(network, batch, profile)
        add(network, f"batch={batch} bf16 stack=auto ({profile} plan)",
            plan_train_launches(cfg, plan), kind="bf16 training step",
            times=BF16_TRAIN_STEPS)
    for kern, case in OFF_PATH.items():
        mult[(kern, case)] = {"network": "vgg16", "kernel": kern,
                              "case": case, "launches": 0}
    for network, bucket, policy, stack in DTYPE_SERVED:
        cfg, plan = dtype_plan(network, bucket, policy, stack)
        add(network, f"bucket={bucket} bf16 {policy} stack={stack}",
            fused_launches(cfg, plan))
    for kern, case in CALIBRATION_ONLY.items():
        # its launches are the calibration's, counted by the dtype phase
        mult[(kern, case)] = {"network": "calibration", "kernel": kern,
                              "case": case, "launches": 0, "one_case": True}
    for i, ((kern, case), row) in enumerate(mult.items()):
        t0 = time.perf_counter()
        if "." in kern:
            m = dtype_case(kern, case, dev, i)
        elif kern == "softmax":
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
        if "." in kern:
            extra = f" TFLOP/s={m['flops'] / m['ms'] / 1e9:.1f}"
            if "cluster" in m:
                extra += (f" executed/direct="
                          f"{m['executed_flops'] / m['flops']:.3f} "
                          f"cluster={m['cluster']}")
            if "counted_cluster" in m:
                extra += (f" counted_GFLOP={m['counted_flops'] / 1e9:.2f} "
                          f"counted_cluster={m['counted_cluster']} "
                          f"resident_clusters={m['resident_clusters']}")
            if "bitwise_equal_runs" in m:
                extra += f" bitwise_equal_runs={m['bitwise_equal_runs']}"
            if kern.startswith("conv_stack") and "f64_err" in m:
                extra += f" f64_err={m['f64_err']:.3g}"
            if "twin_ms" in m:
                extra += (f" twin_ms={m['twin_ms']:.4f} "
                          f"twin_bitwise={m['twin_bitwise']}")
            if kern.startswith("conv_nchw."):
                extra += (f" executed/direct="
                          f"{m['executed_flops'] / m['flops']:.3f} "
                          f"tile={m['tile']} blocks={m['blocks']}")
                if "f64_err" in m:
                    extra += f" f64_err={m['f64_err']:.3g}"
            if "device_ms" in m:
                extra = f" device_ms={m['device_ms']:.5f}"
            if "library_device_ms" in m:
                extra += (f" library_device_ms={m['library_device_ms']:.5f}"
                          f" device_bound_share="
                          f"{m['bound_ms'] / m['device_ms']:.3f}")
            if kern == "conv_chwn.i8f32" and "f64_err" in m:
                extra += (f" TFLOP/s={m['flops'] / m['ms'] / 1e9:.1f} "
                          f"f64_err={m['f64_err']:.3g} bound_split3_ms="
                          f"{m['design_bound_ms']:.4f} tile={m['tile']} "
                          f"blocks={m['blocks']}")
        elif kern in ("conv_chwn", "conv_nchw"):
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
    print(tensor_core_line("K6 bf16", [r for r in mult.values()
                                       if r["kernel"] == "wgrad.bf16"],
                           peak="bf16", design="bf16"), flush=True)
    print(tensor_core_line("K2 bf16", [r for r in mult.values()
                                       if r["kernel"] == "conv_nchw.bf16"],
                           peak="bf16", design="bf16"), flush=True)
    for label, kern, what in (
            ("K1 int8→fp32", "conv_chwn.i8f32",
             "on its case (the calibration's)"),
            ("K3a bf16", "pool_chwn.bf16", "over the main path"),
            ("K3b bf16", "pool_nchw.bf16", "on its case (off every path)"),
            ("K4 bf16", "softmax.bf16", "over the main path"),
            ("K7a bf16", "pool_backward_chwn.bf16", "over the main path"),
            ("K7b bf16", "pool_backward_nchw.bf16", "over the main path"),
            ("K9a bf16", "transpose2d.bf16", "over the main path"),
            ("K9b bf16", "transpose2d_batched.bf16",
             "on its case (off every path)")):
        print(device_line(label, [r for r in mult.values()
                                  if r["kernel"] == kern], what), flush=True)
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
    card's); returns (launches per kernel over the whole main path, a row
    a server: its warm forwards and the guard's host cost)."""
    total = {k: 0 for k in K.WRAPPERS}
    rows = []
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
        assert_clean(srv, f"serve {network} stack={stack}")
        print(f"serve {network} stack={stack}: {n_req} requests in "
              f"{wall:.3f}s, launches {counts} (= the plans'), max |probs - "
              f"torch engine| = {worst:.3g}, {srv.incidents.summary()}, "
              f"every bucket on {srv.ladder[0].name}")
        for line in srv.report_lines():
            print(line)
        for bucket, ms_k, ms_t in warm:
            print(f"warm forward {network} bucket={bucket} stack={stack}: "
                  f"kernels "
                  f"{ms_k:.3f} ms ({1e3 * bucket / ms_k:.1f} img/s), torch "
                  f"engine (cuDNN, TF32 off) {ms_t:.3f} ms "
                  f"({1e3 * bucket / ms_t:.1f} img/s)")
        # not counted: the guarded step around a stub forward
        guard_ms, data_ms, plan_ms = guard_host_ms(srv, images[0])
        print(f"guard host cost {network} stack={stack}: guarded step of "
              f"one image around a stub forward {guard_ms:.4f} ms, its data "
              f"path alone {data_ms:.4f} ms, its plan lookup alone "
              f"{plan_ms:.4f} ms (host clock, medians of {GUARD_ROUNDS} in "
              f"turns), the rest {guard_ms - data_ms - plan_ms:+.4f} ms a "
              f"batch", flush=True)
        rows.append({"network": network, "stack": stack,
                     "guard_host_ms": guard_ms, "data_path_ms": data_ms,
                     "plan_lookup_ms": plan_ms,
                     "warm": [{"bucket": b, "ms": k, "torch_ms": t}
                              for b, k, t in warm]})
        for k, v in counts.items():
            total[k] += v
        del srv
        torch.cuda.empty_cache()
    return total, rows


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


def assert_clean(srv, label: str) -> None:
    """A server of a clean phase (no injector) had no incident, quarantined
    nothing and served every bucket on its ladder's top rung: a kernel that
    failed over silently fails the smoke.  Stragglers follow the host
    clock, not the kernels: they are printed (in the incident summary),
    not gated."""
    top = srv.ladder[0].name
    off = {b: rep.rung for b, rep in srv.reports.items() if rep.rung != top}
    faults = srv.incidents.total - srv.incidents.counts.get("straggler", 0)
    if faults or srv._quarantine or off:
        raise AssertionError(
            f"{label}: the clean server {srv.incidents.summary()}, "
            f"quarantined {sorted(srv._quarantine)}, buckets off {top}: "
            f"{off}")


GUARD_ROUNDS = 51


def guard_host_ms(srv, image, rounds: int = GUARD_ROUNDS) -> tuple:
    """Host ms of one guarded ``step`` of a one-image batch around a stub
    forward that returns the output of a real step and launches nothing,
    and, in turns with it (the order reversed every other round), of two
    parts of it that the unguarded step made too: its data path on the
    same image and output (the image's copy to the card, the finite check
    and its synchronization, the output's copy back) and the top rung's
    plan lookup (a cache hit).  The medians of ``rounds``.  The step holds
    every per-batch cost of the guard, so the step less both parts (the
    ladder walk, the report, the watchdog and the host finite check)
    bounds the guard's own cost a batch from above."""
    forward, kept = srv.model.forward, []

    def record(x, plan, impl="cuda"):
        kept.append(forward(x, plan, impl))
        return kept[-1]

    def step():
        srv.submit(ImageRequest(0, image))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step()
        return time.perf_counter() - t0

    def data_path():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(np.stack([image])).to(srv.device)
        y = kept[0][0]
        bool(batch_output_ok(y))
        y.float().cpu().numpy()
        return time.perf_counter() - t0

    def plan_lookup():
        top = srv.ladder[0]
        t0 = time.perf_counter()
        srv.cache.fused_plan(srv.cfg, 1, dtype=srv.dtype, policy=top.policy,
                             stack=top.stack)
        return time.perf_counter() - t0

    srv.model.forward = record
    try:
        srv.submit(ImageRequest(0, image))
        srv.step()
        srv.model.forward = lambda x, plan, impl="cuda": kept[0]
        fns = (step, data_path, plan_lookup)
        times = {fn: [] for fn in fns}
        for i in range(rounds):
            for fn in fns[::1 - 2 * (i % 2)]:
                times[fn].append(1e3 * fn())
    finally:
        srv.model.forward = forward
    return tuple(float(np.median(times[fn])) for fn in fns)


def launches_by_variant() -> dict:
    """The launch counts that are not 0, a storage variant's under
    "<kernel>.<variant>" and a float32 launch under the kernel's name."""
    var = _nonzero(K.variant_launch_counts())
    out = dict(var)
    for k, n in K.launch_counts().items():
        f32 = n - sum(v for kv, v in var.items() if kv.split(".")[0] == k)
        if f32:
            out[k] = f32
    return out


def injected_scenario(label: str, srv, dev, n_req: int, seed: int) -> dict:
    """Serve ``n_req`` seeded requests through ``srv`` (a guarded server
    built with ``INJECT_SPEC`` at seed 0, dtype policy "mixed") in the
    reference's bursty chunks (``run(rng=)``), one step a chunk, then
    drained; a fully failed step is retried.  Holds: every answer finite,
    served and bit-equal to ``forward_fused(impl="cuda")`` of the serving
    rung's plan on the same padded batch and within ``PROBS_ATOL`` of the
    torch engine; ``kernel_fault`` and ``nonfinite`` equal to the injector's own
    counts; every bucket served on the last rung (``cuda``: uniform, no
    stacks); the launches, counted from zero over the whole run, equal to
    the plans of the rungs whose forward ran (an injected kernel fault
    fires before any launch; a poisoned batch has launched)."""
    ran = []                           # the plan of every forward that ran
    forward = srv.model.forward

    def recorded(x, plan, impl="cuda"):
        ran.append((x.shape[0], plan))
        return forward(x, plan, impl)

    srv.model.forward = recorded
    rng = np.random.default_rng(seed)
    c, h = srv.cfg.in_channels, srv.cfg.image_hw
    images = [rng.standard_normal((c, h, h), np.float32)
              for _ in range(n_req)]
    params, served = srv.model.params(), []

    def on_batch(batch):
        bucket, plan = ran[-1]         # the forward that served the batch
        served.append(([r.rid for r in batch], bucket, plan,
                       srv.reports[bucket].rung))

    K.reset_launch_counts()
    t0 = time.perf_counter()
    done = srv.run([ImageRequest(j, im) for j, im in enumerate(images)],
                   rng=rng, on_batch=on_batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_by_variant()
    srv.model.forward = forward
    want = Counter(k for bucket, plan in ran
                   for k, _ in fused_launches(srv.cfg.replace(batch=bucket),
                                              plan))
    if counts != dict(want):
        raise AssertionError(f"{label}: launches {counts} != the plans of "
                             f"the {len(ran)} forwards that ran {dict(want)}")
    if sorted(done) != list(range(n_req)):
        raise AssertionError(f"{label}: served {len(done)} of {n_req}")
    last = srv.ladder[-1].name
    worst = 0.0
    for rids, bucket, plan, rung in served:
        if rung != last:
            raise AssertionError(f"{label}: a bucket-{bucket} batch served "
                                 f"on {rung}, not {last}")
        x = pad_to_bucket(torch.from_numpy(np.stack(
            [images[r] for r in rids])).to(dev), bucket)
        got = np.stack([done[r] for r in rids])
        if not np.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite answers")
        ys = {impl: forward_fused(params, x, srv.cfg, plan, impl=impl)[0]
              [:len(rids)].float().cpu().numpy()
              for impl in ("cuda", "torch")}
        if not np.array_equal(got, ys["cuda"]):
            raise AssertionError(
                f"{label} bucket {bucket}: answers not bit-equal to the "
                f"{rung} plan on the kernels (max diff "
                f"{float(np.abs(got - ys['cuda']).max()):.3g})")
        worst = max(worst, float(np.abs(got - ys["torch"]).max()))
    if worst > PROBS_ATOL:
        raise AssertionError(f"{label}: answers {worst:.3g} from the torch "
                             f"engine > {PROBS_ATOL}")
    inc, fired = srv.incidents.counts, srv.injector.counts
    if (inc.get("kernel_fault", 0), inc.get("nonfinite", 0)) != (
            fired.get("kernel", 0), fired.get("nan@mixed", 0)):
        raise AssertionError(f"{label}: incidents {inc} != the injector's "
                             f"faults {fired}")
    row = {"label": label, "requests": n_req, "served": len(done),
           "wall_s": wall, "batches": len(served), "forwards": len(ran),
           "buckets": sorted({b for _, b, _, _ in served}),
           "rungs": [r.name for r in srv.ladder],
           "incidents": dict(inc), "summary": srv.incidents.summary(),
           "injected": dict(fired), "launches": counts,
           "max_abs_err": worst}
    print(f"resilience {label}: {len(done)}/{n_req} served in {wall:.3f}s "
          f"({len(served)} batches, {len(ran)} forwards ran), ladder "
          f"{row['rungs']}, every bucket {row['buckets']} on {last}; "
          f"{row['summary']}; injected {row['injected']}; launches "
          f"{counts} (= the plans of the forwards that ran); bit-equal to "
          f"the {last} plan on the kernels, max |probs - torch engine| = "
          f"{worst:.3g}", flush=True)
    for line in srv.report_lines():
        print(line)
    return row


def resilience_phase(dev, th_fp32, th_int8) -> list:
    """The reference's resilience scenario (``tools/resilience_smoke.py``)
    on the card, then at full width.  lenet, mixed, max_bucket 8: a warm
    server persists a plan cache and the measured threshold table (its
    float32 and int8 rows those the calibration and dtype phases measured,
    written beforehand) in a temporary directory; both files are
    corrupted (garbage, truncate); a second server with ``INJECT_SPEC`` at
    seed 0 must count two ``corrupt_state`` incidents, rename both files
    aside, measure both rows again on the card and serve 48 seeded
    requests (``injected_scenario``).  Then AlexNet at 227 px, mixed,
    max_bucket 128, under the same injection: 128 requests."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        cache_path = os.path.join(tmp, "lenet.plans.json")
        calib_path = os.path.join(tmp, "thresholds.json")
        hw = hardware_id(dev)
        save_thresholds(th_fp32, calib_path, dtype="float32", hardware=hw)
        save_thresholds(th_int8, calib_path, dtype="int8", hardware=hw)
        kw = dict(max_bucket=8, cache_path=cache_path, calib_path=calib_path,
                  dtype_policy="mixed", calibration="measured", seed=0,
                  device=dev)
        K.reset_launch_counts()
        warm = CNNServer("lenet", **kw)
        if any(K.launch_counts().values()):
            raise AssertionError("resilience: the warm server measured rows "
                                 "its threshold file holds")
        rng = np.random.default_rng(8)
        done = warm.run([ImageRequest(i, rng.standard_normal(
            (1, 28, 28), np.float32)) for i in range(16)])
        assert_clean(warm, "resilience warm lenet")
        if len(done) != 16 or not (os.path.exists(cache_path)
                                   and os.path.exists(calib_path)):
            raise AssertionError("resilience: the warm run did not serve "
                                 "and persist its state")
        FaultInjector.corrupt_json(cache_path, "garbage")
        FaultInjector.corrupt_json(calib_path, "truncate")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        srv = CNNServer("lenet", **kw,
                        injector=parse_inject_spec(INJECT_SPEC, seed=0))
        setup_s = time.perf_counter() - t0
        remeasured = _nonzero(launches_by_variant())
        if srv.incidents.counts != {"corrupt_state": 2} or not (
                os.path.exists(cache_path + ".corrupt")
                and os.path.exists(calib_path + ".corrupt")):
            raise AssertionError(f"resilience: corrupt state not recovered: "
                                 f"{srv.incidents.counts}")
        if not (remeasured.get("conv_chwn") and remeasured.get("conv_nchw")
                and remeasured.get("conv_chwn.i8f32")
                and remeasured.get("conv_nchw.i8f32")):
            raise AssertionError(f"resilience: the rows were not measured "
                                 f"again on the card: {remeasured}")
        print(f"resilience lenet restart: both files renamed aside, "
              f"{srv.incidents.summary()}, rows measured again on the card "
              f"in {setup_s:.1f}s (launches {remeasured}), thresholds "
              + " ".join(f"{r}: {srv.cache.thresholds_for(r, hw)}"
                         for r in srv.rows), flush=True)
        row = injected_scenario("lenet max_bucket=8 mixed", srv, dev, 48, 1)
        row.update(setup_s=setup_s, remeasured=remeasured)
        rows.append(row)
        del srv, warm
        network, cap, n_req = RESILIENT
        srv = CNNServer(network, reduced=False, max_bucket=cap, seed=0,
                        dtype_policy="mixed", calibration="measured",
                        calib_path=calib_path, device=dev,
                        injector=parse_inject_spec(INJECT_SPEC, seed=0))
        rows.append(injected_scenario(
            f"{network} {srv.cfg.image_hw}px max_bucket={cap} mixed", srv,
            dev, n_req, 2))
        del srv
        torch.cuda.empty_cache()
    return rows


def _state_equal(a, b) -> bool:
    return all(torch.equal(a[part][l][k], v)
               for part in ("params", "vel")
               for l, p in b[part].items() for k, v in p.items())


def runner_phase(dev) -> dict:
    """``FaultTolerantRunner`` over ``make_train_step_fused`` on the
    kernels: ResNet-18 b32 fp32 at full width on the training phase's plan
    (the packaged stack "auto" one), 6 steps (a seeded batch each),
    ``save_every=2``, an asynchronous ``Checkpointer`` in a temporary
    directory.  Three runs from the seed-0 weights: uninterrupted; a
    ``StepFailure`` once at step 3 (restored from step 2); step 4's
    manifest corrupted before a failure at step 5 (restore falls back to
    step 2).  Both restarted runs must end with parameters and velocity
    bit-equal to the uninterrupted run.  Then one bf16 checkpoint of the
    ResNet-18 b32 bf16 step (the bf16 training phase's plan) round trips
    bit for bit.  Runs outside inference mode."""
    network, batch = RUNNER
    cfg = CNN_CONFIGS[network].replace(batch=batch)
    plan = (PlanCache(str(packaged_plans(network))).peek_fused(
        cfg, batch, stack="auto") or planned(network, batch)[1])
    step_k = make_train_step_fused(cfg, plan)
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(rng.standard_normal(input_shape(cfg),
                                               np.float32)).to(dev)
          for _ in range(RUNNER_STEPS)]
    ys = [torch.from_numpy(rng.integers(0, cfg.num_classes, batch)).to(dev)
          for _ in range(RUNNER_STEPS)]

    def start():
        params = params_from_numpy(init_cnn(cfg, 0), dev)
        return {"params": params, "vel": init_velocity(params)}

    out = {"network": network, "batch": batch, "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        final = None
        for label, fail_at, corrupt in (("uninterrupted", None, None),
                                        ("failure at step 3", 3, None),
                                        ("step 4's manifest corrupted, "
                                         "failure at step 5", 5, 4)):
            ck = Checkpointer(os.path.join(tmp, f"run{len(out['runs'])}"))
            restores, failed, losses = [], [], []
            restore = ck.restore

            def recorded(*a, **kw):
                restores.append(kw["step"])
                return restore(*a, **kw)

            ck.restore = recorded

            def step_fn(state, step):
                if step == fail_at and not failed:
                    failed.append(step)
                    if corrupt is not None:
                        ck.wait()
                        (ck.dir / f"step_{corrupt:010d}" /
                         "manifest.json").write_text("not json")
                    raise StepFailure(f"injected at step {step}")
                p, v, loss = step_k(state["params"], state["vel"], xs[step],
                                    ys[step])
                losses.append(loss.item())
                return {"params": p, "vel": v}, {}

            runner = FaultTolerantRunner(ck, save_every=2, max_restarts=2)
            t0 = time.perf_counter()
            step, state = runner.run(start(), step_fn, RUNNER_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if step != RUNNER_STEPS or not all(map(math.isfinite, losses)):
                raise AssertionError(f"runner {label}: ended at step {step}, "
                                     f"losses {losses}")
            want_restores = {None: [], 3: [2], 5: [4, 2]}[fail_at]
            if restores != want_restores:
                raise AssertionError(f"runner {label}: restored {restores}, "
                                     f"not {want_restores}")
            if final is None:
                final = state
            elif not _state_equal(state, final):
                diff = max(float((state[part][l][k] - v).abs().max())
                           for part in ("params", "vel")
                           for l, p in final[part].items()
                           for k, v in p.items())
                raise AssertionError(f"runner {label}: parameters and "
                                     f"velocity not bit-equal to the "
                                     f"uninterrupted run (max diff "
                                     f"{diff:.3g})")
            run = {"label": label, "restores": restores, "losses": losses,
                   "wall_s": wall, "checkpoints": ck.steps()}
            out["runs"].append(run)
            print(f"runner {network} b{batch} fp32 {label}: {RUNNER_STEPS} "
                  f"steps in {wall:.3f}s, {len(losses)} steps run, "
                  f"restored from {restores or 'nothing'}, checkpoints "
                  f"{run['checkpoints']}; parameters and velocity "
                  + ("the reference run" if fail_at is None else
                     "bit-equal to the uninterrupted run"), flush=True)
            del state
        del final
        cfg16, plan16 = bf16_train_plan(network, batch, "reference")
        params = params_from_numpy(init_cnn(cfg16, 0), dev, "bfloat16")
        p, v, _ = make_train_step_fused(cfg16, plan16)(
            params, init_velocity(params), xs[0].to(torch.bfloat16), ys[0])
        ck = Checkpointer(os.path.join(tmp, "bf16"))
        ck.save(1, {"params": p, "vel": v})
        ck.wait()
        _, back = ck.restore({"params": p, "vel": v})
        if not _state_equal(back, {"params": p, "vel": v}) or any(
                t.dtype != torch.bfloat16 or t.device != p[l][k].device
                for l, q in back["params"].items() for k, t in q.items()):
            raise AssertionError("runner: the bf16 checkpoint did not round "
                                 "trip bit for bit")
        nbytes = sum(t.numel() * 2 for part in (p, v) for q in part.values()
                     for t in q.values())
        print(f"runner {network} b{batch} bf16: one step's parameters and "
              f"velocity ({nbytes / 2**20:.1f} MiB) round trip a checkpoint "
              f"bit for bit", flush=True)
        out["bf16_checkpoint_bytes"] = nbytes
    torch.cuda.empty_cache()
    return out


def planned(network: str, bucket: int, stack: str = "auto"):
    """(cfg at ``bucket``, the fused plan the port's planner makes for it
    on its default, H100, profile): what a plan-cache miss plans."""
    cfg = CNN_CONFIGS[network].replace(batch=bucket)
    return cfg, plan_network_fused(cfg, stack_policy=stack)


def dtype_plan(network: str, bucket: int, policy: str, stack: str):
    """(cfg at ``bucket``, the bf16 plan the port's planner makes for it on
    the H100 profile at ``policy`` and ``stack``): what the dtype phase's
    servers plan on their miss."""
    cfg = CNN_CONFIGS[network].replace(batch=bucket)
    return cfg, plan_network_fused(cfg, dtype="bfloat16", policy=policy,
                                   stack_policy=stack)


def _nonzero(counts) -> dict:
    """The launches of ``K.launch_counts()``- or
    ``K.variant_launch_counts()``-style counts that are not 0."""
    return {k: v for k, v in counts.items() if v}


def _warm(fn) -> dict:
    """Warm device ms (CUDA events) and the peak device memory over what
    was allocated before, of one call of ``fn``."""
    return {"ms": cuda_ms(fn, max_reps=20),
            "peak_over_base_bytes": _peak_over_base(fn)}


def dtype_phase(dev):
    """bf16 storage and int8 boundaries on the main path (``DTYPE_SERVED``):
    each network served through ``CNNServer(reduced=False, dtype="bf16",
    dtype_policy=...)`` from an empty plan cache, calibration "measured"
    into a threshold file the phase shares (so each dtype's Fig. 4 sweep
    runs once: the first server measures the bf16 row on K1 and K2 in
    bf16, the first mixed one the int8 row on K1 and K2 on int8 x with
    float32 w).  Counts are zeroed before each server is made (its
    calibration's launches) and again just before its batch (the plan's:
    they must equal ``fused_launches`` of the plan the kernel phase
    measured, by variant, and no float32 launch).  Then, not counted, on
    the same seed-0 weights: bf16 uniform probabilities within 0.0625 of
    the float32 forward (packaged plan), mixed ones within 2e-2 of the
    bf16 stack="off" forward, and the warm forward ms and peak device
    memory of the served plan, bf16 uniform and float32 (the packaged
    plan, or the H100 planner's where none is packaged: unet_mini, whose
    bf16 pools run K3a in bf16).  Returns (the serving runs' launches by
    variant, the calibration's, a record)."""
    serve = Counter()
    calib = Counter()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        th_path = os.path.join(tmp, "thresholds.json")
        measured = {}
        for network, bucket, policy, stack in DTYPE_SERVED:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            srv = CNNServer(network, reduced=False, max_bucket=bucket, seed=0,
                            stack=stack, dtype="bf16", dtype_policy=policy,
                            calibration="measured", calib_path=th_path,
                            cache_path=os.path.join(
                                tmp, f"{network}-{policy}-{stack}.json"))
            setup_s = time.perf_counter() - t0
            cal = _nonzero(K.variant_launch_counts())
            calib.update(cal)
            rows_th = {}
            for row, var in (("bfloat16", "bf16"), ("int8", "i8f32")):
                if row not in srv.rows:
                    continue
                th = srv.cache.thresholds_for(row, srv._hw)
                k1 = cal.get(f"conv_chwn.{var}", 0)
                k2 = cal.get(f"conv_nchw.{var}", 0)
                if k1 and k2:
                    measured[row] = (network, k1, k2)
                elif row not in measured:
                    raise AssertionError(f"{network}: the {row} row was "
                                         "neither measured nor read back")
                rows_th[row] = {"Ct": th.Ct, "Nt": th.Nt,
                                "measured_by": measured[row][0],
                                "K1_launches": measured[row][1],
                                "K2_launches": measured[row][2]}
            cfg, want_plan = dtype_plan(network, bucket, policy, stack)
            rng = np.random.default_rng(7)
            images = [rng.standard_normal(
                (cfg.in_channels, cfg.image_hw, cfg.image_hw), np.float32)
                for _ in range(bucket)]
            K.reset_launch_counts()
            t0 = time.perf_counter()
            done = srv.run([ImageRequest(i, im)
                            for i, im in enumerate(images)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            base, var = K.launch_counts(), _nonzero(
                K.variant_launch_counts())
            plan = srv.cache.peek_fused(srv.cfg, bucket, dtype="bf16",
                                        policy=policy, stack=stack)
            if plan != want_plan:
                raise AssertionError(f"{network}: the server planned "
                                     "another plan than the kernel phase's")
            want = dict(Counter(k for k, _ in fused_launches(cfg, plan)))
            f32 = {k: n - sum(v for kv, v in var.items()
                              if kv.split(".")[0] == k)
                   for k, n in base.items()}
            if var != want or any(f32.values()):
                raise AssertionError(
                    f"{network} bf16 {policy}: launches {var} (float32 "
                    f"{_nonzero(f32)}) != the plan's {want}")
            serve.update(var)
            got = np.stack([done[i] for i in range(bucket)])
            if not np.isfinite(got).all():
                raise AssertionError(f"{network}: non-finite answers")
            assert_clean(srv, f"dtype serve {network} bf16 {policy} "
                              f"stack={stack}")

            # not counted from here: the references and the timings
            x32 = torch.from_numpy(np.stack(images)).to(dev)
            x16 = x32.to(torch.bfloat16)
            p16 = srv.model.params()
            p32 = params_from_numpy(init_cnn(cfg, 0), dev)
            fp32_stack = stack if policy == "uniform" else "off"
            # the packaged float32 plan; the H100 planner's where none is
            # packaged (unet_mini)
            packaged = (PlanCache(str(packaged_plans(network))).peek_fused(
                cfg, bucket, stack=fp32_stack)
                or planned(network, bucket, fp32_stack)[1])
            y32, _ = forward_fused(p32, x32, cfg, packaged)
            _, off16 = dtype_plan(network, bucket, "uniform", "off")
            y_off, _ = forward_fused(p16, x16, cfg, off16)
            d32 = float(np.abs(got - y32.float().cpu().numpy()).max())
            d_off = float(np.abs(got - y_off.float().cpu().numpy()).max())
            if policy == "uniform" and d32 > BF16_PROBS_ATOL:
                raise AssertionError(f"{network} bf16: probabilities "
                                     f"{d32:.3g} from float32 > "
                                     f"{BF16_PROBS_ATOL}")
            if policy == "mixed" and d_off > INT8_FORWARD_ATOL:
                raise AssertionError(f"{network} bf16 mixed: probabilities "
                                     f"{d_off:.3g} from bf16 stack=off > "
                                     f"{INT8_FORWARD_ATOL}")
            warm = {"served": _warm(lambda: forward_fused(p16, x16, cfg,
                                                          plan)),
                    "bf16_off": _warm(lambda: forward_fused(p16, x16, cfg,
                                                            off16)),
                    "fp32": _warm(lambda: forward_fused(p32, x32, cfg,
                                                        packaged))}
            row = {"network": network, "bucket": bucket, "policy": policy,
                   "stack": stack, "conv_dtypes": plan.dtype_signature,
                   "conv_layouts": plan.conv_signature,
                   "stacks": plan.stacked_convs, "launches": var,
                   "calibration_launches": cal, "rows": rows_th,
                   "max_diff_fp32": d32, "max_diff_bf16_off": d_off,
                   "setup_s": setup_s, "serve_s": wall, "warm": warm,
                   "fp32_stack": fp32_stack}
            rows.append(row)
            th_txt = " ".join(
                f"{r}: Ct={v['Ct']} Nt={v['Nt']} (measured by the "
                f"{v['measured_by']} server: K1 {v['K1_launches']}, K2 "
                f"{v['K2_launches']} launches)" for r, v in rows_th.items())
            print(f"dtype serve {network} bucket={bucket} bf16 "
                  f"policy={policy} stack={stack}: {bucket} requests in "
                  f"{wall:.3f}s (server made in {setup_s:.1f}s, "
                  f"{srv.incidents.summary()}, every bucket on "
                  f"{srv.ladder[0].name}), "
                  f"conv_dtypes={plan.dtype_signature} layouts="
                  f"{plan.conv_signature} stacks={plan.stacked_convs}, "
                  f"launches {var} (= the plan's), calibration launches "
                  f"{cal}; max |probs - fp32| = {d32:.3g}"
                  + (f" (<= {BF16_PROBS_ATOL})" if policy == "uniform"
                     else "")
                  + f", max |probs - bf16 off| = {d_off:.3g}"
                  + (f" (<= {INT8_FORWARD_ATOL})" if policy == "mixed"
                     else "")
                  + f"; thresholds {th_txt}", flush=True)
            print(f"dtype forward {network} bucket={bucket}: "
                  + "; ".join(
                      f"{label} {w['ms']:.3f} ms, peak "
                      f"+{w['peak_over_base_bytes'] / 2**20:.1f} MiB"
                      for label, w in (
                          (f"bf16 {policy} {stack}", warm["served"]),
                          ("bf16 uniform off", warm["bf16_off"]),
                          (f"fp32 {row['fp32_stack']}", warm["fp32"]))),
                  flush=True)
            for line in srv.report_lines():
                print(line)
            del srv, p16, p32, x16, x32
            torch.cuda.empty_cache()
    for row in ("bfloat16", "int8"):
        if row not in measured:
            raise AssertionError(f"no server measured the {row} row")
    return dict(serve), dict(calib), rows


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
        assert_clean(srv, f"planner serve {network}")
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


def _step1_gradients(network, loss, params, x, labels) -> dict:
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
    the same outliers).  ``loss(p, x, labels, impl)`` is the step's
    loss."""
    p64 = {l: {k: v.double() for k, v in p.items()}
           for l, p in params.items()}
    runs = {"cuda": (params, x, "cuda"), "torch": (params, x, "torch"),
            "f64": (p64, x.double(), "torch")}
    g = {name: value_and_grad(
        lambda p, a, b, impl=impl: loss(p, a, b, impl),
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


def _fused_loss(cfg, plan):
    """The fused training step's loss, as ``loss(p, x, labels, impl)``."""
    return lambda p, a, b, impl: loss_fn_fused(p, a, b, cfg, plan, impl)


def _unfused_loss(cfg, layouts):
    """The unfused training step's loss (``make_train_step``'s), as
    ``loss(p, x, labels, impl)``."""
    return lambda p, a, b, impl: loss_fn(p, a, b, cfg, layouts, impl)


def _step_ms_and_peak(step, params, vel, x, labels) -> dict:
    """Warm ms of one training step (CUDA events) and the peak device
    memory of one, also over what was allocated before it (weights,
    velocity, input)."""
    out = {"ms": cuda_ms(lambda: step(params, vel, x, labels), max_reps=10)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = step(params, vel, x, labels)
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_over_base_bytes"] = out["peak_bytes"] - base
    del res
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
        grad = _step1_gradients(network, _fused_loss(cfg, plan), params, x,
                                labels)
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
            w = _step_ms_and_peak(make_train_step_fused(cfg, plan, impl=impl),
                                  params, vel, x, labels)
            row.update({f"{impl}_{k}": v for k, v in w.items()})
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


def bf16_train_plan(network: str, batch: int, profile: str):
    """(cfg at ``batch``, its bf16 stack="auto" plan): on the H100 profile
    (``profile`` "h100", what a plan-cache miss plans) or on the
    reference's own (``"reference"``, ``reference_hardware``)."""
    cfg = CNN_CONFIGS[network].replace(batch=batch)
    cm = (AnalyticCostModel(reference_hardware()) if profile == "reference"
          else None)
    return cfg, plan_network_fused(cfg, dtype="bfloat16", cost_model=cm)


def _bf16_step1_gradients(network, loss, params, x, labels) -> dict:
    """The step-1 gradient of every parameter on the kernels and on the
    torch engine, both in bf16, and on the torch engine in float64 from the
    same bf16 weights and input (the oracle); not counted on the main
    path.  For each parameter, the L2 distances of the kernels' and the
    torch engine's gradients from float64, over the float64 norm.  Fails
    unless, for every parameter, the kernels' distance is at most
    ``BF16_GRAD_FACTOR`` times the torch engine's plus ``BF16_GRAD_SLACK``
    of the float64 norm.  The bound is relative because bf16 itself moves
    a gradient far from float64 (PERF.md §7): rounded activations tie
    within pool windows (the gradient routes to the first of them) and sit
    on the other side of a ReLU, so whole window or channel shares land
    elsewhere, in the torch engine as in the kernels (on the CPU, reduced
    VGG16's conv4_3 lies 24 % from float64 in the torch engine); a kernel
    fault moves a gradient further than that rounding does.  ``loss(p, x,
    labels, impl)`` is the step's loss."""
    p64 = {l: {k: v.double() for k, v in p.items()}
           for l, p in params.items()}
    runs = {"cuda": (params, x, "cuda"), "torch": (params, x, "torch"),
            "f64": (p64, x.double(), "torch")}
    g = {name: value_and_grad(
        lambda p, a, b, impl=impl: loss(p, a, b, impl),
        ps, xs, labels)[1] for name, (ps, xs, impl) in runs.items()}
    del p64
    worst = {"cuda_vs_f64": 0.0, "torch_vs_f64": 0.0, "cuda_vs_torch": 0.0}
    for layer, gs in g["f64"].items():
        for k, ref in gs.items():
            n64 = max(ref.norm().item(), 1e-30)
            d = {a: (g[a][layer][k].double() - ref).norm().item()
                 for a in ("cuda", "torch")}
            ct = (g["cuda"][layer][k].double()
                  - g["torch"][layer][k].double()).norm().item()
            for key, v in (("cuda_vs_f64", d["cuda"]),
                           ("torch_vs_f64", d["torch"]),
                           ("cuda_vs_torch", ct)):
                worst[key] = max(worst[key], v / n64)
            if d["cuda"] > BF16_GRAD_FACTOR * d["torch"] + (
                    BF16_GRAD_SLACK * n64):
                raise AssertionError(
                    f"bf16 train {network}: step-1 gradient of {layer}.{k} "
                    f"{d['cuda'] / n64:.3g} from float64 (L2, relative), "
                    f"past {BF16_GRAD_FACTOR} x the torch engine's "
                    f"{d['torch'] / n64:.3g} + {BF16_GRAD_SLACK}")
    return {k: float(f"{v:.4g}") for k, v in worst.items()}


def bf16_training_phase(dev):
    """bf16 training on the card (``BF16_TRAINED``): each network's bf16
    stack="auto" plan (``bf16_train_plan``), the seed-0 weights cast once
    to bf16 and a seeded input cast to bf16, ``BF16_TRAIN_STEPS`` SGD steps
    of ``make_train_step_fused`` on the kernels (counts zeroed just before
    each step and read just after: every launch a bf16 one, equal by
    variant to ``plan_train_launches``), the same steps on the torch engine
    in bf16 from the same start (its trajectory, reported), and at every
    step the torch engine's bf16 loss at the kernels' parameters.  Gates:
    every loss finite; each kernels' loss within ``BF16_LOSS_TOL`` of the
    torch engine's at the same parameters; the step-1 gradients as
    ``_bf16_step1_gradients`` says.  Reported beside: whether the loss
    falls over the steps (the reference's LeNet criterion), one warm step
    on each engine in bf16 (ms, img/s) and on the kernels over the same
    planner's float32 plan, and the peak device memory of each.  Runs
    outside inference mode.  Returns (launches by variant over the counted
    steps, rows)."""
    total = Counter()
    rows = []
    for network, batch, profile in BF16_TRAINED:
        cfg, plan = bf16_train_plan(network, batch, profile)
        want = dict(Counter(k for k, _ in plan_train_launches(cfg, plan)))
        params = params_from_numpy(init_cnn(cfg, 0), dev, "bf16")
        rng = np.random.default_rng(4)
        x = torch.from_numpy(rng.standard_normal(
            input_shape(cfg), np.float32)).to(dev, torch.bfloat16)
        labels = torch.from_numpy(rng.integers(
            0, cfg.num_classes, batch)).to(dev)
        grad = _bf16_step1_gradients(network, _fused_loss(cfg, plan),
                                     params, x, labels)
        losses, same_point = {}, []
        for run in ("cuda", "torch"):
            step = make_train_step_fused(cfg, plan, impl=run)
            p, v, ls = params, init_velocity(params), []
            for _ in range(BF16_TRAIN_STEPS):
                if run == "cuda":   # the torch engine at the same point
                    with torch.no_grad():
                        same_point.append(loss_fn_fused(
                            p, x, labels, cfg, plan, "torch").item())
                K.reset_launch_counts()
                p, v, loss = step(p, v, x, labels)
                torch.cuda.synchronize()
                counts = K.launch_counts()
                if run != "cuda" and any(counts.values()):
                    raise AssertionError(f"bf16 train {network}: the torch "
                                         f"engine launched {counts}")
                if run == "cuda":
                    var = _nonzero(K.variant_launch_counts())
                    if var != want or sum(counts.values()) != sum(
                            var.values()):
                        raise AssertionError(
                            f"bf16 train {network}: launches {var} (all "
                            f"{_nonzero(counts)}) != the plan's {want}")
                    total.update(var)
                    if any(t.dtype != torch.bfloat16
                           for q in p.values() for t in q.values()):
                        raise AssertionError(f"bf16 train {network}: a "
                                             "parameter left bf16")
                ls.append(loss.item())
            losses[run] = ls
            del p, v
        if not all(math.isfinite(v) for ls in losses.values() for v in ls):
            raise AssertionError(f"bf16 train {network}: non-finite loss "
                                 f"{losses}")
        diffs = [abs(a - b) for a, b in zip(losses["cuda"], same_point)]
        if max(diffs) > BF16_LOSS_TOL:
            raise AssertionError(
                f"bf16 train {network}: losses {losses['cuda']} differ from "
                f"the torch engine's at the same parameters {same_point} by "
                f"{max(diffs):.3g} > {BF16_LOSS_TOL}")
        vel = init_velocity(params)
        warm = {impl: _step_ms_and_peak(make_train_step_fused(
            cfg, plan, impl=impl), params, vel, x, labels)
            for impl in ("cuda", "torch")}
        del vel
        # the same planner's float32 plan on the kernels, for the memory
        # and time a bf16 step saves (not counted)
        plan32 = plan_network_fused(
            cfg, cost_model=(AnalyticCostModel(reference_hardware())
                             if profile == "reference" else None))
        p32 = params_from_numpy(init_cnn(cfg, 0), dev)
        warm["fp32"] = _step_ms_and_peak(
            make_train_step_fused(cfg, plan32), p32, init_velocity(p32),
            x.float(), labels)
        del p32
        row = {"network": network, "batch": batch, "profile": profile,
               "conv_layouts": plan.conv_signature,
               "fp32_conv_layouts": plan32.conv_signature,
               "stacks": plan.stacked_convs, "losses": losses,
               "torch_at_same_params": same_point, "loss_diffs": diffs,
               "loss_falls": losses["cuda"][-1] < losses["cuda"][0],
               "grad": grad, "launches": want, "warm": warm}
        rows.append(row)
        print(f"bf16 train {network} batch={batch} stack=auto ({profile} "
              f"plan, layouts {plan.conv_signature}, {plan.stacked_convs} "
              f"stacks): losses kernels {losses['cuda']}, torch engine at "
              f"the same parameters {same_point} (max diff "
              f"{max(diffs):.3g} <= {BF16_LOSS_TOL}); torch engine "
              f"trajectory {losses['torch']}; loss falls "
              f"{row['loss_falls']}; step-1 gradients (L2 from float64, "
              f"relative, worst parameter) {grad}; launches per step "
              f"{want} (= the plan's); warm step kernels "
              f"{warm['cuda']['ms']:.3f} ms "
              f"({1e3 * batch / warm['cuda']['ms']:.1f} img/s), torch "
              f"engine bf16 {warm['torch']['ms']:.3f} ms "
              f"({1e3 * batch / warm['torch']['ms']:.1f} img/s), kernels "
              f"fp32 ({plan32.conv_signature}) {warm['fp32']['ms']:.3f} ms; "
              f"peak device memory of a step kernels bf16 "
              f"{warm['cuda']['peak_bytes'] / 2**20:.1f} MiB (+"
              f"{warm['cuda']['peak_over_base_bytes'] / 2**20:.1f} over "
              f"weights, velocity and input), torch engine bf16 "
              f"{warm['torch']['peak_bytes'] / 2**20:.1f} (+"
              f"{warm['torch']['peak_over_base_bytes'] / 2**20:.1f}), "
              f"kernels fp32 {warm['fp32']['peak_bytes'] / 2**20:.1f} (+"
              f"{warm['fp32']['peak_over_base_bytes'] / 2**20:.1f})",
              flush=True)
        del params, x, labels
        torch.cuda.empty_cache()
    return dict(total), rows


def unfused_train_counts(cfg, layouts, v: str = "") -> dict:
    """Launches by kernel of one unfused training step (``make_train_step``,
    impl="cuda") in ``layouts``, worked out from them alone: the forward's
    (``layout_launches``: bare K1/K2, K3a/K3b, K9a, K4), then in the
    backward dgrad on the conv's own kernel and K6 for every conv, K7 for
    every pool and the K9a re-layout back for every re-layout, except
    where the tensor needs no gradient (the network input, up to the first
    conv).  The softmax's, the ReLUs' and the fc layers' gradients are
    plain arithmetic.  ``v`` is the storage variant's suffix (".bf16")."""
    want = Counter()
    grad = False       # whether the tensor at hand needs a gradient
    for kern, _ in layout_launches(cfg, layouts):
        want[kern + v] += 1
        if kern in ("conv_chwn", "conv_nchw"):
            want["wgrad" + v] += 1
            if grad:   # dgrad on the conv's kernel
                want[kern + v] += 1
            grad = True
        elif kern in ("pool_chwn", "pool_nchw") and grad:
            want[kern.replace("pool", "pool_backward") + v] += 1
        elif kern == "transpose2d" and grad:
            want[kern + v] += 1
    return dict(want)


def _step_counts(v: str) -> dict:
    """One step's launches read just after it, by kernel ("<kernel>.bf16"
    for a bf16 step); raises if a bf16 step launched a float32 kernel."""
    counts = _nonzero(K.launch_counts())
    if not v:
        return counts
    var = _nonzero(K.variant_launch_counts())
    if sum(var.values()) != sum(counts.values()):
        raise AssertionError(f"a bf16 step launched {counts}, of them "
                             f"narrow {var}")
    return var


def unfused_training_phase(dev):
    """The unfused training step on the card (``UNFUSED_TRAINED``): each
    network in its layouts, float32 and bf16, from the seed-0 weights (cast
    once to bf16) and a seeded input, ``TRAIN_STEPS`` SGD steps of
    ``make_train_step(impl="cuda")`` (autodiff of the unfused forward: bare
    K1/K2 and their dgrad, K6, K3 and K7, K9a both ways, K4), counts zeroed
    just before each step and read just after, equal to
    ``unfused_train_counts`` (a bf16 step's all bf16).  Held as the fused
    steps are: float32 losses within ``LOSS_ATOL`` of the torch engine's at
    the same parameters and step-1 gradients as ``_step1_gradients``
    says; bf16 losses within ``BF16_LOSS_TOL`` and gradients as
    ``_bf16_step1_gradients`` says.  Then one warm step on each engine and
    its peak device memory.  Runs outside inference mode.  These launches
    are checked here and not added to the kernels line (their dgrad and
    pool-backward shapes are not the fused path's)."""
    rows = []
    for network, batch, which in UNFUSED_TRAINED:
        cfg = CNN_CONFIGS[network].replace(batch=batch)
        layouts = (PlanCache(str(packaged_plans(network))).assignment(
            cfg, batch)[0].layouts if which == "packaged"
            else plan_network(cfg, which))
        sig = "".join(l[0] for l in layouts)
        loss = _unfused_loss(cfg, layouts)
        for dtype in ("float32", "bfloat16"):
            bf16 = dtype == "bfloat16"
            v, tol = (".bf16", BF16_LOSS_TOL) if bf16 else ("", LOSS_ATOL)
            label = f"unfused train {network} batch={batch} {dtype}"
            want = unfused_train_counts(cfg, layouts, v)
            params = params_from_numpy(init_cnn(cfg, 0), dev, dtype)
            rng = np.random.default_rng(4)
            x = torch.from_numpy(rng.standard_normal(
                input_shape(cfg), np.float32)).to(dev, torch_dtype(dtype))
            labels = torch.from_numpy(rng.integers(
                0, cfg.num_classes, batch)).to(dev)
            grad = (_bf16_step1_gradients if bf16 else _step1_gradients)(
                label, loss, params, x, labels)
            step = make_train_step(cfg, layouts, impl="cuda")
            p, vel, losses, same = params, init_velocity(params), [], []
            for _ in range(TRAIN_STEPS):
                with torch.no_grad():   # the torch engine at the same point
                    same.append(loss(p, x, labels, "torch").item())
                K.reset_launch_counts()
                p, vel, value = step(p, vel, x, labels)
                torch.cuda.synchronize()
                counts = _step_counts(v)
                if counts != want:
                    raise AssertionError(f"{label}: launches {counts} != the "
                                         f"layouts' {want}")
                losses.append(value.item())
            del p, vel
            diffs = [abs(a - b) for a, b in zip(losses, same)]
            if not all(math.isfinite(u) for u in losses + same):
                raise AssertionError(f"{label}: non-finite loss {losses}")
            if max(diffs) > tol:
                raise AssertionError(
                    f"{label}: losses {losses} differ from the torch "
                    f"engine's at the same parameters {same} by "
                    f"{max(diffs):.3g} > {tol}")
            warm = {impl: _step_ms_and_peak(
                make_train_step(cfg, layouts, impl=impl), params,
                init_velocity(params), x, labels)
                for impl in ("cuda", "torch")}
            row = {"network": network, "batch": batch, "dtype": dtype,
                   "layouts": sig, "losses": losses,
                   "torch_at_same_params": same, "loss_diffs": diffs,
                   "grad": grad, "launches": want, "warm": warm}
            rows.append(row)
            print(f"{label} layouts={sig} ({which}): losses kernels "
                  f"{losses}, torch engine at the same parameters {same} "
                  f"(max diff {max(diffs):.3g} <= {tol}); step-1 gradients "
                  f"{grad}; launches per step {want} (= the layouts'); "
                  f"warm step kernels {warm['cuda']['ms']:.3f} ms "
                  f"({1e3 * batch / warm['cuda']['ms']:.1f} img/s), torch "
                  f"engine (cuDNN, TF32 off) {warm['torch']['ms']:.3f} ms "
                  f"({1e3 * batch / warm['torch']['ms']:.1f} img/s); peak "
                  f"device memory of a step kernels "
                  f"{warm['cuda']['peak_bytes'] / 2**20:.1f} MiB, torch "
                  f"engine {warm['torch']['peak_bytes'] / 2**20:.1f} MiB",
                  flush=True)
            del params, x, labels
            torch.cuda.empty_cache()
    return rows


def mixed_training_phase(dev):
    """The mixed-dtype training step on the card (``MIXED_TRAINED``): the
    H100 planner's float32 "mixed" plan (int8 boundaries between convs),
    ``MIXED_TRAIN_STEPS`` SGD steps of ``make_train_step_fused`` on the
    kernels, each boundary ``fake_quant`` on the float32 carrier (the
    stored int8 value forward, the identity gradient), counts zeroed just
    before each step and read just after, equal to
    ``plan_train_launches``.  Gates (``MIXED_TRAINED`` says where they
    come from): every loss finite; the loss falls over the steps; the
    parameters stay float32; each loss within ``INT8_FORWARD_ATOL`` of the
    torch engine's over the same plan at the same parameters; the plan's
    inference forward on the kernels (real int8 into K1's int8->fp32
    build) within ``INT8_FORWARD_ATOL`` of the uniform float32 plan's.
    Reported: a warm step of the mixed plan and of the uniform plan on the
    kernels, and their peak device memory.  Runs outside inference mode;
    its launches are checked here and not added to the kernels line."""
    network, batch = MIXED_TRAINED
    label = f"mixed train {network} batch={batch}"
    cfg = CNN_CONFIGS[network].replace(batch=batch)
    plan = plan_network_fused(cfg, policy="mixed")
    uniform = plan_network_fused(cfg)
    if "8" not in plan.dtype_signature:
        raise AssertionError(f"{label}: the plan stores no int8 "
                             f"({plan.dtype_signature})")
    want = dict(Counter(k for k, _ in plan_train_launches(cfg, plan)))
    params = params_from_numpy(init_cnn(cfg, 0), dev)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(
        input_shape(cfg), np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes,
                                           batch)).to(dev)
    with torch.no_grad():
        ym, _ = forward_fused(params, x, cfg, plan)
        yu, _ = forward_fused(params, x, cfg, uniform)
    forward_diff = (ym - yu).abs().max().item()
    if not forward_diff <= INT8_FORWARD_ATOL:
        raise AssertionError(f"{label}: mixed probabilities {forward_diff:.3g}"
                             f" from the uniform ones > {INT8_FORWARD_ATOL}")
    step = make_train_step_fused(cfg, plan, impl="cuda")
    p, vel, losses, same = params, init_velocity(params), [], []
    for _ in range(MIXED_TRAIN_STEPS):
        with torch.no_grad():   # the torch engine at the same point
            same.append(loss_fn_fused(p, x, labels, cfg, plan,
                                      "torch").item())
        K.reset_launch_counts()
        p, vel, value = step(p, vel, x, labels)
        torch.cuda.synchronize()
        counts = _nonzero(K.launch_counts())
        if counts != want:
            raise AssertionError(f"{label}: launches {counts} != the plan's "
                                 f"{want}")
        if any(t.dtype != torch.float32 for q in p.values()
               for t in q.values()):
            raise AssertionError(f"{label}: a parameter left float32")
        losses.append(value.item())
    del p, vel
    diffs = [abs(a - b) for a, b in zip(losses, same)]
    if not all(math.isfinite(u) for u in losses + same):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss does not fall: {losses}")
    if max(diffs) > INT8_FORWARD_ATOL:
        raise AssertionError(
            f"{label}: losses {losses} differ from the torch engine's at "
            f"the same parameters {same} by {max(diffs):.3g} > "
            f"{INT8_FORWARD_ATOL}")
    vel0 = init_velocity(params)
    warm = {"mixed": _step_ms_and_peak(step, params, vel0, x, labels),
            "uniform": _step_ms_and_peak(
                make_train_step_fused(cfg, uniform), params, vel0, x,
                labels)}
    row = {"network": network, "batch": batch,
           "dtype_signature": plan.dtype_signature,
           "conv_layouts": plan.conv_signature, "losses": losses,
           "torch_at_same_params": same, "loss_diffs": diffs,
           "forward_diff_vs_uniform": forward_diff, "launches": want,
           "warm": warm}
    print(f"{label} (plan {plan.conv_signature}, dtypes "
          f"{plan.dtype_signature}, fake_quant at the int8 boundaries): "
          f"losses kernels {losses} (falls; finite; parameters float32), "
          f"torch engine at the same parameters {same} (max diff "
          f"{max(diffs):.3g} <= {INT8_FORWARD_ATOL}); inference "
          f"probabilities {forward_diff:.3g} from the uniform plan's (<= "
          f"{INT8_FORWARD_ATOL}); launches per step {want} (= the plan's); "
          f"warm step mixed {warm['mixed']['ms']:.3f} ms "
          f"({1e3 * batch / warm['mixed']['ms']:.1f} img/s), uniform "
          f"float32 {warm['uniform']['ms']:.3f} ms "
          f"({1e3 * batch / warm['uniform']['ms']:.1f} img/s); peak device "
          f"memory of a step mixed "
          f"{warm['mixed']['peak_bytes'] / 2**20:.1f} MiB, uniform "
          f"{warm['uniform']['peak_bytes'] / 2**20:.1f} MiB", flush=True)
    del params, x, labels
    torch.cuda.empty_cache()
    return row


def mesh_phase(dev, th):
    """The data-parallel serving mesh (``distributed.cnn_mesh``).  First
    ``devices=1``: AlexNet b128 through ``CNNServer(devices=1)`` and the
    default server, every answer bit-equal between them and to the
    kernels' forward of the plan on the padded batch.  Then, for each of
    ``MESHED``, a server over the mesh: two shards on the one card (a
    rehearsal of the split, pad and gather on the kernels), or every card
    where there is more than one.  The global batch is admitted in one
    step; its plan is the shard bucket's (``verify_shard_plan``); every
    answer is bit-equal to the per-shard forwards on the kernels and within
    ``PROBS_ATOL`` of the torch engine; the launches are the shards'
    (counted here, not added to the kernels line); ``hbm_bytes`` is
    ``per_chip_bytes`` times the shards.  Printed: which mesh ran, the
    server's img/s and per-card modeled MB, and the warm sharded forward
    beside two unsharded ones at the same global batch (CUDA events): the
    packaged plan a single-card server serves, and the plan the H100
    planner makes for the global batch (the shards' planner: only the
    split differs)."""
    n = torch.cuda.device_count()
    mesh = (tuple(torch.device("cuda", i) for i in range(n)) if n > 1
            else (dev, dev))
    what = (f"{n} cards" if n > 1 else
            "2 shards on the one card (a rehearsal)")
    rows = []
    network, batch = MESHED[0]
    servers = [CNNServer(network, reduced=False, max_bucket=batch, seed=0,
                         thresholds=th, **kw) for kw in ({"devices": 1}, {})]
    cfg = servers[0].cfg
    rng = np.random.default_rng(5)
    images = [rng.standard_normal((cfg.in_channels, cfg.image_hw,
                                   cfg.image_hw), np.float32)
              for _ in range(batch - 3)]
    answers = [srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
               for srv in servers]
    bucket = servers[0].cache.bucket(len(images))
    plan = servers[0].cache.peek_fused(cfg, bucket)
    y, _ = forward_fused(servers[0].model.params(), pad_to_bucket(
        torch.from_numpy(np.stack(images)).to(dev), bucket), cfg, plan)
    y = y.cpu().numpy()
    for i in range(len(images)):
        if not (np.array_equal(answers[0][i], answers[1][i])
                and np.array_equal(answers[0][i], y[i])):
            raise AssertionError(f"mesh devices=1 {network}: answer {i} is "
                                 "not bit-equal to the unsharded server's "
                                 "and the plan's forward")
    print(f"mesh devices=1 {network} batch={len(images)} (bucket {bucket}):"
          f" every answer bit-equal to the unsharded server's and to the "
          f"kernels' forward of its plan", flush=True)
    del servers, answers, y
    for network, batch in MESHED:
        d = len(mesh)
        shard = batch // d
        label = f"mesh {network} batch={batch} over {what}"
        srv = CNNServer(network, reduced=False, max_bucket=shard, seed=0,
                        thresholds=th, mesh=mesh)
        cfg, scfg = srv.cfg, srv.cfg.replace(batch=shard)
        rng = np.random.default_rng(6)
        images = [rng.standard_normal((cfg.in_channels, cfg.image_hw,
                                       cfg.image_hw), np.float32)
                  for _ in range(batch)]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        done = srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        served = _nonzero(K.launch_counts())
        rep = srv.reports[shard]
        plan = srv.cache.peek_fused(cfg, shard, devices=d, pre_sharded=True)
        verify_shard_plan(plan, cfg, shard, cost_model=srv.cache.cost_model)
        if rep.hbm_bytes != rep.per_chip_bytes * d:
            raise AssertionError(f"{label}: hbm_bytes {rep.hbm_bytes} != "
                                 f"{d} x per_chip_bytes {rep.per_chip_bytes}")
        x = torch.from_numpy(np.stack(images)).to(dev)
        replicas = replicate_params(srv.model.params(), mesh)
        shards = []
        for i, (sd, p) in enumerate(zip(mesh, replicas)):
            K.reset_launch_counts()
            with torch.cuda.device(sd):
                ys, _ = forward_fused(p, x[i * shard:(i + 1) * shard].to(sd),
                                      scfg, plan)
            torch.cuda.synchronize()
            one = _nonzero(K.launch_counts())
            shards.append(ys.to(dev))
        want = torch.cat(shards).cpu().numpy()
        if served != {k: d * v for k, v in one.items()}:
            raise AssertionError(f"{label}: launches {served} != {d} x a "
                                 f"shard's {one}")
        got = np.stack([done[i] for i in range(batch)])
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: answers not bit-equal to the "
                                 "per-shard forwards")
        # the unsharded plan of the global batch: the packaged one
        full = PlanCache(str(packaged_plans(network))).peek_fused(cfg, batch)
        yt, _ = forward_fused(srv.model.params(), x, cfg, full, impl="torch")
        err = float(np.abs(got - yt.cpu().numpy()).max())
        if err > PROBS_ATOL:
            raise AssertionError(f"{label}: answers {err:.3g} from the torch "
                                 f"engine > {PROBS_ATOL}")
        assert_clean(srv, label)
        h100 = plan_network_fused(cfg)
        sharded_ms = cuda_ms(lambda: forward_fused_sharded(
            replicas, x, scfg, plan, mesh), max_reps=20)
        single_ms = cuda_ms(lambda: forward_fused(
            srv.model.params(), x, cfg, full), max_reps=20)
        h100_ms = cuda_ms(lambda: forward_fused(
            srv.model.params(), x, cfg, h100), max_reps=20)
        per_chip_mb = rep.per_chip_bytes / rep.batches / 1e6
        row = {"network": network, "batch": batch, "mesh": what,
               "devices": d, "shard_bucket": shard,
               "conv_layouts": plan.conv_signature,
               "unsharded_conv_layouts": full.conv_signature,
               "planner_calls": srv.cache.planner_calls,
               "served_img_s": batch / wall, "per_chip_MB": per_chip_mb,
               "modeled_MB": rep.hbm_bytes / rep.batches / 1e6,
               "h100_conv_layouts": h100.conv_signature,
               "sharded_ms": sharded_ms, "unsharded_ms": single_ms,
               "unsharded_h100_ms": h100_ms,
               "launches": served, "max_abs_err": err}
        rows.append(row)
        print(f"{label}: shard bucket {shard} (plan {plan.conv_signature}, "
              f"the unsharded b{batch} plan {full.conv_signature}), served "
              f"{batch} in {wall:.3f}s ({batch / wall:.1f} img/s, host "
              f"clock, planning included), per_chip_MB={per_chip_mb:.1f} "
              f"modeled_MB={rep.hbm_bytes / rep.batches / 1e6:.1f}; "
              f"answers bit-equal to the per-shard forwards, "
              f"{err:.3g} from the torch engine; launches {served} (= {d} x "
              f"a shard's); warm forward sharded {sharded_ms:.3f} ms "
              f"({1e3 * batch / sharded_ms:.1f} img/s), unsharded on the "
              f"packaged plan {single_ms:.3f} ms "
              f"({1e3 * batch / single_ms:.1f} img/s), unsharded on the "
              f"H100 planner's b{batch} plan ({h100.conv_signature}, "
              f"{h100.stacked_convs} stacks; the shards' "
              f"{plan.stacked_convs}) {h100_ms:.3f} ms "
              f"({1e3 * batch / h100_ms:.1f} img/s)", flush=True)
        for line in srv.report_lines():
            print(line)
        del srv, replicas, x, shards
        torch.cuda.empty_cache()
    return rows


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


# -- the LM serving path (launch/serve.Server) -------------------------------

def _lm_requests(vocab: int):
    """``LM_PROMPTS`` seeded prompts in [0, vocab), ``LM_MAX_NEW`` tokens
    each."""
    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(0, vocab, size=(n,), dtype=np.int32)
               for n in LM_PROMPTS]
    return [LMRequest(i, p, max_new=LM_MAX_NEW)
            for i, p in enumerate(prompts)]


def _lm_check_run(srv, reqs, out, logits, held: str = LM_WHOLE,
                  prompt_only: bool = False) -> dict:
    """The served tokens in [0, V) and ``max_new`` of them each; each step's
    logits (prefill's, then every decode step's) against one teacher-forced
    ``forward`` over the left-padded prompts and the generated tokens, or,
    with ``prompt_only`` (an MoE model at its published capacity: the
    capacity follows the token count), prefill's against a forward over
    the prompts alone.  ``held`` ``LM_BLOCKS``: the gate is
    ``_lm_blockwise`` over the same tokens, and the whole model's
    deviation is kept as ``whole`` beside it.  Returns the served logits,
    the forward's at those positions and the deviation."""
    cfg = srv.cfg
    for r in reqs:
        got = out[r.rid]
        if len(got) != LM_MAX_NEW or not all(0 <= t < cfg.vocab_size
                                             for t in got):
            raise AssertionError(f"lm serve {cfg.name}: tokens {got}")
    if len(logits) != LM_MAX_NEW + 1:
        raise AssertionError(f"lm serve {cfg.name}: {len(logits)} steps")
    toks, S0 = _lm_tokens(srv, reqs, out)
    steps = 1 if prompt_only else LM_MAX_NEW + 1
    want = _lm_forward_logits(srv, toks, S0, steps)
    got = torch.stack(logits, dim=1)                 # [B, steps, V]
    if got.shape[:2] != (len(reqs), LM_MAX_NEW + 1) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"lm serve {cfg.name}: logits {got.shape}, "
                             f"or non-finite")
    dev = _lm_dev(got[:, :steps], want, cfg.dtype)
    if held == LM_BLOCKS:
        dev = {**_lm_blockwise(srv, toks, S0, steps),
               "whole": dev["rel_err" if cfg.dtype == "float32"
                            else "tol_share"]}
    return {"want": want, "got": got, **dev}


def _lm_tokens(srv, reqs, out):
    """[B, S0 + max_new] int32: the left-padded prompts, then the
    generated tokens; and S0."""
    prompts = srv.pad(reqs)
    gen = np.array([out[r.rid] for r in reqs], np.int32)
    return np.concatenate([prompts, gen], axis=1), prompts.shape[1]


def _lm_forward_logits(srv, toks, S0: int, steps: int, cfg=None):
    """The teacher-forced forward of ``cfg`` (the server's by default) on
    the server's weights over ``toks`` (``_lm_tokens``), cut to what the
    first ``steps`` served steps read; its logits at their positions."""
    cfg = cfg or srv.cfg
    B = toks.shape[0]
    tok = torch.from_numpy(np.ascontiguousarray(
        toks[:, :S0 + steps - 1])).to(srv.device)
    pos = torch.arange(tok.shape[1], device=srv.device)[None].expand(B, -1)
    h, _ = LMT.forward(srv.params, tok, pos, cfg, **srv.stubs(B))
    first = srv.front + S0 - 1
    return LMT.logits_fwd(srv.params, h[:, first:first + steps], cfg)


def _lm_dev(got, want, dtype) -> dict:
    """bf16: the largest |got - want| and its share of the decode tolerance
    (atol + rtol |want|), which must not pass 1; float32: the largest
    error scale-relative (``_scaled_err``), which must not pass
    ``LM_F32_TOL``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == "float32":
        rel = _scaled_err(got, want)
        return {"max_abs_err": err.max().item(), "rel_err": rel,
                "ok": rel <= LM_F32_TOL}
    rtol, atol = LM_DECODE_TOL
    share = (err / (atol + rtol * want.abs())).max().item()
    return {"max_abs_err": err.max().item(), "tol_share": share,
            "ok": share <= 1.0}


def _lm_blockwise(srv, toks, S0: int, steps: int) -> dict:
    """Each block held alone against the teacher-forced forward, so that no
    rounding compounds through depth: fed the forward's input to it over
    ``toks`` (``_lm_tokens``), the block's prefill over the first ``S0``
    positions, then ``steps - 1`` decode steps of one position each, every
    output against the block's forward output there (``_lm_dev``); the
    last block's outputs then through the final norm and the head, those
    logits against the forward's.  Returns the worst block's deviation
    (``block_*``: which block, its measure) and the head's (``_lm_dev``'s
    keys, ``ok`` for both)."""
    cfg, params = srv.cfg, srv.params
    if srv.front or cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the blockwise check takes a plain "
                         f"decoder")
    B, n = toks.shape[0], S0 + steps - 1
    tok = torch.from_numpy(np.ascontiguousarray(toks[:, :n])).to(srv.device)
    pos = torch.arange(n, device=srv.device)[None].expand(B, -1)
    layout = srv.kv_layout or "bksd"
    x = LMT.embed_tokens(params, tok, cfg)
    worst, key = None, "rel_err" if cfg.dtype == "float32" else "tol_share"
    for p_i, period in enumerate(params["blocks"]):
        for i, kind in enumerate(cfg.block_pattern):
            bp = period[f"b{i}"]
            want, _, _ = LMT._block_fwd(bp, kind, x, pos, cfg, "train")
            y, cache, _ = LMT._block_fwd(
                bp, kind, x[:, :S0], pos[:, :S0], cfg, "prefill",
                kv_layout=layout, max_len=srv.max_len)
            ys = [y]
            for t in range(S0, n):
                y, cache, _ = LMT._block_fwd(
                    bp, kind, x[:, t:t + 1], None, cfg, "decode",
                    cache=cache, cache_len=t, kv_layout=layout)
                ys.append(y)
            got = torch.cat(ys, dim=1)
            d = _lm_dev(got, want, cfg.dtype)
            if worst is None or d[key] > worst[key]:
                worst = {**d, "block": p_i * len(cfg.block_pattern) + i}
            x = want
    head = _lm_dev(LMT.logits_fwd(params, LML.norm_fwd(
        params["final_norm"], got[:, S0 - 1:], cfg), cfg),
        LMT.logits_fwd(params, LML.norm_fwd(
            params["final_norm"], want[:, S0 - 1:], cfg), cfg), cfg.dtype)
    return {**head, "ok": head["ok"] and worst["ok"],
            "block": worst["block"], f"block_{key}": worst[key]}


def _lm_step_fns(srv, reqs, layout: str) -> dict:
    """The server's own prefill of the batch and one decode step after it,
    in ``layout``, as functions to time."""
    prompts = srv.pad(reqs)

    def prefill():
        return srv.prefill(prompts, layout)

    logits, cache, cross = prefill()
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos = prompts.shape[1] + srv.front
    return {("prefill_ms", layout): prefill,
            ("decode_ms", layout): lambda: srv.decode(layout, cache, nxt, pos,
                                                      cross)}


def lm_generate(srv, cfg, prompts, max_new: int, layout: str, feed=None):
    """Generation through the port's own prefill and decode steps
    (``train/steps``) built for ``cfg`` on the server's weights (an MoE
    model at another capacity factor than the server's): greedy, or fed
    ``feed`` [B, max_new] (teacher forcing).  Returns the tokens
    [B, max_new] int32 (numpy) and each step's logits [B, max_new + 1, V]
    (prefill's first)."""
    B, S0 = prompts.shape
    prefill = make_lm_prefill_step(
        cfg, srv.parallel, ShapeConfig("serve", "prefill", srv.max_len, B),
        layout)
    decode = make_lm_decode_step(cfg, srv.parallel, layout)
    logits, cache = prefill(srv.params, {
        "tokens": torch.from_numpy(prompts).to(srv.device)})
    out, toks = [logits], []
    for t in range(max_new):
        tok = (torch.argmax(logits, dim=-1).to(torch.int32) if feed is None
               else torch.from_numpy(feed[:, t]).to(srv.device))
        toks.append(tok)
        logits, cache = decode(srv.params, cache, tok[:, None],
                               S0 + srv.front + t)
        out.append(logits)
    return torch.stack(toks, dim=1).cpu().numpy(), torch.stack(out, dim=1)


def lm_nodrop_run(srv, reqs, layout: str) -> dict:
    """An MoE model at the capacity factor E/k (cap = T: no token drops, so
    a forward over B x S tokens routes as prefill and decode do), on the
    server's weights through its own prefill and decode steps
    (``lm_generate``): greedy generation of ``reqs``, the teacher-forced
    forward over the prompts and those tokens, then the same tokens fed
    through prefill and decode again, each MoE layer dispatching to the
    experts the forward chose there (``layers.record_routes``).  Returns
    that run's logits (``got``) and the forward's (``want``), every step,
    and where a layer's own choice left the forward's: the (layer, token)
    pairs (``flips`` of ``pairs``) and the largest of the forward's router
    margins (k-th minus (k+1)-th probability) among them."""
    cfg = srv.cfg.replace(capacity_factor=srv.cfg.num_experts
                          / srv.cfg.experts_per_token)
    k = cfg.experts_per_token
    prompts = srv.pad(reqs)
    B, S0 = prompts.shape
    n = max(r.max_new for r in reqs)
    gen, _ = lm_generate(srv, cfg, prompts, n, layout)
    with LML.record_routes() as fwd:
        want = _lm_forward_logits(srv, np.concatenate([prompts, gen], 1),
                                  S0, n + 1, cfg)
    # the forward's choices and margins [B, S0 + n, ...] a layer, cut as
    # the served calls take them: prefill's a layer, then a step's a layer
    sel = [s.reshape(B, -1, k) for s, _ in fwd]
    top = [torch.topk(p, k + 1, dim=-1).values for _, p in fwd]
    gap = [(v[:, k - 1] - v[:, k]).reshape(B, -1) for v in top]

    def cut(per_layer):
        return ([a[:, :S0].reshape(B * S0, *a.shape[2:]) for a in per_layer]
                + [a[:, S0 + t] for t in range(n) for a in per_layer])

    lead, margins = cut(sel), cut(gap)
    with LML.record_routes(follow=list(lead)) as own:
        _, got = lm_generate(srv, cfg, prompts, n, layout, feed=gen)
    flips, margin = 0, 0.0
    for (mine, _), theirs, m in zip(own, lead, margins):
        d = (mine.sort(-1).values != theirs.sort(-1).values).any(-1)
        if bool(d.any()):
            flips += int(d.sum())
            margin = max(margin, m[d].max().item())
    return {"capacity_factor": cfg.capacity_factor, "tokens": B * (S0 + n),
            "cap": LML.moe_capacity(cfg, B * (S0 + n)), "got": got,
            "want": want, "flips": flips,
            "pairs": sum(mine.shape[0] for mine, _ in own),
            "flip_margin": margin}


def _lm_nodrop_gate(srv, layout: str) -> dict:
    """``lm_nodrop_run`` of ``_lm_requests``, every step held against the
    forward (``_lm_dev``); a layer's own choice may leave the forward's
    only in bf16, and there only at a router margin under
    ``LM_ROUTE_MARGIN``."""
    res = lm_nodrop_run(srv, _lm_requests(srv.cfg.vocab_size), layout)
    got, want = res.pop("got"), res.pop("want")
    res.update(_lm_dev(got, want, srv.cfg.dtype))
    res["ok"] &= (res["flips"] == 0 if srv.cfg.dtype == "float32"
                  else res["flip_margin"] < LM_ROUTE_MARGIN)
    if not res["ok"]:
        raise AssertionError(f"lm serve {srv.cfg.name} no-drop {layout}: "
                             f"{res}")
    return res


def _lm_cut(arch: str, periods) -> str:
    if periods == LM_REDUCED:
        return "reduced_config widths"
    if periods is None:
        return "whole, full width"
    return (f"cut to {periods} period{'s' if periods > 1 else ''}, full "
            f"width")


def _lm_serve_one(arch: str, periods, dtype, held: str, card: str) -> dict:
    """Serve ``_lm_requests`` through ``Server`` on the card (full width
    unless ``periods`` is ``LM_REDUCED``) in both KV layouts (bf16 with a
    KV cache: with times, peak memory and host tokens/s; float32, or no
    KV cache: the pick's layout only), each run held against the
    teacher-forced forward (``held``: ``_lm_check_run``), and the two
    layouts' logits against each other while their tokens agree.  An MoE
    model is served at its published capacity factor, where prefill is
    held against a forward over the prompts alone, then at the drop-free
    factor E/k (``_lm_nodrop_gate``)."""
    t0 = time.perf_counter()
    reduced = periods == LM_REDUCED
    srv = LMServer(arch, reduced=reduced, batch=len(LM_PROMPTS),
                   max_len=LM_MAX_LEN, periods=None if reduced else periods,
                   dtype=dtype, seed=LM_SEED)
    if srv.device.type != "cuda":
        raise AssertionError(f"lm serve {arch}: server on {srv.device}")
    cfg = srv.cfg
    init_s = time.perf_counter() - t0
    gb = sum(t.numel() * t.element_size()
             for _, t in leaves_with_path(srv.params)) / 1e9
    B = len(LM_PROMPTS)
    moe = cfg.num_experts > 0
    has_kv = any(kind.startswith("attn") for kind in cfg.block_pattern)
    pick = select_kv_layout(B, cfg.num_kv_heads, srv.max_len, cfg.head_dim,
                            dtype_bytes=torch_dtype(cfg.dtype).itemsize)
    layouts = (("bksd", "sbkd") if cfg.dtype != "float32" and has_kv
               else (pick,))
    runs = {}
    for layout in layouts:
        reqs = _lm_requests(cfg.vocab_size)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = srv.run(reqs, keep_logits=True, kv_layout=layout)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        launched = {k: v for k, v in K.launch_counts().items() if v}
        if launched:
            raise AssertionError(f"lm serve {arch}: the path is plain "
                                 f"torch, yet {launched} launched")
        with torch.inference_mode():
            run = _lm_check_run(srv, reqs, out, srv.logits, held,
                                prompt_only=moe)
        n_tok = sum(len(v) for v in out.values())
        run.update(tokens=out, host_s=host_s, tok_per_s=n_tok / host_s,
                   peak_gb=peak / 1e9)
        runs[layout] = run
    # prefill and a decode step of each layout, timed in turns (b2b_ms:
    # CUDA events, medians of 5 rounds)
    with torch.inference_mode():
        fns = {}
        for layout in runs:
            fns.update(_lm_step_fns(srv, _lm_requests(cfg.vocab_size),
                                    layout))
        for (what, layout), ms in b2b_ms(fns).items():
            runs[layout][what] = ms
        del fns
    res = {"arch": arch, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "card": card, "params_gb": gb, "init_s": init_s, "pick": pick,
           "vocab": cfg.vocab_size, "d_model": cfg.d_model,
           "cut": _lm_cut(arch, periods), "moe": moe, "held": held}
    if len(runs) == 2:
        a, b = runs["bksd"], runs["sbkd"]
        same = 0          # leading generated tokens both layouts agree on
        while same < LM_MAX_NEW and all(
                a["tokens"][i][:same + 1] == b["tokens"][i][:same + 1]
                for i in range(B)):
            same += 1
        # step t's logits (0: prefill's) follow generated tokens 0 .. t - 1
        cross = _lm_dev(a["got"][:, :same + 1], b["got"][:, :same + 1],
                        cfg.dtype)
        res.update(layouts_agree=cross, steps_compared=same + 1,
                   faster=min(runs, key=lambda k: runs[k]["decode_ms"]))
    for layout, run in runs.items():
        del run["want"], run["got"]
        res[layout] = run
    bad = [k for k, r in runs.items() if not r["ok"]]
    if bad or not res.get("layouts_agree", {"ok": True})["ok"]:
        raise AssertionError(f"lm serve {arch} {cfg.dtype}: {res}")
    if moe:
        with torch.inference_mode():
            res["nodrop"] = {layout: _lm_nodrop_gate(srv, layout)
                             for layout in layouts}
        launched = {k: v for k, v in K.launch_counts().items() if v}
        if launched:
            raise AssertionError(f"lm serve {arch}: {launched} launched")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _lm_line(res: dict) -> str:
    head = (f"lm serve {res['arch']} ({res['layers']} layers, {res['cut']}, "
            f"d_model {res['d_model']}, vocab {res['vocab']}) "
            f"{res['dtype']} [{res['card']}]: params {res['params_gb']:.3f} "
            f"GB (init {res['init_s']:.1f}s); B={len(LM_PROMPTS)} prompts "
            f"{'/'.join(map(str, LM_PROMPTS))} +{LM_MAX_NEW}; "
            f"select_kv_layout picks {res['pick']}")
    if "faster" in res:
        head += f", faster by decode {res['faster']}"
    parts = [head]
    vs = ("prefill vs forward over the prompts" if res["moe"] else
          "each block alone vs forward" if res["held"] == LM_BLOCKS else
          "vs forward")
    rtol, atol = LM_DECODE_TOL
    for layout in ("bksd", "sbkd"):
        if layout not in res:
            continue
        r = res[layout]
        times = (f"prefill {r['prefill_ms']:.3f} ms, decode "
                 f"{r['decode_ms']:.3f} ms a step ({len(LM_PROMPTS)} "
                 f"tokens), ")
        if "rel_err" in r:
            dev = (f"{vs} {r.get('block_rel_err', r['rel_err']):.3g} "
                   f"scale-relative (gate {LM_F32_TOL:g})")
        else:
            dev = (f"{vs} {r.get('block_tol_share', r['tol_share']):.3f} of "
                   f"atol {atol} + rtol {rtol} |want|")
        if "block" in r:
            logit = r.get("rel_err", r.get("tol_share"))
            dev += (f" (worst block {r['block']}); the head on the last "
                    f"block's outputs {logit:.3g}; the whole model, "
                    f"compounding through depth (no gate) "
                    f"{r['whole']:.3g}")
        else:
            dev += f", max |err| {r['max_abs_err']:.4g}"
        parts.append(f"  {layout}: {times}Server.run {r['tok_per_s']:.1f} "
                     f"tok/s (host clock, {r['host_s']:.3f}s), peak "
                     f"{r['peak_gb']:.2f} GB; {dev}")
    if "layouts_agree" in res:
        c = res["layouts_agree"]
        parts.append(f"  bksd vs sbkd over {res['steps_compared']} steps "
                     f"whose tokens agree: max |err| {c['max_abs_err']:.4g}, "
                     f"{c['tol_share']:.3f} of the tolerance")
    for layout, n in res.get("nodrop", {}).items():
        share = (f"{n['rel_err']:.3g} scale-relative" if "rel_err" in n
                 else f"{n['tol_share']:.3f} of the tolerance")
        parts.append(
            f"  drop-free (capacity_factor {n['capacity_factor']:g}, cap "
            f"{n['cap']} of the forward's {n['tokens']} tokens) {layout}, "
            f"dispatching as the forward: every step vs forward {share}; "
            f"own expert choices left the forward's at {n['flips']} of "
            f"{n['pairs']} (layer, token) pairs, largest router margin "
            f"{n['flip_margin']:.2e} (gate {LM_ROUTE_MARGIN:g}, float32 "
            f"none)")
    return "\n".join(parts)


def lm_mixer_phase(card: str) -> list:
    """The full-width mixers alone, bf16, on seeded weights and inputs
    (B = 4, the longest prompt and 16 more positions): jamba's Mamba
    mixer, ``mamba_fwd`` with its state over the prompt then
    ``mamba_decode`` step by step, against ``mamba_fwd`` over the whole
    sequence (the decode tolerance; its float32 state scale-relative);
    rwkv6's time mix's WKV, ``_wkv_scan`` against
    ``_wkv_chunked_parallel`` in chunks of ``LM_WKV_CHUNK`` (the
    reference's own 5e-3), the bonus ``u`` drawn (its init is 0)."""
    dev = torch.device("cuda")
    B, S0, n = len(LM_PROMPTS), max(LM_PROMPTS), LM_MAX_NEW
    rtol, atol = LM_DECODE_TOL
    out = []
    with torch.inference_mode():
        cfg = get_config("jamba_1p5_large_398b")
        gen = torch.Generator(device=dev).manual_seed(LM_SEED)
        p = LMM.init_mamba(gen, cfg, dev)
        x = torch.randn((B, S0 + n, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        whole, st_whole = LMM.mamba_fwd(p, x, cfg, return_state=True)
        y0, st = LMM.mamba_fwd(p, x[:, :S0], cfg, return_state=True)
        ys = [y0]
        for t in range(S0, S0 + n):
            y, st = LMM.mamba_decode(p, x[:, t:t + 1], st, cfg)
            ys.append(y)
        got = torch.cat(ys, dim=1).float()
        want = whole.float()
        share = ((got - want).abs() / (atol + rtol * want.abs())).max().item()
        ssm_err = _scaled_err(st["ssm"], st_whole["ssm"])
        ms = b2b_ms({"prefill": lambda: LMM.mamba_fwd(
                        p, x[:, :S0], cfg, return_state=True),
                     "decode": lambda: LMM.mamba_decode(
                        p, x[:, S0:S0 + 1], st, cfg)})
        gb = sum(t.numel() * t.element_size() for t in p.values()) / 1e9
        res = {"mixer": "mamba", "arch": cfg.name, "params_gb": gb,
               "d_inner": cfg.mamba_d_inner, "d_state": cfg.mamba_d_state,
               "dt_rank": LMM.dt_rank(cfg), "tol_share": share,
               "max_abs_err": (got - want).abs().max().item(),
               "ssm_rel_err": ssm_err, "prefill_ms": ms["prefill"],
               "decode_ms": ms["decode"], "card": card,
               "finite": bool(torch.isfinite(got).all())}
        out.append(res)
        print(f"lm mixer mamba ({cfg.name}: d_model {cfg.d_model}, d_inner "
              f"{cfg.mamba_d_inner}, d_state {cfg.mamba_d_state}, dt_rank "
              f"{res['dt_rank']}, {gb:.3f} GB) bf16 [{card}]: mamba_fwd over "
              f"{S0} then {n} mamba_decode steps vs mamba_fwd over "
              f"{S0 + n}: max |err| {res['max_abs_err']:.4g}, {share:.3f} "
              f"of atol {atol} + rtol {rtol} |want|; final ssm state "
              f"{ssm_err:.3g} scale-relative; prefill {ms['prefill']:.3f} "
              f"ms, decode {ms['decode']:.3f} ms a step (B={B})",
              flush=True)
        if not res["finite"] or share > 1 or ssm_err > rtol:
            raise AssertionError(f"lm mixer mamba: {res}")
        del p, x, whole, st_whole, st, ys, got, want

        cfg = get_config("rwkv6_7b")
        gen = torch.Generator(device=dev).manual_seed(LM_SEED)
        p = LMR.init_rwkv_time(gen, cfg, dev)
        H, N = LMR._heads(cfg)
        u = torch.randn((H, N), generator=gen, device=dev) * 0.1
        x = torch.randn((B, S0 + n, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        r, k, v, w, _ = LMR._time_inputs(p, x, cfg)
        s0 = torch.zeros((B, H, N, N), device=dev)
        fns = {"scan": lambda: LMR._wkv_scan(r, k, v, w, u, s0,
                                             LM_WKV_CHUNK),
               "chunked": lambda: LMR._wkv_chunked_parallel(
                   r, k, v, w, u, s0, LM_WKV_CHUNK)}
        (y1, s1), (y2, s2) = fns["scan"](), fns["chunked"]()
        share = max(((a - b).abs() / (LM_WKV_TOL + LM_WKV_TOL * b.abs())
                     ).max().item() for a, b in ((y2, y1), (s2, s1)))
        ms = b2b_ms(fns)
        res = {"mixer": "wkv", "arch": cfg.name, "heads": H,
               "head_dim": N, "tol_share": share,
               "max_abs_err": max((y2 - y1).abs().max().item(),
                                  (s2 - s1).abs().max().item()),
               "max_abs": y1.abs().max().item(), "scan_ms": ms["scan"],
               "chunked_ms": ms["chunked"], "card": card,
               "finite": bool(torch.isfinite(y2).all())}
        out.append(res)
        print(f"lm mixer wkv ({cfg.name}: {H} heads of {N}, B={B}, S="
              f"{S0 + n}, chunks of {LM_WKV_CHUNK}) [{card}]: "
              f"_wkv_chunked_parallel vs _wkv_scan max |err| "
              f"{res['max_abs_err']:.4g} (|y| up to {res['max_abs']:.4g}), "
              f"{share:.3f} of rtol/atol {LM_WKV_TOL:g}; scan "
              f"{ms['scan']:.3f} ms, chunked {ms['chunked']:.3f} ms",
              flush=True)
        if not res["finite"] or share > 1:
            raise AssertionError(f"lm mixer wkv: {res}")
        del p, x, r, k, v, w, y1, y2, s1, s2, fns
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_serve_phase(card: str) -> dict:
    """The LM serving path, ``launch/serve.Server`` on the card
    (``LM_SERVED``, each model freed before the next): qwen2-7b whole,
    gemma2-27b cut to ``LM_GEMMA_PERIODS`` periods, whisper-base whole, in
    bf16, and qwen2-7b whole in float32; rwkv6-7b whole, dbrx-132b cut to
    ``LM_DBRX_PERIODS`` periods in bf16 and float32, llama4-maverick cut
    to ``LM_LLAMA4_PERIODS`` period and jamba-1.5-large at
    ``reduced_config``'s widths, in bf16.  Each serves ``_lm_requests``
    (4 seeded prompts of ``LM_PROMPTS`` tokens, ``LM_MAX_NEW`` new tokens
    each) in both KV layouts (one where there is no KV cache or in
    float32); every step's logits are held against one teacher-forced
    forward (bf16: the reference's decode tolerance ``LM_DECODE_TOL``;
    float32: ``LM_F32_TOL`` scale-relative), rwkv6-7b whole block by
    block (``_lm_blockwise``), and the two layouts against each other;
    an MoE model as ``_lm_serve_one`` says.  Then the
    full-width mixers alone (``lm_mixer_phase``).  The path is plain
    torch (the reference's is plain jnp): no kernel of the port may
    launch in it.  TF32 is off, and so are bf16 reduced-precision
    reductions, within this phase only: cuBLAS may add a bf16 product's
    split-K partials in bf16, where the reference adds in float32; the
    earlier phases' library times keep torch's default."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        print(f"lm serve: allow_tf32={mm.allow_tf32}, "
              f"allow_bf16_reduced_precision_reduction="
              f"{mm.allow_bf16_reduced_precision_reduction} [{card}]",
              flush=True)
        done = []
        for arch, periods, dtype, held in LM_SERVED:
            t0 = time.perf_counter()
            res = _lm_serve_one(arch, periods, dtype, held, card)
            res["seconds"] = time.perf_counter() - t0
            print(_lm_line(res) + f" [{res['seconds']:.1f}s]", flush=True)
            done.append(res)
        K.reset_launch_counts()
        mixers = lm_mixer_phase(card)
        launched = {k: v for k, v in K.launch_counts().items() if v}
        if launched:
            raise AssertionError(f"lm mixers: {launched} launched")
        return {"served": done, "mixers": mixers}
    finally:
        mm.allow_bf16_reduced_precision_reduction = saved


def tensor_core_line(label: str, rows, peak: str = "fp32",
                     design: str = "3xtf32") -> str:
    """One tensor-core kernel (K1, K5b, K6, K10, K12) summed over the main
    path's launches: ms, TFLOP/s (direct FLOPs; where the rows know what
    the kernel executed, also the executed rate), the bound on the
    ``peak`` named (fp32, or bf16 for a bf16 build) and the design's own
    (``design``: 3xTF32, three TF32 products at 495 TFLOP/s; K6 bf16's one
    bf16 product a term, "bf16", its peak bound; K5b bf16's one a conv1
    term and three a conv2 term, "bf16_split3"), the library time and the
    largest error scale-relative to float64."""
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
            f"bound_{peak}_ms={tot('bound_ms'):.3f} "
            + (f"bound_{design}_ms={tot('design_bound_ms'):.3f} "
               if design != peak else "")
            + f"library_ms={tot('library_ms'):.3f} "
            f"max_rel_err={max(r['f64_err'] for r in rows):.3g}")


def kernels_line(cases, launches) -> dict:
    """One entry per kernel: times and bound summed over the main path's
    launches (each distinct launch timed once, times its multiplicity).  A
    kernel off the path (``OFF_PATH``) shows 0 launches and the times of
    its one case."""
    out = []
    for kern, meta in KERNELS.items():
        rows = [r for r in cases if r["kernel"] == kern]
        launches.setdefault(kern, 0)
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

        def weight(r):   # a calibration-only variant: its one case
            return 1 if r.get("one_case") else (r["launches"] or 1)

        def total(key):
            return sum(r[key] * weight(r) for r in rows)

        t_ops = sum(r["flops"] * weight(r)
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
        if all("library_device_ms" in r for r in rows):
            entry["library_device_ms"] = total("library_device_ms")
        if all("twin_ms" in r for r in rows):
            # the int8 stacks: their float twin on the same values
            entry["twin_ms"] = total("twin_ms")
        if all("median5" in r for r in rows):
            # back to back again: the median of 5 rounds in turns with the
            # plain version and the library call (``b2b_ms``)
            entry["median5"] = {
                k: sum(r["median5"][k] * (r["launches"] or 1) for r in rows)
                for k in rows[0]["median5"]}
        if all("design_bound_ms" in r for r in rows):
            # the bound of the kernel's own arithmetic (3xTF32: three TF32
            # products per fp32 one on the tensor cores; K6 bf16's one bf16
            # product; K5b bf16's one a conv1 term, three a conv2 term)
            design = rows[0].get("design", "3xtf32")
            entry[f"bound_{design}_ms"] = total("design_bound_ms")
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
    lib = _build.build(log=ptxas, variants=_build.ALL_VARIANTS)
    for variant in _build.ALL_VARIANTS:
        _build.library(variant)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f}s -> {lib.relative_to(REPO)}", flush=True)

    with torch.inference_mode():
        t0 = time.perf_counter()
        cases = kernel_phase(dev)
        k3a_fp32_shapes = pool_bf16_fp32_shapes(cases, dev, "pool_chwn", "K3a")
        k3b_fp32_shapes = pool_bf16_fp32_shapes(cases, dev, "pool_nchw", "K3b")
        x_pool = torch.randn(8, 32, 32, 8, device=dev).to(torch.bfloat16)
        pool_host = pool_host_steps(x_pool, 2, 2, "max")
        print("pool host_us (K3a bf16, unet_mini's first pool): " + " ".join(
            f"{k}={v:.3f}" for k, v in pool_host.items()), flush=True)
        print(f"kernel phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        fig13 = fig13_phase(dev)
        variants = softmax_variants(dev)
        print(f"fig13 phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        th, calib = calibration_sweep(dev)
        print(f"calibration: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        launches, serving = serving_phase(dev, th)
        print(f"serving phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        dtype_counts, calib_counts, dtyped = dtype_phase(dev)
        for k, v in dtype_counts.items():
            launches[k] = launches.get(k, 0) + v
        for r in cases:
            if r.get("one_case"):
                r["launches"] = launches[r["kernel"]] = calib_counts.get(
                    r["kernel"], 0)
        print(f"dtype phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        planner_counts, planner = planner_phase(dev, th)
        planner["calibration"] = calib
        for k, v in planner_counts.items():
            launches[k] += v
        print(f"planner phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        int8 = next(r["rows"]["int8"] for r in dtyped
                    if "int8" in r["rows"])
        resilience = resilience_phase(dev, th, Thresholds(Ct=int8["Ct"],
                                                          Nt=int8["Nt"]))
        print(f"resilience phase: {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        compared = stack_compare(dev, th)
        print(f"stack comparison: {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        meshed = mesh_phase(dev, th)
        print(f"mesh phase: {time.perf_counter() - t0:.1f}s", flush=True)
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
        print(tensor_core_line("K5b bf16", [
            r for r in cases if r["kernel"] == "conv_stack_nchw.bf16"],
            peak="bf16", design="bf16_split3"), flush=True)
    # autograd needs tensors made outside inference mode
    t0 = time.perf_counter()
    train_counts, trained = training_phase(dev)
    for k, v in train_counts.items():
        launches[k] += v
    print(f"training phase: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    bf16_counts, bf16_trained = bf16_training_phase(dev)
    for k, v in bf16_counts.items():
        launches[k] = launches.get(k, 0) + v
    print(f"bf16 training phase: {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    unfused_trained = unfused_training_phase(dev)
    print(f"unfused training phase: {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    mixed_trained = mixed_training_phase(dev)
    print(f"mixed training phase: {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    runner = runner_phase(dev)
    print(f"runner phase: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    lm_served = lm_serve_phase(card)
    print(f"lm serve phase: {time.perf_counter() - t0:.1f}s", flush=True)
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
                                   "bf16_training": bf16_trained,
                                   "unfused_training": unfused_trained,
                                   "mixed_training": mixed_trained,
                                   "mesh": meshed,
                                   "dtype": dtyped,
                                   "serving": serving,
                                   "resilience": resilience,
                                   "runner": runner,
                                   "lm_serve": lm_served,
                                   "k3a_bf16_fp32_shapes": k3a_fp32_shapes,
                                   "k3b_bf16_fp32_shapes": k3b_fp32_shapes,
                                   "pool_host_us": pool_host,
                                   "ptxas": ptxas.getvalue()}, indent=1))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
