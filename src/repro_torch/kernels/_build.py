"""Build and load the port's CUDA kernels.

Every ``*.cu`` in a ``csrc`` directory under ``repro_torch/kernels`` is
compiled by ``nvcc`` for Hopper (``sm_90a``) into ONE shared library with a
plain C interface, loaded with ``ctypes``.  No source includes PyTorch's
headers, so the build takes seconds, not minutes.  The sources compile in
parallel (one ``nvcc -c`` each, all started together) and link once.

The build happens at first use, never at import (importing the package
must work on a machine without ``nvcc``), into
``<checkout>/build/repro_torch/<hash>/`` where the hash covers every
source and the flags, so an edited source rebuilds and an unchanged one
loads the cached library.  Each C entry point takes its pointers and the
CUDA stream as ``void*`` and returns ``cudaGetLastError()`` as an int.

The serving and training paths' kernels also take narrow storage dtypes
(K1, K2 and the stacks K5a/K5b: bf16, and int8 x with float32 or bf16
weights; the softmax K4 and cross entropy K8, the pools K3a/K3b and their
backwards K7a/K7b, the transposes K9a/K9b and the weight gradient K6:
bf16).  Each
such variant (``VARIANTS``) is the same source compiled again with
``-DREPRO_VARIANT_<NAME>``, which defines the variant's entry points,
``<entry>_<variant>``, into a library of its own.  A variant's library
builds the first time a launch needs it (``library(variant)``), so a
float32 run never compiles them; ``build(variants=ALL_VARIANTS)`` compiles
every library at once, one ``nvcc`` a (source, variant), all in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_ROOT = _KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
LIB_NAME = "libreprotorch_kernels.so"

P, I = ctypes.c_void_p, ctypes.c_int
L, F = ctypes.c_longlong, ctypes.c_float
# C signature of every entry point: name -> argtypes (restype is int)
SIGNATURES: Dict[str, List] = {
    # x, w, bias, res, y, z, N, Ci, H, W, Co, F, S, pad, pool_F, pool_S,
    # pool_avg, relu, src_nchw, dst_nchw, res_nchw, then K1: bm, nb, ph, pw,
    # stream; K2: bm, nb, uth, utw, tr, ga, stats, stream
    "conv_chwn_forward": [P] * 6 + [I] * 19 + [P],
    "conv_nchw_forward": [P] * 6 + [I] * 21 + [P, P],
    # x, g, ws, dw, N, Ci, H, W, Co, F, S, pad, x_nchw, g_nchw, bm, bn,
    # p_per_split, splits, stream
    "wgrad_forward": [P] * 4 + [I] * 14 + [P],
    # x, w1, b1, w2, b2, res, y, N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2,
    # P2, pool_F, pool_S, pool_avg, relu1, relu2, src_nchw, dst_nchw,
    # res_nchw, bm, nb, uth, utw, [cluster,] stats, stream
    "conv_stack_chwn_forward": [P] * 7 + [I] * 25 + [P, P],
    "conv_stack_nchw_forward": [P] * 7 + [I] * 24 + [P, P],
    # N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool_F, pool_S, bm, nb,
    # uth, utw, cluster, out
    "conv_stack_chwn_max_clusters": [I] * 19 + [ctypes.POINTER(I)],
    # x, y, rows, cols, stream
    "softmax_forward": [P, P, I, I, P],
    # x, labels, loss, rows, cols, stream
    "softmax_xent_forward": [P, P, P, I, I, P],
    # x, y, N, C, H, W, F, S, avg, dst_nchw, stream
    "pool_chwn_forward": [P, P] + [I] * 8 + [P],
    "pool_nchw_forward": [P, P] + [I] * 8 + [P],
    # x, g, dx, N, C, H, W, F, S, avg, relu_mask, g_nchw, then K7a: band,
    # win_rows, stream; K7b: planes, band, win_rows, stream
    "pool_backward_chwn": [P] * 3 + [I] * 11 + [P],
    "pool_backward_nchw": [P] * 3 + [I] * 12 + [P],
    # x, y, B, M, N, stream
    "transpose_forward": [P, P, I, I, I, P],
    # x, y, out, ws, M, N, K, sxm, sxk, syk, syn, bf16, bm, bn,
    # k_per_split, splits, stream
    "matmul_forward": [P] * 4 + [I] * 3 + [L] * 4 + [I] * 5 + [P],
    # q, k, v, out, BH, Sq, Sk, D, causal, scale, bf16, stream
    "flash_attention_forward": [P] * 4 + [I] * 5 + [F, I, P],
    # h, table, labels, ws, loss, T, V, D, softcap, tiles_per_split,
    # splits, bf16, stream
    "xent_forward": [P] * 5 + [I] * 3 + [F] + [I] * 3 + [P],
}

# the storage-dtype variants: variant -> (its sources, relative to this
# directory, and the entry points each defines with the suffix _<variant>)
# the conv kernels that take int8 x too: K1, K2 and the stacks K5a, K5b
_CONV = ("conv/csrc/conv_chwn.cu", "conv/csrc/conv_nchw.cu",
         "conv/csrc/conv_stack_chwn.cu", "conv/csrc/conv_stack_nchw.cu")
_CONV_ENTRIES = ("conv_chwn_forward", "conv_nchw_forward",
                 "conv_stack_chwn_forward", "conv_stack_chwn_max_clusters",
                 "conv_stack_nchw_forward")
VARIANTS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "bf16": (_CONV + ("conv/csrc/wgrad.cu", "softmax/csrc/softmax.cu",
                      "pool/csrc/pool.cu", "pool/csrc/pool_backward.cu",
                      "transpose/csrc/transpose.cu"),
             _CONV_ENTRIES + ("wgrad_forward", "softmax_forward",
                              "softmax_xent_forward", "pool_chwn_forward",
                              "pool_nchw_forward", "pool_backward_chwn",
                              "pool_backward_nchw", "transpose_forward")),
    "i8f32": (_CONV, _CONV_ENTRIES),     # int8 x, float32 w
    "i8bf16": (_CONV, _CONV_ENTRIES),    # int8 x, bf16 w
}
ALL_VARIANTS = ("",) + tuple(VARIANTS)   # "" is the float32 library

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Dict[str, object]] = {}   # variant -> name -> entry
_F32, _BF16, _I8 = torch.float32, torch.bfloat16, torch.int8
_MAX_NUMEL = 2 ** 31     # the kernels index with 32-bit ints
# the (x, w) storage dtypes of the conv kernels K1, K2, K5a and K5b -> the
# variant that computes them: biases, residual and output are w's dtype
CONV_VARIANTS = {(_F32, _F32): "", (_BF16, _BF16): "bf16",
                 (_I8, _F32): "i8f32", (_I8, _BF16): "i8bf16"}
# the storage dtypes of a float kernel (K3, K4, K6's inputs, K7, K8's
# logits, K9), every tensor x's
FLOAT_VARIANTS = {_F32: "", _BF16: "bf16"}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error: the launch was refused or
    failed, and no result was written."""


# faults of the card's kernels themselves: no fallback or restart steps
# over them (the guarded server and the fault-tolerant runner re-raise)
KERNEL_ERRORS = (KernelBuildError, KernelLaunchError)


def _csrc(suffix: str) -> List[Path]:
    return sorted(p for p in _KERNELS_DIR.rglob(f"*{suffix}")
                  if p.parent.name == "csrc")


def sources() -> List[Path]:
    return _csrc(".cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels build only on a machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources() + _csrc(".cuh"):
        h.update(p.relative_to(_KERNELS_DIR).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_name(variant: str) -> str:
    return LIB_NAME if not variant else LIB_NAME.replace(
        ".so", f"_{variant}.so")


def _units(variant: str) -> List[Tuple[Path, List[str]]]:
    """The (source, extra nvcc flags) compiled into ``variant``'s library;
    every library holds ``errors.cu`` (the error text ``check`` reads)."""
    if not variant:
        return [(src, []) for src in sources()]
    flag = f"-DREPRO_VARIANT_{variant.upper()}"
    errors = _KERNELS_DIR / "csrc" / "errors.cu"
    return [(errors, [])] + [(_KERNELS_DIR / rel, [flag])
                             for rel in VARIANTS[variant][0]]


def build(log: Optional[TextIO] = None,
          variants: Sequence[str] = ("",)) -> Path:
    """Compile and link the library of each of ``variants`` ("" is the
    float32 library, the others ``VARIANTS``), every source of all of them
    in parallel; returns the path of the first one's.  A cached library
    with the same source hash is reused.  With ``log``, each kernel's
    registers, shared memory and spills (``ptxas -v``) are written to it."""
    out_dir = BUILD_ROOT / source_hash()
    paths = {v: out_dir / _lib_name(v) for v in variants}
    todo = [v for v in variants if not paths[v].exists()]
    if not todo:
        return paths[variants[0]]
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # a private scratch dir per build: concurrent builders never share
    # object files, and each finished library lands by atomic rename
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        extra = ["-Xptxas", "-v"] if log is not None else []
        procs = {v: [] for v in todo}
        for v in todo:
            for i, (src, flags) in enumerate(_units(v)):
                obj = Path(tmp) / f"{v or 'f32'}_{i}_{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, *extra, *flags, "-c", str(src),
                       "-o", str(obj)]
                procs[v].append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        errors, logs = [], []
        for v in todo:
            for src, _, proc in procs[v]:
                out, _ = proc.communicate()
                logs.append(out)
                if proc.returncode != 0:
                    errors.append(f"{src.name} ({v or 'float32'}):\n{out}")
        if errors:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
        for v in todo:
            tmp_lib = Path(tmp) / _lib_name(v)
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                 *[str(obj) for _, obj, _ in procs[v]]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
            os.replace(tmp_lib, paths[v])
        if log is not None:
            log.write("".join(logs))
    return paths[variants[0]]


def library(variant: str = "") -> ctypes.CDLL:
    """The loaded library of ``variant`` ("" for float32; built on first
    call)."""
    lib = _libs.get(variant)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build(variants=(variant,))))
    names = VARIANTS[variant][1] if variant else SIGNATURES
    for name in names:
        fn = getattr(lib, f"{name}_{variant}" if variant else name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    _libs[variant] = lib
    return lib


def entry(name: str, variant: str = ""):
    """The C entry point ``name`` of ``variant``'s library (the float32
    one for ""), looked up once (a launch's host path: two dict reads)."""
    try:
        return _entries[variant][name]
    except KeyError:
        fn = getattr(library(variant), f"{name}_{variant}" if variant
                     else name)
        _entries.setdefault(variant, {})[name] = fn
        return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        lib = _libs.get("") or next(iter(_libs.values()))
        what = lib.cuda_error_string(err).decode()
        raise KernelLaunchError(f"{name}: CUDA launch failed: {what} "
                                f"({err})")


def on_cpu(name: str, x) -> bool:
    """True for a CPU tensor (the wrapper runs the plain version), False for
    a CUDA tensor (it launches the kernel); any other device raises.  Two
    flag reads, no ``torch.device`` object: a launch runs this first."""
    if x.is_cuda:
        return False
    if x.is_cpu:
        return True
    raise ValueError(f"{name}: tensors on {x.device} are not supported "
                     "(CUDA runs the kernel, CPU the plain version)")


def _refuse_dtype(name: str, arg: str, t, device: int, want: str,
                  dtype_ok: bool) -> None:
    """Raise the reason ``t`` fails its kernel's guard: another card, a
    dtype other than ``want`` describes (``dtype_ok`` False), not
    contiguous, or 2^31 elements or more."""
    if t.get_device() != device:
        raise ValueError(f"{name}: {arg} is on {t.device}, x on "
                         f"cuda:{device}")
    if not dtype_ok:
        raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                        f"{want}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
    raise ValueError(f"{name}: {arg} has {t.numel()} elements; the kernel "
                     "indexes with 32-bit ints")


def require_cuda_storage(name: str, x, **others) -> Tuple[int, str]:
    """The guard of the float kernels that take bf16 too (K3, K4, K6, K7,
    K8, K9): raise unless the CUDA tensor ``x`` is a contiguous float32 or
    bfloat16 tensor with fewer than 2^31 elements and every other given
    tensor (None is skipped) one of x's dtype on x's card.  Returns (the
    card's index, ``x.get_device()``, for ``stream_of``, and the variant:
    "" or "bf16").  One combined test a tensor, on ints and flags, not
    ``torch.device`` objects; the reason is worked out only for a tensor
    that fails it."""
    device = x.get_device()
    dt = x.dtype
    variant = "" if dt is _F32 else FLOAT_VARIANTS.get(dt)
    if variant is None or not (x.is_contiguous()
                               and x.numel() < _MAX_NUMEL):
        _refuse_dtype(name, "x", x, device, "float32 or bfloat16",
                      variant is not None)
    for arg, t in others.items():
        if t is not None and not (t.dtype is dt and t.get_device() == device
                                  and t.is_contiguous()
                                  and t.numel() < _MAX_NUMEL):
            _refuse_dtype(name, arg, t, device, f"{dt} (x's dtype)",
                          t.dtype is dt)
    return device, variant


def require_cuda_conv(name: str, x, w, **others) -> Tuple[int, str]:
    """The guard of the conv kernels K1, K2 and the stacks K5a, K5b: raise
    unless (x, w) is a pair ``CONV_VARIANTS`` holds (float32 or bf16 both,
    or int8 x with float32 or bf16 w), both contiguous with fewer than 2^31
    elements on x's card, and every other given tensor (a stack's w2,
    biases, residual; None is skipped) one of w's dtype there.  Returns
    (the card's index, the variant)."""
    device = x.get_device()
    wt = w.dtype
    variant = ("" if x.dtype is _F32 and wt is _F32
               else CONV_VARIANTS.get((x.dtype, wt)))
    if variant is None or not (x.is_contiguous()
                               and x.numel() < _MAX_NUMEL):
        x_ok = x.dtype in (_F32, _BF16, _I8)
        if not (x_ok and x.is_contiguous() and x.numel() < _MAX_NUMEL):
            _refuse_dtype(name, "x", x, device, "float32, bfloat16 or int8",
                          x_ok)
        _refuse_dtype(name, "w", w, device,
                      "float32 or bfloat16, x's dtype where x is float",
                      False)
    for arg, t in (("w", w),) + tuple(others.items()):
        if t is not None and not (t.dtype is wt and t.get_device() == device
                                  and t.is_contiguous()
                                  and t.numel() < _MAX_NUMEL):
            _refuse_dtype(name, arg, t, device, f"{wt} (w's dtype)",
                          t.dtype is wt)
    return device, variant


def require_cuda_float(name: str, device, contiguous: bool = True,
                       **tensors) -> torch.dtype:
    """Raise unless every given tensor is on ``device`` and all share one
    dtype, float32 or bfloat16 (the LM kernels K11/K12 and the matmul K10
    take either), and, with ``contiguous``, are contiguous; returns that
    dtype."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1:
        raise TypeError(f"{name}: mixed dtypes {sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: {dtype}; the kernel takes float32 or "
                        "bfloat16")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dtype


def stream_of(device: int) -> int:
    """The current CUDA stream of the card of index ``device`` (what the
    guards return, ``x.get_device()``), as the pointer the C
    entry points take.  Read raw, through PyTorch's private
    ``torch._C._cuda_getCurrentRawStream``: building the public
    ``torch.cuda.current_stream`` object costs more host time a launch than
    a small kernel takes (``chip_smoke.py`` times both on K4's line)."""
    return torch._C._cuda_getCurrentRawStream(device)


def toolchain_missing() -> Optional[str]:
    """Why the kernels cannot run here (no CUDA device, no nvcc), or None
    when they can.  Tests that need the card skip with this reason."""
    if not torch.cuda.is_available():
        return "no CUDA device"
    try:
        _nvcc()
    except KernelBuildError as e:
        return str(e)
    return None
