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
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, TextIO

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

_lib: Optional[ctypes.CDLL] = None
_F32 = torch.float32
_MAX_NUMEL = 2 ** 31     # the kernels index with 32-bit ints


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


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


def build(log: Optional[TextIO] = None) -> Path:
    """Compile every source (in parallel) and link the library; returns
    its path.  A cached library with the same source hash is reused.  With
    ``log``, each kernel's registers, shared memory and spills
    (``ptxas -v``) are written to it."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # a private scratch dir per build: concurrent builders never share
    # object files, and the finished library lands by atomic rename
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        extra = ["-Xptxas", "-v"] if log is not None else []
        procs = []
        for i, src in enumerate(sources()):
            obj = Path(tmp) / f"{i}_{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors, logs = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
        if log is not None:
            log.write("".join(logs))
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        what = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {what} ({err})")


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


def _refuse_f32(name: str, arg: str, t, device: int) -> None:
    """Raise the reason ``t`` is not a contiguous float32 tensor with fewer
    than 2^31 elements on the card of index ``device``."""
    if t.get_device() != device:
        raise ValueError(f"{name}: {arg} is on {t.device}, x on "
                         f"cuda:{device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                        "float32 only")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
    raise ValueError(f"{name}: {arg} has {t.numel()} elements; the kernel "
                     "indexes with 32-bit ints")


def require_cuda_f32(name: str, x, **others) -> int:
    """Raise unless the CUDA tensor ``x`` and every other given tensor
    (None is skipped) are contiguous float32 tensors on x's card with fewer
    than 2^31 elements: the kernels take nothing else.  Returns that card's
    index, ``x.get_device()``, for ``stream_of``.  One combined test a
    tensor, on ints and flags, not ``torch.device`` objects; the reason is
    worked out only for a tensor that fails it."""
    device = x.get_device()
    if not (x.dtype is _F32 and x.is_contiguous() and x.numel() < _MAX_NUMEL):
        _refuse_f32(name, "x", x, device)
    for arg, t in others.items():
        if t is not None and not (t.dtype is _F32 and t.get_device() == device
                                  and t.is_contiguous()
                                  and t.numel() < _MAX_NUMEL):
            _refuse_f32(name, arg, t, device)
    return device


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
    """The current CUDA stream of the card of index ``device`` (what
    ``require_cuda_f32`` returns, ``x.get_device()``), as the pointer the C
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
