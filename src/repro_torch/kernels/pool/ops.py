"""Wrappers of the standalone pool kernels (K3a/K3b, ``csrc/pool.cu``).

``pool_chwn`` pools a CHWN tensor (the paper's preferred layout, §V.A),
``pool_nchw`` an NCHW one; each writes its result in ``dst_layout``.  For a
CPU tensor a wrapper returns the plain version (``ref.pool_ref``); for a
CUDA tensor it launches its kernel or raises.  Launches are counted in
``pool_chwn.launches`` and ``pool_nchw.launches``; a bf16 launch (the
kernels take float32 or bf16, y in x's dtype, summed in float32 and
rounded once) also in ``variant_launches["bf16"]``.  The reference
wrappers' N/C-tile padding and ``autotune_nt`` are not carried over.  When x
requires grad, the wrappers run as a ``torch.autograd.Function`` whose
backward is the pool backward K7 (``backward.pool_backward``), reading the
gradient in ``dst_layout``, as the reference's custom VJPs do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pool.backward import pool_backward
from repro_torch.kernels.pool.ref import pool_ref

_LAYOUTS = ("CHWN", "NCHW")
_OPS = ("max", "avg")


def k3a_bf16_unit(u: int, N: int, C: int, Ho: int, Wo: int,
                  pair: bool):
    """The output unit thread ``u`` of K3a's bf16 kernel
    (``pool_chwn_bf16_kernel`` in csrc/pool.cu) makes: (c, ho, wo, its
    images).  Units run n fastest, then wo, ho, c: two neighbouring images
    a unit where ``pair`` (N even and x 4-byte aligned), else one; the
    kernel runs ``C * Ho * Wo * units a position`` threads (the window
    kernel of a window wider than 8: block ``u // U``'s thread ``u % U``,
    U the units a position)."""
    U = N // 2 if pair else N
    r, q = divmod(u, U)
    r, wo = divmod(r, Wo)
    c, ho = divmod(r, Ho)
    return c, ho, wo, (2 * q, 2 * q + 1) if pair else (q,)


def k3b_bf16_unit(u: int, C: int, Ho: int, Wo: int):
    """The outputs thread ``u`` of K3b's bf16 kernel
    (``pool_nchw_bf16_kernel`` in csrc/pool.cu) makes: (n, c, ho, its wo).
    A unit is two neighbouring outputs of a row, wo = 2q and 2q + 1 (one
    where 2q + 1 = Wo); units run q fastest, then ho, c, n, and the kernel
    runs ``N * C * Ho * ceil(Wo / 2)`` threads."""
    Q = -(-Wo // 2)
    r, q = divmod(u, Q)
    r, ho = divmod(r, Ho)
    n, c = divmod(r, C)
    return n, c, ho, tuple(wo for wo in (2 * q, 2 * q + 1) if wo < Wo)


def _refuse(name: str, x: torch.Tensor, F: int, S: int, op: str,
            dst_layout: str) -> None:
    """Raise the reason a pool launch's arguments are refused."""
    if x.dim() != 4:
        raise ValueError(f"{name}: expected a 4-D tensor, got shape "
                         f"{tuple(x.shape)}")
    if op not in _OPS:
        raise ValueError(f"{name}: unknown pool op {op!r}")
    if dst_layout not in _LAYOUTS:
        raise ValueError(f"{name}: dst_layout={dst_layout!r} not in "
                         f"{_LAYOUTS}")
    raise ValueError(f"{name}: a {F}x{F} window at stride {S} does not fit "
                     f"the input {tuple(x.shape)}")


def _pool(wrapper, entry: str, src: str, x: torch.Tensor, F: int, S: int,
          op: str, dst_layout: str) -> torch.Tensor:
    # the host path of every K3a/K3b launch: one combined test of the
    # arguments (the reason is worked out only where it fails), y by
    # new_empty, the shared _build helpers
    if src == "CHWN" and x.dim() == 4:
        C, H, W, N = x.shape
    elif x.dim() == 4:
        N, C, H, W = x.shape
    else:
        _refuse(wrapper.__name__, x, F, S, op, dst_layout)
    Ho = (H - F) // S + 1 if S >= 1 else 0
    Wo = (W - F) // S + 1 if S >= 1 else 0
    if not (F >= 1 and Ho >= 1 and Wo >= 1 and op in _OPS
            and dst_layout in _LAYOUTS):
        _refuse(wrapper.__name__, x, F, S, op, dst_layout)
    if _build.on_cpu(wrapper.__name__, x):
        return pool_ref(x, F, S, op, src, dst_layout)
    dev, variant = _build.require_cuda_storage(wrapper.__name__, x)
    y = x.new_empty((C, Ho, Wo, N) if dst_layout == "CHWN"
                    else (N, C, Ho, Wo))
    _build.check(wrapper.__name__, _build.entry(entry, variant)(
        x.data_ptr(), y.data_ptr(), N, C, H, W, F, S, op == "avg",
        dst_layout == "NCHW", _build.stream_of(dev)))
    wrapper.launches += 1
    if variant:
        wrapper.variant_launches[variant] += 1
    return y


class _PoolFn(torch.autograd.Function):
    """K3a/K3b with their gradient over K7a/K7b."""

    @staticmethod
    def forward(ctx, x, wrapper, entry, src, F, S, op, dst_layout):
        ctx.conf = (F, S, op, src, dst_layout)
        ctx.save_for_backward(x)
        return _pool(wrapper, entry, src, x, F, S, op, dst_layout)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        F, S, op, src, dst_layout = ctx.conf
        dx = pool_backward(x, g.contiguous(), F, S, op, layout=src,
                           g_layout=dst_layout)
        return (dx,) + (None,) * 7


def _pool_public(wrapper, entry: str, src: str, x: torch.Tensor, F: int,
                 S: int, op: str, dst_layout: str) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _PoolFn.apply(x, wrapper, entry, src, F, S, op, dst_layout)
    return _pool(wrapper, entry, src, x, F, S, op, dst_layout)


def pool_chwn(x: torch.Tensor, F: int, S: int, op: str = "max",
              dst_layout: str = "CHWN") -> torch.Tensor:
    """K3a: x [C, H, W, N] -> [C, Ho, Wo, N] (or [N, C, Ho, Wo] for
    ``dst_layout="NCHW"``).  float32: threads run along N (coalesced);
    each makes four neighbouring outputs of a row from one pass over their
    columns.  bf16: lanes run over (wo, image pairs), a thread an output
    unit (``k3a_bf16_unit``)."""
    return _pool_public(pool_chwn, "pool_chwn_forward", "CHWN", x, F, S, op,
                        dst_layout)


def pool_nchw(x: torch.Tensor, F: int, S: int, op: str = "max",
              dst_layout: str = "NCHW") -> torch.Tensor:
    """K3b: x [N, C, H, W] -> [N, C, Ho, Wo] (or [C, Ho, Wo, N] for
    ``dst_layout="CHWN"``).  float32: a thread an output, windows sliding
    along the contiguous W (the strided access the paper measures for this
    layout).  bf16: a thread two neighbouring outputs of a row, each window
    row's span by the widest loads W allows (``k3b_bf16_unit``)."""
    return _pool_public(pool_nchw, "pool_nchw_forward", "NCHW", x, F, S, op,
                        dst_layout)


pool_chwn.launches = 0
pool_nchw.launches = 0
pool_chwn.variant_launches = {"bf16": 0}
pool_nchw.variant_launches = {"bf16": 0}
