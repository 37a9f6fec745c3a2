"""int8 x into the conv->conv stacks K5a (CHWN) and K5b (NCHW).

The reference's stacks take int8 x and widen it in VMEM, the per-channel
scale folded into w1, and return ``result_type(x, w1)``: w's dtype.  The
same seeded numpy inputs (x quantized per channel by ``repro_torch.quant``,
the scale folded into w1) go through the reference's ``conv_stack_chwn`` /
``conv_stack_nchw`` (Pallas in interpret mode) and through the port's
wrappers, whose CPU path is the plain version ``conv_stack_ref``, with
float32 and bf16 weights.  Tolerances: float32 w within the conv kernels'
rtol 1e-4 / atol 1e-3, bf16 w within one bf16 step (2^-7 |want| + 1e-5
max |want|).  Also: the output is w's dtype, the int8 x takes no gradient
while the weights do (w1's read from x widened, exactly), and the int8
builds of ``_build`` compile the stack sources and define their entries.

``test_torch_stack_int8_card.py`` holds the four int8 builds against the
plain version on the card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv import ops as ref_ops

from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.ref import conv_stack_ref
from repro_torch.quant import fold_scale_into_weights, quantize

RTOL, ATOL = 1e-4, 1e-3          # float32 w: the conv kernels' tolerance
BF16_STEP = 2.0 ** -7            # bf16 w: one bf16 step
OTHER = {"NCHW": "CHWN", "CHWN": "NCHW"}

# name -> (H, Ci, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res, biases)
CASES = {
    "3x3_pair":        (8, 3, 6, 5, 3, 1, 1, 3, 1, 1, None, False, False),
    "pool_biases":     (8, 4, 5, 7, 3, 1, 1, 3, 1, 1, (2, 2, "max"), False,
                        True),
    "s1_2_residual":   (11, 3, 5, 6, 3, 2, 1, 3, 1, 1, None, True, True),
    "src_other":       (9, 5, 4, 6, 3, 1, 1, 3, 1, 1, (2, 2, "avg"), False,
                        False),
}


def _to(layout: str, a_nchw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a_nchw.transpose(perm_between("NCHW",
                                                              layout)))


def _inputs(layout: str, name: str, wdt: torch.dtype, seed: int):
    """int8 x (in its source layout) and its per-channel scale folded into
    w1, as numpy arrays both packages take; weights, biases and residual
    already rounded to ``wdt`` (held as float32 values)."""
    H, Ci, Cm, Co, F1, S1, P1, F2, S2, P2, pool, want_res, biases = \
        CASES[name]
    rng = np.random.default_rng(seed)
    N = 2
    xf = torch.from_numpy(rng.standard_normal((N, Ci, H, H), np.float32))
    q, scale = quantize(xf, 1)
    w1 = torch.from_numpy(rng.standard_normal((Cm, Ci, F1, F1), np.float32)
                          * np.float32(0.2))
    w1 = fold_scale_into_weights(w1, scale)          # float32, then rounded
    w2 = torch.from_numpy(rng.standard_normal((Co, Cm, F2, F2), np.float32)
                          * np.float32(0.2))

    def rounded(t):
        return None if t is None else t.to(wdt).float().numpy()

    Ho1 = (H + 2 * P1 - F1) // S1 + 1
    Ho2 = (Ho1 + 2 * P2 - F2) // S2 + 1
    res = (torch.from_numpy(rng.standard_normal((N, Co, Ho2, Ho2),
                                                np.float32))
           if want_res else None)
    b1 = torch.from_numpy(rng.standard_normal(Cm, np.float32)) if biases \
        else None
    b2 = torch.from_numpy(rng.standard_normal(Co, np.float32)) if biases \
        else None
    src = OTHER[layout] if name == "src_other" else layout
    return dict(x=_to(src, q.numpy()), w1=rounded(w1), w2=rounded(w2),
                b1=rounded(b1), b2=rounded(b2),
                res=None if res is None else _to(layout, rounded(res)),
                src=src, S1=S1, P1=P1, S2=S2, P2=P2, pool=pool)


def _reference(layout: str, d, wdt: torch.dtype) -> np.ndarray:
    jdt = jnp.float32 if wdt == torch.float32 else jnp.bfloat16

    def j(a):
        return None if a is None else jnp.asarray(a).astype(jdt)

    w1, w2 = j(d["w1"]), j(d["w2"])
    kw = dict(bias1=j(d["b1"]), bias2=j(d["b2"]), relu1=True, relu2=True,
              pool=d["pool"], res=j(d["res"]), res_layout=layout,
              src_layout=d["src"], dst_layout=layout)
    x = jnp.asarray(d["x"])                       # int8
    if layout == "CHWN":
        y = ref_ops.conv_stack_chwn(
            x, jnp.transpose(w1, (1, 2, 3, 0)),
            jnp.transpose(w2, (1, 2, 3, 0)), d["S1"], d["P1"], d["S2"],
            d["P2"], 2, True, **kw)
    else:
        y = ref_ops.conv_stack_nchw(x, w1, w2, d["S1"], d["P1"], d["S2"],
                                    d["P2"], True, **kw)
    assert y.dtype == jdt                         # result_type(int8, w)
    return np.asarray(y.astype(jnp.float32))


def _port(layout: str, d, wdt: torch.dtype, **extra):
    def t(a):
        return None if a is None else torch.from_numpy(a).to(wdt)

    w1, w2 = t(d["w1"]), t(d["w2"])
    if layout == "CHWN":
        w1 = w1.permute(1, 2, 3, 0).contiguous()
        w2 = w2.permute(1, 2, 3, 0).contiguous()
    wrapper = (conv_ops.conv_stack_chwn if layout == "CHWN"
               else conv_ops.conv_stack_nchw)
    return wrapper(torch.from_numpy(d["x"]), w1, w2, d["S1"], d["P1"],
                   d["S2"], d["P2"], bias1=t(d["b1"]), bias2=t(d["b2"]),
                   relu1=True, relu2=True, pool=d["pool"], res=t(d["res"]),
                   res_layout=layout, src_layout=d["src"], dst_layout=layout,
                   **extra)


def _assert_close(got: np.ndarray, want: np.ndarray, wdt) -> None:
    assert got.shape == want.shape
    if wdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        tol = BF16_STEP * np.abs(want) + 1e-5 * np.abs(want).max()
        assert (np.abs(got - want) <= tol).all(), \
            float(np.abs(got - want).max())


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["i8f32", "i8bf16"])
@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_stack_matches_reference(name, layout, wdt):
    d = _inputs(layout, name, wdt, seed=sorted(CASES).index(name))
    assert d["x"].dtype == np.int8
    want = _reference(layout, d, wdt)
    got = _port(layout, d, wdt)
    assert got.dtype == wdt                       # w's dtype, not x's
    _assert_close(got.float().numpy(), want, wdt)
    # the wrapper's CPU path is the plain version, bit for bit
    w1c = torch.from_numpy(d["w1"]).to(wdt)
    w2c = torch.from_numpy(d["w2"]).to(wdt)
    plain = conv_stack_ref(
        torch.from_numpy(d["x"]), w1c, w2c, d["S1"], d["P1"], d["S2"],
        d["P2"], bias1=None if d["b1"] is None else
        torch.from_numpy(d["b1"]).to(wdt),
        bias2=None if d["b2"] is None else torch.from_numpy(d["b2"]).to(wdt),
        relu1=True, relu2=True, pool=d["pool"],
        res=None if d["res"] is None else torch.from_numpy(d["res"]).to(wdt),
        res_layout=layout, src_layout=d["src"], dst_layout=layout)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("layout", ["CHWN", "NCHW"])
def test_int8_x_takes_no_gradient_but_the_weights_do(layout):
    """An int8 x (quantized, its scale folded into w1) is a leaf without
    a gradient; w1's and w2's gradients are those of the same stack over x
    widened to float32, which is exact."""
    d = _inputs(layout, "pool_biases", torch.float32, seed=7)

    def grads(x):
        w1 = torch.from_numpy(d["w1"]).requires_grad_(True)
        w2 = torch.from_numpy(d["w2"]).requires_grad_(True)
        w1k, w2k = ((w1.permute(1, 2, 3, 0), w2.permute(1, 2, 3, 0))
                    if layout == "CHWN" else (w1, w2))
        wrapper = (conv_ops.conv_stack_chwn if layout == "CHWN"
                   else conv_ops.conv_stack_nchw)
        y = wrapper(x, w1k.contiguous(), w2k.contiguous(), d["S1"],
                    d["P1"], d["S2"], d["P2"], relu1=True, relu2=True,
                    pool=d["pool"], src_layout=d["src"], dst_layout=layout)
        return torch.autograd.grad(y.square().sum(), (w1, w2))

    q = torch.from_numpy(d["x"])
    assert not q.requires_grad
    for g_int8, g_float in zip(grads(q), grads(q.float())):
        torch.testing.assert_close(g_int8, g_float, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["i8f32", "i8bf16"])
def test_int8_builds_compile_the_stacks(variant):
    srcs, entries = _build.VARIANTS[variant]
    for engine in ("chwn", "nchw"):
        assert f"conv/csrc/conv_stack_{engine}.cu" in srcs
    for name in ("conv_stack_chwn_forward", "conv_stack_chwn_max_clusters",
                 "conv_stack_nchw_forward"):
        assert name in entries and name in _build.SIGNATURES
    flags = {str(p.relative_to(_build._KERNELS_DIR)): f
             for p, f in _build._units(variant)}
    assert flags["conv/csrc/conv_stack_nchw.cu"] == [
        f"-DREPRO_VARIANT_{variant.upper()}"]
    wdt = {"i8f32": torch.float32, "i8bf16": torch.bfloat16}[variant]
    assert _build.CONV_VARIANTS[(torch.int8, wdt)] == variant
