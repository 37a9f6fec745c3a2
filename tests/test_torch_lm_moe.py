"""The port's MoE FFN against the reference's: the layer alone, and the two
MoE transformers (dbrx: every block MoE; llama4: dense and MoE blocks, a
shared expert), on the reference's weights.

Module level, on seeded numpy inputs through both packages: ``moe_fwd``
(outputs and the balance loss) and ``_moe_local_dispatch`` (buffer,
slots, weights, kept pairs, loss), at the reduced widths (4 experts,
top-2 for dbrx and top-1 plus the shared expert for llama4) with the
reduced config's drop-free capacity factor (8.0) and with 0.25, where
tokens overflow their experts and drop.  The routing runs in float32 on
the same inputs in both packages, so the expert choices, slots and kept
pairs are identical in both dtypes.

Model level, the reduced configs (2 periods) built by ``repro.models``
and carried over by ``models.convert``: the helpers of
``tests/test_torch_lm_models.py`` hold the teacher-forced forward (hidden
states and the balance loss), prefill (logits and KV caches, both
layouts), 4 decode steps and greedy decoding.

Tolerances: float32 rtol / atol 1e-4 with every MoE layer's expert
choices identical; bf16 the reference's decode tolerance, atol 0.15 /
rtol 0.05, at every token.  The port's MoE layers dispatch to the
experts the reference chose (``layers.record_routes``) and their own
choices are judged by the routing-margin rule (bf16): hidden states one
bf16 rounding apart may pick other experts where the reference's k-th
and (k+1)-th router probabilities lie within 1e-2 of each other, and
only there (``_flips`` fails on a choice past that margin).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_L

from repro_torch.models import layers as L
from repro_torch.models.convert import tensor_from_numpy
from tests.test_torch_lm_models import (CPU, DTYPES, LAYOUTS, TOL, _cfgs,
                                        _close, _np, check_decode,
                                        check_forward, check_greedy,
                                        check_meta_device, check_prefill)

ARCHS = ["dbrx_132b", "llama4_maverick_400b"]
CAPACITY = {"drop_free": None, "dropping": 0.25}
T_B, T_S = 2, 32            # 64 tokens a call


@functools.lru_cache(maxsize=None)
def _moe_case(arch, dtype, capacity):
    """Both packages' configs, the reference's seeded MoE parameters (as
    jax arrays and as the port's tensors) and seeded inputs in both."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    if CAPACITY[capacity] is not None:
        ref_cfg = ref_cfg.replace(capacity_factor=CAPACITY[capacity])
        cfg = cfg.replace(capacity_factor=CAPACITY[capacity])
    p = ref_L.init_moe(jax.random.PRNGKey(1), ref_cfg)
    pt = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), CPU), p)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (T_B, T_S, cfg.d_model)), jnp.dtype(ref_cfg.dtype))
    return ref_cfg, cfg, p, pt, x, tensor_from_numpy(np.asarray(x), CPU)


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fwd_matches_reference(arch, dtype, capacity):
    ref_cfg, cfg, p, pt, x, xt = _moe_case(arch, dtype, capacity)
    want, want_aux = ref_L.moe_fwd(p, x, ref_cfg)
    got, aux = L.moe_fwd(pt, xt, cfg)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want, dtype, "moe out")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_dispatch_matches_reference(arch, dtype, capacity):
    """The same routing, slots, kept pairs and buffer (the tokens' own
    values, copied); the capacity is ``moe_capacity``'s, which drops
    tokens at the lower factor."""
    ref_cfg, cfg, p, pt, x, xt = _moe_case(arch, dtype, capacity)
    T = T_B * T_S
    cap = L.moe_capacity(cfg, T)
    assert cap == max(8, min(int(ref_cfg.capacity_factor * T
                                 * ref_cfg.experts_per_token
                                 / ref_cfg.num_experts), T))
    want = ref_L._moe_local_dispatch(x.reshape(T, -1), p, ref_cfg, cap)
    got = L._moe_local_dispatch(xt.reshape(T, -1), pt, cfg, cap)
    buf, slot, weights, keep, aux = got
    assert buf.shape == (cfg.num_experts, cap, cfg.d_model)
    np.testing.assert_array_equal(_np(buf), _np(want[0]))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(weights.numpy(), np.asarray(want[2]),
                               **TOL["float32"])
    np.testing.assert_allclose(float(aux), float(want[4]), rtol=1e-5,
                               atol=1e-6)
    assert keep.all() == (capacity == "drop_free")


@pytest.mark.parametrize("arch", ARCHS)
def test_recorded_routing_is_the_layers_own_and_follow_steers_it(arch):
    """``record_routes`` hands out the experts the layer chose and its
    router's probabilities; told to follow the reference's choices the
    layer gives the reference's output, told to follow other experts
    another one (recording its own choice all the same); a choice left
    unused raises."""
    ref_cfg, cfg, p, pt, x, xt = _moe_case(arch, "float32", "drop_free")
    T, k = T_B * T_S, cfg.experts_per_token
    want = _np(ref_L.moe_fwd(p, x, ref_cfg)[0])
    with L.record_routes() as log:
        got = _np(L.moe_fwd(pt, xt, cfg)[0])
    (sel, probs), = log
    assert sel.shape == (T, k) and probs.shape == (T, cfg.num_experts)
    np.testing.assert_array_equal(
        sel.numpy(), np.asarray(jax.lax.top_k(jax.nn.softmax(
            x.reshape(T, -1) @ p["router"], axis=-1), k)[1]))
    other = (sel + 1) % cfg.num_experts
    with L.record_routes(follow=[sel.clone()]) as log:
        same = _np(L.moe_fwd(pt, xt, cfg)[0])
    with L.record_routes(follow=[other]) as log2:
        moved = _np(L.moe_fwd(pt, xt, cfg)[0])
    np.testing.assert_array_equal(same, got)
    _close(same, want, "float32")
    assert np.abs(moved - got).max() > 0.1
    assert torch.equal(log[0][0], sel) and torch.equal(log2[0][0], sel)
    with pytest.raises(ValueError, match="not used"):
        with L.record_routes(follow=[sel, sel]):
            L.moe_fwd(pt, xt, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_tensor_follows_the_inputs_device(arch):
    check_meta_device(arch)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_states_and_aux(arch, dtype):
    check_forward(arch, dtype)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch, dtype, layout):
    check_prefill(arch, dtype, layout)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps(arch, dtype, layout):
    check_decode(arch, dtype, layout)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_where_the_margin_is_clear(arch, dtype):
    check_greedy(arch, dtype)
