"""Port flash attention (K11) against the reference's.

The same seeded numpy q, k, v go through ``repro.kernels.flash_attention``
(its Pallas kernel in interpret mode, and its ``attention_ref``) and the
port's ``flash_attention`` wrapper, which runs its plain version on the CPU
(``test_torch_lm_kernels_card.py`` holds the CUDA kernel against it on the
card).  Tolerance rtol / atol 1e-4 (``tests/test_kernels.py``); bf16
outputs 8 * BF16_EPS (``tests/test_bf16.py``).

The reference's kernel masks causal attention top-left (key kpos kept where
kpos <= qpos); its ``attention_ref`` aligns bottom-right.  The two agree
where Sq == Sk; at Sq 64, Sk 128 they differ, and the port computes what
the kernel computes.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_attention

from repro_torch.kernels.flash_attention.ops import (MAX_HEAD_DIM,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)

TOL = 1e-4
BF16_EPS = 2.0 ** -8
# the reference's test_flash_attention cases: (bh, s, d, causal)
REF_CASES = [(4, 256, 64, True), (2, 128, 32, False), (6, 512, 128, True)]


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in (shape_q, shape_kv, shape_kv))


def _port(q, k, v, causal, dtype=torch.float32):
    return flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                           causal=causal)


@pytest.mark.parametrize("bh,s,d,causal", REF_CASES)
def test_flash_attention_matches_reference(bh, s, d, causal):
    q, k, v = _qkv((bh, s, d), (bh, s, d), bh * s + d)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, bq=64, bk=64))
    got = _port(q, k, v, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    oracle = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)


def test_flash_attention_4d_matches_reference():
    q, k, v = _qkv((2, 3, 128, 64), (2, 3, 128, 64), 5)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True))
    got = _port(q, k, v, True)
    assert got.shape == (2, 3, 128, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_sequence_matches_reference(causal):
    """S = 100 divides no 64-row tile: the reference's wrapper shrinks its
    block to 100, the port's kernel masks the tail of its own tile."""
    q, k, v = _qkv((3, 100, 64), (3, 100, 64), 100 + causal)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(_port(q, k, v, causal).numpy(), want,
                               rtol=TOL, atol=TOL)


def test_causal_with_fewer_queries_than_keys_is_top_left():
    q, k, v = _qkv((2, 64, 32), (2, 128, 32), 64)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kernel = np.asarray(ref_flash(jq, jk, jv, causal=True, bq=64, bk=64))
    got = _port(q, k, v, True).numpy()
    np.testing.assert_allclose(got, kernel, rtol=TOL, atol=TOL)
    # the reference's oracle aligns bottom-right and differs here; the
    # port's copy of it agrees with it
    oracle = np.asarray(ref_attention(jq, jk, jv, causal=True))
    assert np.abs(oracle - kernel).max() > 0.1
    mine = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(mine.numpy(), oracle, rtol=TOL, atol=TOL)


def test_the_two_masks_agree_when_queries_equal_keys():
    q, k, v = _qkv((2, 96, 32), (2, 96, 32), 96)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(attention_ref(*t).numpy(),
                               flash_attention_ref(*t).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_matches_reference(causal):
    q, k, v = _qkv((2, 128, 64), (2, 128, 64), 7 + causal)
    want = np.asarray(ref_flash(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)),
                                causal=causal).astype(jnp.float32))
    got = _port(q, k, v, causal, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=8 * BF16_EPS)


def test_flash_attention_refuses_bad_shapes():
    q = torch.zeros(2, 8, MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(torch.zeros(2, 8, 16), torch.zeros(3, 8, 16),
                        torch.zeros(3, 8, 16))
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        flash_attention(torch.zeros(8, 16), torch.zeros(8, 16),
                        torch.zeros(8, 16))


def _bf16_p_emulation(q, k, v, causal, bkv=64):
    """The arithmetic of K11's tensor-core kernel in plain torch: per
    64-key tile, s = q kᵀ in f32 from the bf16 inputs, the online softmax
    in f32, and P rounded to bf16 before P @ V (f32 accumulation); the one
    place it departs from the reference, which multiplies p @ v in f32."""
    q, k, v = (t.float() for t in (q, k, v))
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    m = torch.full((BH, Sq), -1e30)
    l = torch.zeros(BH, Sq)
    o = torch.zeros(BH, Sq, D)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bkv):
        kpos = torch.arange(k0, min(Sk, k0 + bkv))[None, :]
        s = torch.einsum("bqd,bkd->bqk", q, k[:, k0:k0 + bkv]) / np.sqrt(D)
        keep = (kpos <= qpos) if causal else torch.ones_like(s[0], dtype=bool)
        s = torch.where(keep, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bqk,bkd->bqd", p.bfloat16().float(), v[:, k0:k0 + bkv])
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).bfloat16()


def test_bf16_p_rounding_holds_the_reference_tolerance():
    """S 512, D 128, causal: rounding P to bf16 (the tensor-core kernel's
    P @ V operand) stays within 8 * BF16_EPS of the reference kernel on the
    same bf16 inputs (interpret mode, as its bf16 test runs it)."""
    q, k, v = _qkv((2, 512, 128), (2, 512, 128), 512)
    want = np.asarray(ref_flash(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)),
                                causal=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = _bf16_p_emulation(tq, tk, tv, True)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 8 * BF16_EPS
    # and the plain version (f32 P) agrees with it as closely
    plain = flash_attention_ref(tq, tk, tv, True)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=0, atol=8 * BF16_EPS)
