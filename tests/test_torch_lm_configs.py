"""The port's LM configurations against the reference's.

``repro_torch.configs`` keeps its own copies of ``ModelConfig``,
``ShapeConfig``, the registry and the ten architecture modules.  Each
config's ``repr`` (and its ``reduced_config``'s) must equal the
reference's letter for letter, every alias must resolve to the same
architecture, and the shape grid must be the same.
"""
from __future__ import annotations

import pytest

import repro.configs as ref_configs
from repro.configs import registry as ref_registry

import repro_torch.configs as configs
from repro_torch.configs import base, registry

ARCHS = list(ref_registry.ARCH_IDS)
ALIASES = sorted(ref_registry._ALIASES)


def test_the_port_lists_the_same_architectures():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert list(configs.all_configs()) == list(ref_configs.all_configs())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_repr_matches_reference(arch):
    assert repr(configs.get_config(arch)) == repr(ref_configs.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("periods", [1, 2])
def test_reduced_config_repr_matches_reference(arch, periods):
    got = configs.reduced_config(configs.get_config(arch), periods)
    want = ref_configs.reduced_config(ref_configs.get_config(arch), periods)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_resolves_the_same(alias):
    assert configs.get_config(alias).name == ref_configs.get_config(alias).name


@pytest.mark.parametrize("arch", ARCHS)
def test_derived_sizes_and_shape_sets_match(arch):
    got, want = configs.get_config(arch), ref_configs.get_config(arch)
    for prop in ("num_periods", "q_dim", "kv_dim", "expert_d_ff",
                 "mamba_d_inner"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert repr(configs.shapes_for(got)) == repr(ref_configs.shapes_for(want))


def test_shape_grid_matches_reference():
    assert repr(configs.ALL_SHAPES) == repr(ref_configs.ALL_SHAPES)
    assert repr(configs.SHAPES_BY_NAME) == repr(ref_configs.SHAPES_BY_NAME)
    assert [s.tokens for s in configs.ALL_SHAPES] == \
        [s.tokens for s in ref_configs.ALL_SHAPES]


def test_block_kinds_match_reference():
    from repro.configs import base as ref_base
    for name in ("ATTN", "ATTN_LOCAL", "ATTN_MOE", "MAMBA", "MAMBA_MOE",
                 "RWKV", "MOE_ONLY"):
        assert getattr(base, name) == getattr(ref_base, name), name


def test_unknown_arch_and_bad_pattern_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("no_such_model")
    cfg = configs.get_config("gemma2_27b")
    with pytest.raises(ValueError, match="not divisible"):
        cfg.replace(num_layers=45)
