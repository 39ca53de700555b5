"""Every architecture's configuration, parameters and caches on the port
against the reference's.

For each id of ``ARCH_IDS``: ``CONFIG`` and ``TINY`` equal the
reference's field for field; the reference's ``init_params`` pytree goes
through ``convert.params_from_numpy`` / ``params_to_numpy`` unchanged bit
for bit (f32 leaves staying f32 in a bf16 model); ``init_caches`` and
``pad_caches`` give the reference's shapes and dtypes for every cache
kind, ``pad_caches`` in fresh storage."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import ALIASES, ARCH_IDS, all_configs, get_config
from repro_torch.models import model as M

torch.set_num_threads(1)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference(arch, tiny):
    ours, theirs = get_config(arch, tiny=tiny), ref_config(arch, tiny=tiny)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()


def test_every_id_and_alias_resolves():
    assert set(all_configs()) == set(ARCH_IDS)
    for alias, arch in ALIASES.items():
        assert get_config(alias) == get_config(arch)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no_such_arch")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_round_trip_through_numpy(arch):
    """bf16, as the configs ship: every leaf back bit for bit, in its own
    dtype (the MoE router and the SSM's a_log / d_skip / dt_bias stay
    f32), and into a fresh model unchanged."""
    rcfg = ref_config(arch, tiny=True)
    cfg = get_config(arch, tiny=True)
    tree = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(1),
                                                   rcfg))
    sd = convert.params_from_numpy(cfg, tree)
    model = M.Model(cfg, device="cpu", seed=3)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    for n, t in model.state_dict().items():
        assert t.dtype == sd[n].dtype, n
        assert torch.equal(t, sd[n]), n
    back = convert.params_to_numpy(cfg, model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", ["minicpm3_4b", "mamba2_2p7b",
                                  "jamba15_large_398b"])
def test_init_and_pad_caches_per_cache_kind(arch):
    """The reference's shapes and dtypes; ``pad_caches`` grows only the
    attention caches and always returns fresh storage."""
    rcfg, cfg = ref_config(arch, tiny=True), get_config(arch, tiny=True)
    cj = RM.init_caches(rcfg, 2, 8, jnp.float32)
    ct = M.init_caches(cfg, 2, 8, torch.float32, device="cpu")
    for a, b in zip(jax.tree.leaves(cj), (t for c in ct for t in c)):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    grown = M.pad_caches(cfg, ct, 12)
    want = RM.pad_caches(rcfg, cj, 12)
    for c_old, c_new in zip(ct, grown):
        for x, y in zip(c_old, c_new):
            assert y.data_ptr() != x.data_ptr()
            y.fill_(1.0)
            assert bool((x == 0).all())
    for a, b in zip(jax.tree.leaves(want), (t for c in grown for t in c)):
        assert tuple(b.shape) == a.shape
