"""The port's Mamba-2 (SSD) token mixer against the reference, on mamba2
``TINY`` (d 64, d_inner 128, d_state 16, 8 heads of 16, chunks of 32).

The reference's ``init_ssm`` leaves, with ``conv_b``, ``d_skip`` and
``dt_bias`` redrawn so that every term counts, are carried into the port
by ``convert.params_from_numpy``; inputs are numpy draws handed to both.
f32 within 2e-4 (the reference's own chunked-versus-recurrent tolerance
in ``tests/test_ssm.py``), bf16 within 5e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as rlayers
from repro.models import model as RM
from repro.models import ssm as rssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import ssm

torch.set_num_threads(1)
TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _pair(dtype="float32"):
    """(reference cfg, layer-0 SSM params, port cfg, port SSM module)."""
    rcfg = dataclasses.replace(ref_config("mamba2_2p7b", tiny=True),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("mamba2_2p7b", tiny=True),
                              dtype=dtype)
    tree = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
    rng = np.random.default_rng(9)
    mixer = tree["groups"][0]["mixer"]
    for name, scale in (("conv_b", 0.1), ("d_skip", 1.0), ("dt_bias", 0.5)):
        a = mixer[name]
        mixer[name] = (rng.standard_normal(a.shape) * scale).astype(a.dtype)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(cfg, tree))
    p0 = jax.tree.map(lambda a: jnp.asarray(a[0]), mixer)
    return rcfg, p0, cfg, model.layers[0].mixer


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _u(shape, seed, dtype="float32"):
    u = (np.random.default_rng(seed).standard_normal(shape) * 0.5
         ).astype(np.float32)
    j = jnp.asarray(u).astype(jnp.dtype(dtype))
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def test_gated_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x, gate = (rng.standard_normal((2, 5, 48)).astype(np.float32)
               for _ in "xg")
    scale = rng.standard_normal(48).astype(np.float32)
    want = rlayers.gated_rmsnorm({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x), jnp.asarray(gate), 1e-5)
    got = layers.gated_rmsnorm(torch.from_numpy(scale), torch.from_numpy(x),
                               torch.from_numpy(gate), 1e-5)
    _close(got, want, 1e-6)
    # bf16 activations: the gate's SiLU in f32, cast to x's type
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.gated_rmsnorm(torch.from_numpy(scale).to(torch.bfloat16),
                               xb, torch.from_numpy(gate), 1e-5)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("l", [64, 96, 20])
def test_ssd_full_with_cache_matches_reference(l):
    """Two and three chunks of 32, and one short chunk of 20: outputs, the
    conv tail and the f32 terminal state."""
    rcfg, p0, cfg, mod = _pair()
    uj, ut = _u((2, l, cfg.d_model), seed=l)
    want, wc = rssm.ssd_full(p0, rcfg, uj, return_cache=True)
    with torch.inference_mode():
        got, gc = ssm.ssd_full(mod, cfg, ut, return_cache=True)
    _close(got, want, TOL["float32"])
    _close(gc.conv, wc.conv, TOL["float32"])
    _close(gc.state, wc.state, TOL["float32"])
    assert gc.state.dtype == torch.float32
    assert gc.conv.shape == (2, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state)
    with torch.inference_mode():
        assert torch.equal(ssm.ssd_full(mod, cfg, ut), got)


def test_ssd_full_refuses_a_length_off_the_chunk():
    _, _, cfg, mod = _pair()
    with pytest.raises(ValueError, match="not a multiple of chunk 32"):
        ssm.ssd_full(mod, cfg, torch.zeros((1, 40, cfg.d_model)))


def test_ssd_decode_continues_prefill_like_reference():
    """Prefill 64 tokens in both packages, then 8 recurrent steps from
    each one's cache: every step's output and the state in place."""
    rcfg, p0, cfg, mod = _pair()
    uj, ut = _u((2, 72, cfg.d_model), seed=3)
    _, cj = rssm.ssd_full(p0, rcfg, uj[:, :64], return_cache=True)
    with torch.inference_mode():
        _, ct = ssm.ssd_full(mod, cfg, ut[:, :64], return_cache=True)
    state = ct.state
    for t in range(64, 72):
        want, cj = rssm.ssd_decode(p0, rcfg, uj[:, t:t + 1], cj)
        with torch.inference_mode():
            got, ct = ssm.ssd_decode(mod, cfg, ut[:, t:t + 1], ct)
        _close(got, want, TOL["float32"])
        _close(ct.conv, cj.conv, TOL["float32"])
        _close(ct.state, cj.state, TOL["float32"])
    assert ct.state is state                           # written in place


def test_chunked_equals_recurrent_in_the_port():
    """The reference's own oracle, run on the port: the chunked prefill of
    64 tokens against 64 recurrent steps from a zero cache."""
    _, _, cfg, mod = _pair()
    _, u = _u((2, 64, cfg.d_model), seed=4)
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    with torch.inference_mode():
        y_chunk = ssm.ssd_full(mod, cfg, u)
        steps = [ssm.ssd_decode(mod, cfg, u[:, t:t + 1], cache)[0]
                 for t in range(64)]
    _close(torch.cat(steps, 1), y_chunk, TOL["float32"])


def test_ssd_bf16_matches_reference():
    """bf16 activations and weights, the f32 leaves kept f32."""
    rcfg, p0, cfg, mod = _pair("bfloat16")
    assert mod.a_log.dtype == mod.d_skip.dtype == mod.dt_bias.dtype \
        == torch.float32
    assert mod.wx.dtype == torch.bfloat16
    uj, ut = _u((1, 64, cfg.d_model), seed=5, dtype="bfloat16")
    want, wc = rssm.ssd_full(p0, rcfg, uj, return_cache=True)
    with torch.inference_mode():
        got, gc = ssm.ssd_full(mod, cfg, ut, return_cache=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])
    _close(gc.state, wc.state, TOL["bfloat16"])
    want, _ = rssm.ssd_decode(p0, rcfg, uj[:, :1], wc)
    with torch.inference_mode():
        got, _ = ssm.ssd_decode(mod, cfg, ut[:, :1], gc)
    _close(got, want, TOL["bfloat16"])
