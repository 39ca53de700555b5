"""The port's MoE channel mixer against the reference, on granite ``TINY``
(8 experts, top-2) with each expert activation.

The reference's ``init_params`` pytree is carried into the port by
``convert.params_from_numpy``; inputs are numpy draws handed to both.
``_topk`` must pick the reference's ids and values (ties to the lowest
id); ``moe_apply`` must give the same y and aux loss (f32 within 1e-4,
bf16 within 5e-2) and the same expert counts bit for bit, with the
capacity drop taking some assignments and without it. The router stays
f32 in a bf16 model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro.models import moe as rmoe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import moe

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(dtype="float32", **kw):
    """(reference cfg, layer-0 MoE params, port cfg, port MoE module)."""
    rcfg = dataclasses.replace(ref_config("granite_moe_1b", tiny=True),
                               dtype=dtype, **kw)
    cfg = dataclasses.replace(get_config("granite_moe_1b", tiny=True),
                              dtype=dtype, **kw)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    p0 = jax.tree.map(lambda a: a[0], params["groups"][0]["ffn"])
    return rcfg, p0, cfg, model.layers[0].ffn


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_topk_matches_reference_with_ties():
    """Probabilities on a coarse grid, so many rows hold ties: the ids and
    values of every round equal the reference's."""
    rng = np.random.default_rng(0)
    probs = (rng.integers(0, 5, (3, 17, 8)) / 8.0).astype(np.float32)
    probs[0, 0] = 0.25                                 # an all-tied row
    for k in (1, 2, 3, 8):
        vj, ij = rmoe._topk(jnp.asarray(probs), k)
        vt, it = moe._topk(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert it[0, 0].tolist() == list(range(8))


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
@pytest.mark.parametrize("act", ["swiglu", "gelu", "squared_relu"])
def test_moe_apply_matches_reference(act, capacity_factor):
    """b=2 rows of 32 tokens: with capacity 8 a slot (factor 1.0) some
    expert overflows in some row and drops; with 32 (factor 4.0) nothing
    can drop."""
    rcfg, p0, cfg, mod = _pair(ffn_act=act, capacity_factor=capacity_factor)
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model))
    x = x.astype(np.float32)
    yj, auxj, cj = rmoe.moe_apply(p0, rcfg, jnp.asarray(x))
    with torch.inference_mode():
        yt, auxt, ct = moe.moe_apply(mod, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=TOL["float32"],
                               atol=TOL["float32"])
    assert float(auxt) == pytest.approx(float(auxj), rel=1e-5)
    assert ct.dtype == torch.int32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(ct.sum()) == 2 * 32 * cfg.experts_per_token
    # whether a row overflows an expert's capacity (dropping assignments)
    cap = max(int(capacity_factor * 32 * cfg.experts_per_token
                  / cfg.num_experts), 1)
    with torch.inference_mode():
        logits = torch.from_numpy(x) @ mod.router
        _, ids = moe._topk(torch.softmax(logits, -1), cfg.experts_per_token)
    per_row = max(int(torch.bincount(r.reshape(-1), minlength=8).max())
                  for r in ids)
    assert (per_row > cap) == (capacity_factor == 1.0)


def test_moe_apply_bf16_matches_reference_and_router_stays_f32():
    rcfg, p0, cfg, mod = _pair("bfloat16")
    assert mod.router.dtype == torch.float32
    assert mod.w_gate.dtype == torch.bfloat16
    x = np.random.default_rng(2).standard_normal((1, 24, cfg.d_model))
    xj = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    yj, auxj, cj = rmoe.moe_apply(p0, rcfg, xj)
    with torch.inference_mode():
        yt, auxt, ct = moe.moe_apply(mod, cfg, xt)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert float(auxt) == pytest.approx(float(auxj), rel=1e-4)


def test_moe_decode_step_is_one_token_a_row():
    """s = 1 (decode): capacity max(int(1.25·k/e), 1) = 1 holds every
    assignment, since a token's k experts differ."""
    rcfg, p0, cfg, mod = _pair()
    x = np.random.default_rng(3).standard_normal((3, 1, cfg.d_model))
    x = x.astype(np.float32)
    yj, _, cj = rmoe.moe_apply(p0, rcfg, jnp.asarray(x))
    with torch.inference_mode():
        yt, _, ct = moe.moe_apply(mod, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=TOL["float32"],
                               atol=TOL["float32"])
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
