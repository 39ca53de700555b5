"""The port's MLA (multi-head latent attention) against the reference, on
minicpm3 ``TINY`` (40→4 heads, q_lora 32, kv_lora 16, nope 16, rope 8,
v_head 16).

The reference's ``init_params`` pytree is carried into the port by
``convert.params_from_numpy``; inputs are numpy draws handed to both.
``mla_full`` (the flash-attention kernel's plain version on the CPU)
runs under both ``attn_impl``; the three cache modes (absorbed
attention over the latent cache) write their rows in place. f32 within
1e-4, f16 within 1e-2 (``tests/test_torch_f16.py``'s logit tolerance),
bf16 within 5e-2. The reference's bf16 cache modes do not run on JAX's
CPU backend (its batched bf16 x bf16 → f32 dots are unsupported there),
so the port's bf16 cache modes are held to the reference run in f32 on
the same bf16-rounded weights and inputs; its f16 cache modes run there,
and the port's are held to them directly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as rattn
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import model as M

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "float16": 1e-2, "bfloat16": 5e-2}


def _pair(dtype="float32", **kw):
    """(reference cfg, layer-0 MLA params, port cfg, port model)."""
    rcfg = dataclasses.replace(ref_config("minicpm3_4b", tiny=True),
                               dtype=dtype, **kw)
    cfg = dataclasses.replace(get_config("minicpm3_4b", tiny=True),
                              dtype=dtype, **kw)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    p0 = jax.tree.map(lambda a: a[0], params["groups"][0]["mixer"])
    return rcfg, p0, cfg, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _to(a, dtype):
    """A numpy f32 array as (jnp, torch) in ``dtype``, the same values."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _ref_mode(fn, p0, rcfg, *args):
    """The reference's cache mode ``fn``; for bf16, run in f32 on the
    bf16 values (see the module docstring)."""
    if rcfg.dtype != "bfloat16":
        return fn(p0, rcfg, *args)
    up = lambda a: (a.astype(jnp.float32) if hasattr(a, "dtype")
                    and a.dtype == jnp.bfloat16 else a)
    return fn(jax.tree.map(up, p0), dataclasses.replace(rcfg,
                                                        dtype="float32"),
              *jax.tree.map(up, args))


def _cache(rng, cfg, b, s_max, dtype, filled):
    """An MLA cache whose first ``filled`` rows hold draws, zeros after."""
    lat = rng.standard_normal((b, s_max, cfg.kv_lora_rank)).astype(np.float32)
    rope = rng.standard_normal((b, s_max, cfg.qk_rope_dim)).astype(np.float32)
    lat[:, filled:] = 0
    rope[:, filled:] = 0
    (lj, lt), (rj, rt) = _to(lat, dtype), _to(rope, dtype)
    return rattn.MLACache(lj, rj), attn.MLACache(lt, rt)


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
def test_mla_full_matches_reference(attn_impl):
    rcfg, p0, cfg, model = _pair(attn_impl=attn_impl, attn_q_chunk=16,
                                 attn_kv_chunk=8)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want = rattn.mla_full(p0, rcfg, jnp.asarray(x), jnp.asarray(pos))
    got, latent, k_rope = attn.mla_full_cache(
        model.layers[0].mixer, cfg, torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(pos)))
    _close(got, want, TOL["float32"])
    # the cache prefill keeps: the reference's ``_mla_prefill``
    _, rc = RM._mla_prefill(p0, rcfg, jnp.asarray(x), jnp.asarray(pos))
    _close(latent, rc.latent, TOL["float32"])
    _close(k_rope, rc.k_rope, TOL["float32"])
    assert latent.shape == (2, 32, cfg.kv_lora_rank)
    assert k_rope.shape == (2, 32, cfg.qk_rope_dim)


def test_mla_full_bf16_matches_reference():
    rcfg, p0, cfg, model = _pair("bfloat16")
    x = np.random.default_rng(3).standard_normal((1, 24, cfg.d_model))
    xj, xt = _to(x.astype(np.float32), "bfloat16")
    pos = np.arange(24, dtype=np.int32)[None, :]
    want = rattn.mla_full(p0, rcfg, xj, jnp.asarray(pos))
    got = attn.mla_full(model.layers[0].mixer, cfg, xt,
                        torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_mla_decode_matches_reference(dtype):
    rcfg, p0, cfg, model = _pair(dtype)
    rng = np.random.default_rng(4)
    cj, ct = _cache(rng, cfg, 2, 20, dtype, filled=11)
    xj, xt = _to(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32),
                 dtype)
    want, wc = _ref_mode(rattn.mla_decode, p0, rcfg, xj, cj, jnp.int32(11))
    with torch.inference_mode():
        got, gc = attn.mla_decode(model.layers[0].mixer, cfg, xt, ct, 11)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert gc.latent.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])
    _close(gc.latent, wc.latent, TOL[dtype])
    _close(gc.k_rope, wc.k_rope, TOL[dtype])
    assert gc.latent is ct.latent                      # written in place
    with pytest.raises(IndexError):
        attn.mla_decode(model.layers[0].mixer, cfg, xt, ct, 20)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_mla_decode_packed_matches_reference(dtype):
    """Four rows at their own depths, the last parked on the scratch row:
    each row's latent and roped key land at its index."""
    rcfg, p0, cfg, model = _pair(dtype)
    rng = np.random.default_rng(5)
    b, s_max = 4, 33
    cj, ct = _cache(rng, cfg, b, s_max, dtype, filled=24)
    xj, xt = _to(rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32),
                 dtype)
    idx = np.asarray([5, 23, 0, s_max - 1], np.int32)
    want, wc = _ref_mode(rattn.mla_decode_packed, p0, rcfg, xj, cj,
                         jnp.asarray(idx))
    with torch.inference_mode():
        got, gc = attn.mla_decode_packed(model.layers[0].mixer, cfg, xt, ct,
                                         torch.from_numpy(idx))
    _close(got, want, TOL[dtype])
    _close(gc.latent, wc.latent, TOL[dtype])
    _close(gc.k_rope, wc.k_rope, TOL[dtype])
    assert gc.k_rope is ct.k_rope


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_mla_chunk_append_matches_reference(dtype):
    """A 16-token chunk at rows 16..31 over a cache whose first 16 rows
    hold an earlier chunk."""
    rcfg, p0, cfg, model = _pair(dtype)
    rng = np.random.default_rng(6)
    cj, ct = _cache(rng, cfg, 1, 40, dtype, filled=16)
    xj, xt = _to(rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32),
                 dtype)
    want, wc = _ref_mode(rattn.mla_chunk_append, p0, rcfg, xj, cj,
                         jnp.int32(16))
    with torch.inference_mode():
        got, gc = attn.mla_chunk_append(model.layers[0].mixer, cfg, xt, ct,
                                        16)
    _close(got, want, TOL[dtype])
    _close(gc.latent, wc.latent, TOL[dtype])
    _close(gc.k_rope, wc.k_rope, TOL[dtype])
    assert gc.latent is ct.latent
    with pytest.raises(IndexError):
        attn.mla_chunk_append(model.layers[0].mixer, cfg, xt, ct, 30)


def test_mla_model_modes_match_reference():
    """``Model.prefill_chunk`` and ``decode_step_packed`` on MLA caches
    against ``M.prefill_chunk`` / ``M.decode_step_packed``: logits and
    every cache row."""
    rcfg = dataclasses.replace(ref_config("minicpm3_4b", tiny=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("minicpm3_4b", tiny=True),
                              dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    cj = RM.init_caches(rcfg, 2, 33, jnp.float32)
    ct = M.init_caches(cfg, 2, 33, torch.float32, device="cpu")
    assert isinstance(ct[0], attn.MLACache)
    assert ct[0].latent.shape == (cfg.num_groups, 2, 33, cfg.kv_lora_rank)
    lj, cj = RM.prefill_chunk(params, rcfg, jnp.asarray(toks, jnp.int32),
                              cj, jnp.int32(0))
    with torch.inference_mode():
        lt, ct = model.prefill_chunk(torch.from_numpy(toks), ct, 0)
    _close(lt, lj, TOL["float32"])
    idx = np.asarray([16, 32], np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1))
    lj, cj = RM.decode_step_packed(params, rcfg, jnp.asarray(nxt, jnp.int32),
                                   cj, jnp.asarray(idx))
    with torch.inference_mode():
        lt, ct = model.decode_step_packed(torch.from_numpy(nxt), ct,
                                          torch.from_numpy(idx))
    _close(lt, lj, TOL["float32"])
    for name in ("latent", "k_rope"):
        _close(getattr(ct[0], name), getattr(cj[0], name), TOL["float32"])
