"""The port's LM stack against the reference on llama32 ``TINY``.

The reference's ``init_params`` pytree, mapped to numpy, is carried into
the port by ``convert.params_from_numpy``; inputs are numpy draws handed
to both. In f32 the tolerance is 1e-4 and greedy ids must be identical.
In bf16 the two packages round at different places (the reference
accumulates every product in f32 before one cast; the port's CPU matmuls
round their bf16 outputs, logits included), so bf16 logits are held to
5e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as M

torch.set_num_threads(1)
F32_TOL = 1e-4
BF16_TOL = 5e-2


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(ref_config("llama32_3b", tiny=True),
                                dtype=dtype, **kw),
            dataclasses.replace(get_config("llama32_3b", tiny=True),
                                dtype=dtype, **kw))


def _pair(dtype="float32", seed=0, **kw):
    """(reference cfg, reference params, port cfg, port model)."""
    rcfg, cfg = _cfgs(dtype, **kw)
    params = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tokens(cfg, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, s))


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    want = rlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = layers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    pos = rng.integers(0, 4000, (2, 11)).astype(np.int32)
    want = rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            500_000.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
def test_gqa_full_matches_reference(attn_impl):
    rcfg, params, cfg, model = _pair(attn_impl=attn_impl, attn_q_chunk=16,
                                     attn_kv_chunk=8)
    x = np.random.default_rng(2).standard_normal((1, 32, cfg.d_model))
    x = x.astype(np.float32)
    pos = np.arange(32, dtype=np.int32)[None, :]
    p0 = jax.tree.map(lambda a: a[0], params["groups"][0]["mixer"])
    want = rattn.gqa_full(p0, rcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attn.gqa_full(model.layers[0].mixer, cfg, torch.from_numpy(x),
                        torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


def _decode_both(rcfg, params, cfg, model, toks, steps):
    """Prefill ``toks`` in both packages, then ``steps`` greedy decode
    steps. Returns per-step (reference logits, port logits) and the
    prefill caches."""
    s = toks.shape[1]
    lj, cj = RM.prefill(params, rcfg, {"tokens": jnp.asarray(toks,
                                                             jnp.int32)})
    with torch.inference_mode():
        lt, ct = model.prefill(torch.from_numpy(toks))
    out = [(lj, lt)]
    prefill_caches = (cj, ct)
    cj = RM.pad_caches(rcfg, cj, s + steps)
    ct = M.pad_caches(cfg, ct, s + steps)
    tj = int(jnp.argmax(lj[0, -1, :rcfg.vocab_size]))
    tt = int(torch.argmax(lt[0, -1, :cfg.vocab_size]))
    for i in range(steps):
        lj, cj = RM.decode_step(params, rcfg, jnp.asarray([[tj]], jnp.int32),
                                cj, jnp.int32(s + i))
        with torch.inference_mode():
            lt, ct = model.decode_step(torch.tensor([[tt]]), ct, s + i)
        out.append((lj, lt))
        tj = int(jnp.argmax(lj[0, -1, :rcfg.vocab_size]))
        tt = int(torch.argmax(lt[0, -1, :cfg.vocab_size]))
    return out, prefill_caches, (cj, ct)


def test_prefill_and_decode_match_reference_f32():
    rcfg, params, cfg, model = _pair()
    toks = _tokens(cfg, 21)
    steps, (cj, ct), (dj, dt) = _decode_both(rcfg, params, cfg, model,
                                             toks, steps=6)
    for lj, lt in steps:
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=F32_TOL,
                                   atol=F32_TOL)
        assert (int(torch.argmax(lt[0, -1, :cfg.vocab_size]))
                == int(jnp.argmax(lj[0, -1, :rcfg.vocab_size])))
    for c_ref, c_port in ((cj, ct), (dj, dt)):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(getattr(c_port[0], name)), _np(getattr(c_ref[0], name)),
                rtol=F32_TOL, atol=F32_TOL)
    # padding lanes of the 509-token vocab (padded to 512) are masked
    lt = steps[0][1]
    assert cfg.padded_vocab == 512
    assert bool((lt[..., cfg.vocab_size:] == -1e30).all())


def test_prefill_and_decode_match_reference_bf16():
    rcfg, params, cfg, model = _pair(dtype="bfloat16")
    steps, _, (dj, dt) = _decode_both(rcfg, params, cfg, model,
                                      _tokens(cfg, 24, seed=3), steps=4)
    for lj, lt in steps:
        np.testing.assert_allclose(_np(lt)[..., :cfg.vocab_size],
                                   _np(lj)[..., :rcfg.vocab_size],
                                   rtol=BF16_TOL, atol=BF16_TOL)
    assert dt[0].k.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_head_dim_no_multiple_of_4_matches_reference(dtype, tol):
    """llama32 TINY with heads of 6 (rows of 12 or 24 bytes: no 16-byte
    multiple), which the reference serves through ``_sdpa``: the port's
    prefill, through the flash-attention wrapper, and its greedy decode
    hold the reference's logits, and in f32 its greedy ids."""
    rcfg, params, cfg, model = _pair(dtype=dtype, head_dim=6)
    steps, _, _ = _decode_both(rcfg, params, cfg, model,
                               _tokens(cfg, 21, seed=4), steps=4)
    for lj, lt in steps:
        np.testing.assert_allclose(_np(lt)[..., :cfg.vocab_size],
                                   _np(lj)[..., :rcfg.vocab_size],
                                   rtol=tol, atol=tol)
        if dtype == "float32":
            assert (int(torch.argmax(lt[0, -1, :cfg.vocab_size]))
                    == int(jnp.argmax(lj[0, -1, :rcfg.vocab_size])))


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_head_dim_wider_than_256_matches_reference(dtype, tol):
    """llama32 TINY with heads of 320, wider than the narrow instances'
    256 (on the card the wide instance: d in chunks, o in two slices):
    the port's prefill, through the flash-attention wrapper, and its
    greedy decode hold the reference's logits, and in f32 its greedy
    ids."""
    rcfg, params, cfg, model = _pair(dtype=dtype, head_dim=320)
    steps, _, _ = _decode_both(rcfg, params, cfg, model,
                               _tokens(cfg, 21, seed=5), steps=4)
    for lj, lt in steps:
        np.testing.assert_allclose(_np(lt)[..., :cfg.vocab_size],
                                   _np(lj)[..., :rcfg.vocab_size],
                                   rtol=tol, atol=tol)
        if dtype == "float32":
            assert (int(torch.argmax(lt[0, -1, :cfg.vocab_size]))
                    == int(jnp.argmax(lj[0, -1, :rcfg.vocab_size])))


def test_params_round_trip_through_numpy():
    for dtype in ("float32", "bfloat16"):
        rcfg, params, cfg, model = _pair(dtype=dtype)
        tree = jax.tree.map(np.asarray, params)
        back = convert.params_to_numpy(cfg, model.state_dict())
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
        # and back again into a fresh model, bit for bit
        again = M.Model(cfg, device="cpu", seed=5)
        again.load_state_dict(convert.params_from_numpy(cfg, back))
        for (n, x), (_, y) in zip(model.state_dict().items(),
                                  again.state_dict().items()):
            assert torch.equal(x, y), n


def test_own_initialisation_is_seeded_and_follows_reference_scales():
    _, cfg = _cfgs()
    a = M.Model(cfg, device="cpu", seed=7)
    b = M.Model(cfg, device="cpu", seed=7)
    c = M.Model(cfg, device="cpu", seed=8)
    for (n, x), (_, y), (_, z) in zip(a.state_dict().items(),
                                      b.state_dict().items(),
                                      c.state_dict().items()):
        assert torch.equal(x, y), n
        if not n.endswith("scale"):
            assert not torch.equal(x, z), n
    assert float(a.embed.tokens.std()) == pytest.approx(0.02, rel=0.1)
    wq = a.layers[0].mixer.wq
    assert float(wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert bool((a.layers[0].mixer_ln.scale == 1).all())


def test_pad_caches_always_returns_fresh_storage():
    _, cfg = _cfgs()
    caches = M.init_caches(cfg, 1, 8, torch.float32, device="cpu")
    for new_len in (4, 8, 12):
        grown = M.pad_caches(cfg, caches, new_len)
        assert grown[0].k.shape[2] == max(new_len, 8)
        assert grown[0].k.data_ptr() != caches[0].k.data_ptr()
        grown[0].k.fill_(1.0)
        assert bool((caches[0].k == 0).all())


def test_unported_architectures_and_entry_points_raise():
    """Every id and alias resolves to a model the port builds; an unknown
    arch and an unknown layout raise; training, once unported, runs."""
    for arch in ARCH_IDS:
        assert get_config(arch, tiny=True).name
    assert get_config("llama3.2-3b").num_layers == 28
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no_such_arch")
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="mixers"):
        M.Model(dataclasses.replace(cfg, layer_pattern=("conv",)),
                device="cpu")
    model = M.Model(cfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    logits, aux, counts = model.forward_train({"tokens": toks})
    assert logits.shape == (1, 8, cfg.padded_vocab) and counts is None
    loss, metrics = model.loss_fn({"tokens": toks, "labels": toks})
    assert torch.isfinite(loss) and float(metrics["tokens"]) == 8
