"""The port's optimizer and train step against the reference's.

``adamw_update`` on the reference's own cases (three steps on a matrix
and a vector; clipping; bf16 first moments) against the reference's
function on the same numpy inputs, within 1e-6 (f32; the bf16 moments
within one bf16 rounding, 2**-8 relative); weight decay on per-layer
norm scales, which the reference decays because it stacks them over the
groups; ``cosine_schedule`` at every step of a schedule within 1e-7;
``_quantize`` / ``_dequantize`` bit for bit and ``compressed_psum`` over
a two-shard ``ShardGroup`` against the reference's under ``jax.vmap``
with a named axis (the same collectives), within 1e-6; and
``make_train_step`` over three steps against the reference's jitted
step on TINY llama32 and granite in f32: losses within 1e-4 relative,
gradient norms within 1e-4 relative, the LR exactly, and every
parameter within 2e-5 where the reference's bias-corrected second moment
is above 1e-12 (|g| ≳ 1e-6). Below that Adam's update is
``lr · sign(noise)``, so there the bound is 2 · Σ lr."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as RS
from repro.models import model as RM
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro.optim import compress as RC
from repro.optim import cosine_schedule as rcosine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.distributed import ShardGroup
from repro_torch.data import LoaderConfig, SyntheticCorpus, make_batch
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_init, compressed_psum,
                               cosine_schedule)
from repro_torch.optim import compress as C
from repro_torch.optim.adamw import decays

torch.set_num_threads(1)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _rand(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("cfg_kw,lr,scale", [
    ({}, 1e-2, 1.0),                       # the reference's three steps
    ({"clip_norm": 0.1}, 1e-3, 100.0),     # clipped
    ({"weight_decay": 0.0, "b2": 0.999}, 3e-2, 1.0),
])
def test_adamw_matches_reference(cfg_kw, lr, scale):
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,)}
    p_np = _rand(rng, shapes)
    rcfg, cfg = RAdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    rp = jax.tree.map(jnp.asarray, p_np)
    rst = radamw_init(rcfg, rp)
    tp = _t(p_np)
    tst = adamw_init(cfg, tp)
    for _ in range(3):
        g_np = {k: v * scale for k, v in _rand(rng, shapes).items()}
        rp, rst, rn = radamw_update(rcfg, jax.tree.map(jnp.asarray, g_np),
                                    rst, rp, lr)
        tp, tst, tn = adamw_update(cfg, _t(g_np), tst, tp, lr)
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    assert int(tst.count) == int(rst.count) == 3
    for k in p_np:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tst.m[k].numpy(), np.asarray(rst.m[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.v[k].numpy(), np.asarray(rst.v[k]),
                                   rtol=1e-6, atol=1e-9)


def test_clip_reports_the_pre_clip_norm():
    cfg = AdamWConfig(clip_norm=0.1)
    params = {"w": torch.zeros(8)}
    _, _, gnorm = adamw_update(cfg, {"w": torch.full((8,), 100.0)},
                               adamw_init(cfg, params), params, 1e-3)
    assert float(gnorm) > 100


def test_bf16_first_moments_match_reference():
    rcfg = RAdamWConfig(m_dtype="bfloat16", v_dtype="float32")
    cfg = AdamWConfig(m_dtype="bfloat16", v_dtype="float32")
    rng = np.random.default_rng(4)
    p32 = rng.standard_normal((4, 4)).astype(np.float32)
    rp = {"w": jnp.asarray(p32, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p32).to(torch.bfloat16)}
    rst, tst = radamw_init(rcfg, rp), adamw_init(cfg, tp)
    assert tst.m["w"].dtype == torch.bfloat16
    assert tst.v["w"].dtype == torch.float32
    for _ in range(2):
        g = rng.standard_normal((4, 4)).astype(np.float32)
        rp, rst, _ = radamw_update(rcfg, {"w": jnp.asarray(g)}, rst, rp,
                                   1e-2)
        tp, tst, _ = adamw_update(cfg, {"w": torch.from_numpy(g)}, tst, tp,
                                  1e-2)
    assert tp["w"].dtype == torch.bfloat16
    for got, want in ((tp["w"], rp["w"]), (tst.m["w"], rst.m["w"])):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -8, atol=1e-6)


def test_weight_decay_reaches_per_layer_norm_scales():
    """The reference decays leaves of ≥ 2 dims in its stacked layout:
    every per-layer tensor (a norm scale there is (groups, d)), but not
    ``final_norm``'s (d,) scale. With zero gradients only the decay
    moves a parameter."""
    assert decays("layers.3.mixer_ln.scale", torch.ones(8))
    assert decays("embed.tokens", torch.ones(8, 4))
    assert not decays("final_norm.scale", torch.ones(8))
    cfg, rcfg = AdamWConfig(), RAdamWConfig()
    ones = np.ones((2, 8), np.float32)
    rp = {"groups": [{"mixer_ln": {"scale": jnp.asarray(ones)}}],
          "final_norm": {"scale": jnp.ones(8)}}
    rp, _, _ = radamw_update(rcfg, jax.tree.map(jnp.zeros_like, rp),
                             radamw_init(rcfg, rp), rp, 0.5)
    tp = {"layers.0.mixer_ln.scale": torch.ones(8),
          "layers.1.mixer_ln.scale": torch.ones(8),
          "final_norm.scale": torch.ones(8)}
    tp, _, _ = adamw_update(cfg, {k: torch.zeros(8) for k in tp},
                            adamw_init(cfg, tp), tp, 0.5)
    decayed = np.asarray(rp["groups"][0]["mixer_ln"]["scale"])
    assert (decayed < 1).all()
    for g in range(2):
        np.testing.assert_allclose(tp[f"layers.{g}.mixer_ln.scale"].numpy(),
                                   decayed[g], rtol=1e-7)
    np.testing.assert_array_equal(tp["final_norm.scale"].numpy(),
                                  np.asarray(rp["final_norm"]["scale"]))
    assert (tp["final_norm.scale"] == 1).all()


def test_cosine_schedule_matches_reference():
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=60)
    for step in range(0, 70, 3):
        want = float(rcosine(jnp.int32(step), **kw))
        assert abs(float(cosine_schedule(step, **kw)) - want) < 1e-7
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) < 1e-7
    assert abs(float(cosine_schedule(100, peak_lr=1.0, warmup_steps=10,
                                     total_steps=100)) - 0.1) < 1e-6


def test_quantize_matches_reference_and_keeps_the_residual():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000).astype(np.float32)
    rq, rs = RC._quantize(jnp.asarray(x))
    q, s = C._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    err = torch.from_numpy(x) - C._dequantize(q, s)
    assert float(err.abs().max()) <= float(s) * 0.5 + 1e-6
    # the error-feedback contract: the long-run mean stays unbiased
    xt = torch.from_numpy(x)
    acc = torch.zeros_like(xt)
    carried = torch.zeros_like(xt)
    for _ in range(50):
        g = xt + carried
        q, s = C._quantize(g)
        d = C._dequantize(q, s)
        carried = g - d
        acc = acc + d
    np.testing.assert_allclose((acc / 50).numpy(), x, atol=1e-3)


def test_compressed_psum_matches_reference_over_two_shards():
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 5), "b": (5,)}
    grads = [_rand(rng, shapes) for _ in range(2)]
    errs = [{k: 0.01 * v for k, v in _rand(rng, shapes).items()}
            for _ in range(2)]
    stacked = {k: jnp.stack([jnp.asarray(g[k]) for g in grads])
               for k in shapes}
    rstate = RC.CompressionState(error={
        k: jnp.stack([jnp.asarray(e[k]) for e in errs]) for k in shapes})
    rmean, rnew = jax.vmap(
        lambda g, s: RC.compressed_psum(g, "x", s), axis_name="x")(
            stacked, rstate)
    group = ShardGroup(2, ["cpu"])
    states = [C.CompressionState(error=_t(e)) for e in errs]
    means, new = compressed_psum([_t(g) for g in grads], group, states)
    for i in range(2):
        for k in shapes:
            np.testing.assert_allclose(means[i][k].numpy(),
                                       np.asarray(rmean[k][i]), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(new[i].error[k].numpy(),
                                       np.asarray(rnew.error[k][i]),
                                       rtol=1e-6, atol=1e-6)
    fresh = compress_init(_t(grads[0]))
    assert all(float(e.abs().sum()) == 0 for e in fresh.error.values())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
HYPER = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6)


@pytest.fixture(scope="module", params=["llama32_3b", "granite_moe_1b"])
def three_steps(request):
    """Three steps of both packages' train steps on the same batches: the
    reference's jitted once per architecture."""
    arch = request.param
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    model.requires_grad_(True)
    rstep = jax.jit(RS.make_train_step(rcfg, RAdamWConfig(),
                                       RS.TrainHyper(**HYPER)))
    tstep = S.make_train_step(cfg, AdamWConfig(), S.TrainHyper(**HYPER))
    ropt = radamw_init(RAdamWConfig(), params)
    topt = adamw_init(AdamWConfig(), dict(model.named_parameters()))
    corpus = SyntheticCorpus(num_docs=64, mean_doc_len=48,
                             vocab_size=cfg.vocab_size, seed=1)
    lcfg = LoaderConfig(corpus=corpus, seq_len=32, global_batch=4,
                        microbatches=2, vocab_size=cfg.vocab_size)
    metrics = []
    for step in range(3):
        b = make_batch(lcfg, step)
        params, ropt, rm = rstep(params, ropt,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        model, topt, tm = tstep(model, topt,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append((rm, tm))
    return cfg, params, ropt, model, topt, metrics


def test_train_step_metrics_match_reference(three_steps):
    _, _, ropt, _, topt, metrics = three_steps
    for rm, tm in metrics:
        assert set(tm) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        assert float(tm["lr"]) == float(rm["lr"])
    assert int(topt.count) == int(ropt.count) == 3


def test_train_step_parameters_match_reference(three_steps):
    cfg, params, ropt, model, topt, metrics = three_steps
    ref = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, params))
    v_ref = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, ropt.v))
    lr_sum = sum(float(rm["lr"]) for rm, _ in metrics)
    c2 = 1 - AdamWConfig().b2 ** 3
    for n, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - ref[n].numpy())
        live = v_ref[n].numpy() / c2 > 1e-12
        assert d[live].max(initial=0) <= 2e-5, n
        assert d[~live].max(initial=0) <= 2 * lr_sum, n
    # the moments cross the packages in the reference's layout
    back = convert.opt_state_to_numpy(cfg, topt)
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(back[name]),
                        jax.tree.leaves(jax.tree.map(np.asarray,
                                                     getattr(ropt, name)))):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert back["count"].dtype == np.int32 and int(back["count"]) == 3
    again = convert.opt_state_from_numpy(cfg, back, device="cpu")
    for k in topt.m:
        assert torch.equal(again.m[k], topt.m[k])
        assert torch.equal(again.v[k], topt.v[k])
