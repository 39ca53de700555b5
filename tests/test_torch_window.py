"""Sliding-window attention (``cfg.sliding_window = w > 0``) in the port,
held against the reference's windowed ``gqa_full`` / ``prefill`` /
``loss_fn`` on the CPU.

The reference computes the window in ``gqa_full`` only (``_causal_mask``,
``_sdpa_chunked``); its decode, packed-decode and chunk-append modes mask
``kpos <= index`` alone. The port holds every GQA mode to the windowed
``gqa_full``: decode at position t equals row t of the reference's
``gqa_full`` over tokens 0..t, and a greedy serve equals the reference's
greedy re-prefill (its ``prefill`` over the prompt plus the tokens
generated so far). That oracle is read from one reference
``forward_train`` over the whole final sequence: attention is causal, so
its logits at position t are the re-prefill's over tokens 0..t (checked
against ``prefill`` itself at the first and the last step). MLA keeps no
window, as the reference's dense ``mla_full`` and its MLA cache modes.

Inputs are numpy draws from a seed; weights are the reference's
``init_params`` carried over by ``convert.params_from_numpy``. f32
throughout, within ``F32_TOL`` (1e-4, ``tests/test_torch_model.py``'s)
unless stated."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed._local_tensor import LocalTensorMode

from repro.configs import get_config as ref_config
from repro.models import attention as rattn
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import kernel as FK
from repro_torch.kernels.flash_attn.ref import sdpa_ref
from repro_torch.launch import mesh as mesh_mod, sharding as shd, steps
from repro_torch.launch.dryrun import ensure_world, leave_world, quiet
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import (ContinuousBatchingScheduler, PrefixKVCache,
                                 Request, SchedRequest, ServeEngine)

torch.set_num_threads(1)
F32_TOL = 1e-4
W = 8                         # the model tests' window


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(arch="llama32_3b", **kw):
    """(reference cfg, reference params, port cfg, port model): ``arch``'s
    TINY in f32 with ``kw`` replaced in both configs."""
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype="float32",
                               **kw)
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32",
                              **kw)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["groups"][0]["mixer"])


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the plain version and the full-sequence forms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,w", [(33, 1), (33, 8), (64, 17), (40, 64)])
def test_sdpa_ref_window_matches_reference(s, w):
    """``sdpa_ref(window=w)`` and the wrapper's CPU path against the
    reference's ``_sdpa`` under ``_causal_mask(s, s, 0, w)``."""
    rng = np.random.default_rng(s + w)
    q, k, v = (rng.standard_normal((2, s, h, 16)).astype(np.float32)
               for h in (6, 2, 2))
    want = rattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       rattn._causal_mask(s, s, 0, w))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = sdpa_ref(qt, kt, vt, window=w)
    _close(got, want, 2e-5)
    assert torch.equal(FK.flash_attention_fwd(qt, kt, vt, window=w), got)
    np.testing.assert_array_equal(
        _np(attn._causal_mask(s, "cpu", w)),
        _np(rattn._causal_mask(s, s, 0, w)))
    if w < s:       # the window changes the result
        assert not torch.allclose(got, sdpa_ref(qt, kt, vt), atol=1e-3)


def test_window_needs_causal_attention():
    q = torch.zeros((1, 4, 2, 8))
    for fn in (lambda: sdpa_ref(q, q, q, causal=False, window=2),
               lambda: FK.flash_attention_fwd(q, q, q, causal=False,
                                              window=2),
               lambda: sdpa_ref(q, q, q, window=-1)):
        with pytest.raises(ValueError, match="window"):
            fn()


@pytest.mark.parametrize("w", [5, 12])
@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
def test_gqa_full_window_matches_reference(attn_impl, w):
    """Prefill's form (the kernel's plain version) and the training form
    (``_sdpa`` / ``_sdpa_chunked``, which skips the key tiles before every
    row's window) against the reference's windowed ``gqa_full``; 16-row
    query and 8-key chunks, so the window crosses chunk edges."""
    rcfg, params, cfg, model = _pair(attn_impl=attn_impl, attn_q_chunk=16,
                                     attn_kv_chunk=8, sliding_window=w)
    x = _x(cfg, 2, 32, seed=w)
    pos = np.arange(32, dtype=np.int32)[None, :]
    want = rattn.gqa_full(_layer0(params), rcfg, jnp.asarray(x),
                          jnp.asarray(pos))
    mixer = model.layers[0].mixer
    for train in (False, True):
        got = attn.gqa_full(mixer, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos), train=train)
        _close(got, want)
    unwindowed = rattn.gqa_full(_layer0(params),
                                dataclasses.replace(rcfg, sliding_window=0),
                                jnp.asarray(x), jnp.asarray(pos))
    assert not np.allclose(_np(want), _np(unwindowed), atol=1e-3)


# ---------------------------------------------------------------------------
# the cache modes against the reference's windowed gqa_full rows
# ---------------------------------------------------------------------------
def _kv_rows(model, cfg, x, s_max, filled):
    """The port's roped K/V of ``x`` (b, s, d) in a cache of ``s_max``
    rows, row r of batch row i kept below ``filled[i]`` (zeros above)."""
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32)[None, :].expand(b, s)
    with torch.inference_mode():
        _, k, v = attn.gqa_full_kv(model.layers[0].mixer, cfg,
                                   torch.from_numpy(x), pos)
    shape = (b, s_max, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    for i, n in enumerate(filled):
        ck[i, :n], cv[i, :n] = k[i, :n], v[i, :n]
    return attn.KVCache(ck, cv)


def _decode_rows(model, cfg, x, t0, s_max):
    """``gqa_decode`` token by token from position ``t0`` on, the rows
    before it from ``gqa_full_kv`` → (b, s - t0, d)."""
    cache = _kv_rows(model, cfg, x, s_max, [t0] * x.shape[0])
    outs = []
    for t in range(t0, x.shape[1]):
        with torch.inference_mode():
            o, cache = attn.gqa_decode(model.layers[0].mixer, cfg,
                                       torch.from_numpy(x[:, t:t + 1]),
                                       cache, t)
        outs.append(o)
    return torch.cat(outs, dim=1)


def _packed_rows(model, cfg, x, idx, s_max):
    """One ``gqa_decode_packed`` step, row i at ``idx[i]`` over its rows
    below it → (b, 1, d)."""
    cache = _kv_rows(model, cfg, x, s_max, idx)
    xs = np.stack([x[i, n] for i, n in enumerate(idx)])[:, None]
    with torch.inference_mode():
        o, _ = attn.gqa_decode_packed(model.layers[0].mixer, cfg,
                                      torch.from_numpy(xs), cache,
                                      torch.tensor(idx))
    return o


def _chunk_rows(model, cfg, x, start, s_max):
    """One ``gqa_chunk_append`` of positions ``[start, s)`` over the rows
    below ``start`` → (b, s - start, d)."""
    cache = _kv_rows(model, cfg, x, s_max, [start] * x.shape[0])
    with torch.inference_mode():
        o, _ = attn.gqa_chunk_append(model.layers[0].mixer, cfg,
                                     torch.from_numpy(x[:, start:]), cache,
                                     start)
    return o


@pytest.mark.parametrize("w", [5, 12])
@pytest.mark.parametrize("mode", ["decode", "packed", "chunk"])
def test_cache_modes_match_reference_windowed_gqa_full(mode, w):
    """Each cache mode at position t equals row t of the reference's
    windowed ``gqa_full`` over tokens 0..t (packed rows at mixed depths,
    one of them below the window)."""
    rcfg, params, cfg, model = _pair(sliding_window=w)
    x = _x(cfg, 3, 30, seed=10 + w)
    pos = np.broadcast_to(np.arange(30, dtype=np.int32), (3, 30))
    full = _np(rattn.gqa_full(_layer0(params), rcfg, jnp.asarray(x),
                              jnp.asarray(pos)))
    if mode == "decode":
        _close(_decode_rows(model, cfg, x, 3, 34), full[:, 3:])
    elif mode == "packed":
        idx = [29, 3, 17]
        want = np.stack([full[i, n] for i, n in enumerate(idx)])[:, None]
        _close(_packed_rows(model, cfg, x, idx, 34), want)
    else:
        _close(_chunk_rows(model, cfg, x, 14, 34), full[:, 14:])


def test_cache_modes_without_a_window_are_the_references():
    """With ``sliding_window=0`` each mode matches the reference's own mode
    on the same cache, and equals the port's mode under a window no
    shorter than the cache bit for bit (the lower edge keeps every
    row)."""
    rcfg, params, cfg, model = _pair()
    wide = dataclasses.replace(cfg, sliding_window=64)
    x = _x(cfg, 3, 30, seed=4)
    mixer, p0 = model.layers[0].mixer, _layer0(params)
    cache = _kv_rows(model, cfg, x, 34, [20] * 3)
    rcache = rattn.KVCache(jnp.asarray(cache.k.numpy()),
                           jnp.asarray(cache.v.numpy()))
    idx = [20, 7, 33]
    xs = np.stack([x[i, min(n, 29)] for i, n in enumerate(idx)])[:, None]
    runs = [
        (lambda c, k: attn.gqa_decode(mixer, c, torch.from_numpy(
            x[:, 20:21]), k, 20)[0],
         lambda: rattn.gqa_decode(p0, rcfg, jnp.asarray(x[:, 20:21]),
                                  rcache, 20)[0]),
        (lambda c, k: attn.gqa_decode_packed(mixer, c, torch.from_numpy(xs),
                                             k, torch.tensor(idx))[0],
         lambda: rattn.gqa_decode_packed(p0, rcfg, jnp.asarray(xs), rcache,
                                         jnp.asarray(idx, jnp.int32))[0]),
        (lambda c, k: attn.gqa_chunk_append(mixer, c, torch.from_numpy(
            x[:, 20:]), k, 20)[0],
         lambda: rattn.gqa_chunk_append(p0, rcfg, jnp.asarray(x[:, 20:]),
                                        rcache, 20)[0])]
    for port, ref in runs:
        with torch.inference_mode():
            got = port(cfg, attn.KVCache(cache.k.clone(), cache.v.clone()))
            same = port(wide, attn.KVCache(cache.k.clone(),
                                           cache.v.clone()))
        _close(got, ref())
        assert torch.equal(got, same)


def test_reference_decode_ignores_the_window():
    """The reference's fault the port departs from: its ``gqa_decode`` at
    an index at or past the window attends to rows its windowed
    ``gqa_full`` leaves out, so the two differ there (and agree below
    it)."""
    rcfg, params, cfg, model = _pair(sliding_window=W)
    x = _x(cfg, 1, 20, seed=6)
    p0 = _layer0(params)
    full = _np(rattn.gqa_full(p0, rcfg, jnp.asarray(x),
                              jnp.asarray(np.arange(20, dtype=np.int32)[None])))
    cache = _kv_rows(model, cfg, x, 20, [20])
    rcache = rattn.KVCache(jnp.asarray(cache.k.numpy()),
                           jnp.asarray(cache.v.numpy()))
    for t, differs in ((W - 1, False), (W, True), (19, True)):
        got = _np(rattn.gqa_decode(p0, rcfg, jnp.asarray(x[:, t:t + 1]),
                                   rcache, t)[0])
        assert np.allclose(got, full[:, t:t + 1], atol=F32_TOL) != differs


# ---------------------------------------------------------------------------
# the model, serving and training
# ---------------------------------------------------------------------------
def _oracle(rcfg, params, seqs):
    """The reference's greedy re-prefill logits (b, s, V) of ``seqs``
    (equal lengths): one ``forward_train``, whose row t is its
    ``prefill`` over tokens 0..t (causal attention)."""
    logits, _, _ = RM.forward_train(params, rcfg, {
        "tokens": jnp.asarray(np.asarray(seqs), jnp.int32)})
    return _np(logits)


@pytest.mark.parametrize("arch", ["llama32_3b", "starcoder2_7b"])
def test_greedy_decode_equals_reference_re_prefill(arch):
    """Prefill of a 21-token prompt, then 16 greedy steps (positions past
    the window of 8): identical ids, and every step's logits within
    ``F32_TOL`` of the reference's prefill over the prompt plus the ids
    generated so far."""
    rcfg, params, cfg, model = _pair(arch, sliding_window=W)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 21)
    steps_n = 16
    with torch.inference_mode():
        logits, caches = model.prefill(torch.from_numpy(prompt[None]))
        caches = M.pad_caches(cfg, caches, len(prompt) + steps_n)
        got, ids = [logits[0, -1]], []
        for i in range(steps_n):
            ids.append(int(torch.argmax(got[-1][:cfg.vocab_size])))
            logits, caches = model.decode_step(torch.tensor([[ids[-1]]]),
                                               caches, len(prompt) + i)
            got.append(logits[0, -1])
    seq = list(prompt) + ids
    want = _oracle(rcfg, params, [seq])[0, len(prompt) - 1:]
    assert [int(np.argmax(r[:cfg.vocab_size])) for r in want[:-1]] == ids
    _close(torch.stack(got), want)
    for n in (len(prompt), len(seq)):       # the oracle is the re-prefill
        lj, _ = RM.prefill(params, rcfg, {
            "tokens": jnp.asarray([seq[:n]], jnp.int32)})
        _close(lj[0, -1], want[n - len(prompt)])


def _serve_prompts(vocab):
    """#0 of its own, #1 and #2 sharing its first 16 tokens (prefix hits
    that decode 24 prompt tokens past a window of 8), #3 fresh."""
    rng = np.random.default_rng(2)
    fresh = lambda n: [int(t) for t in rng.integers(0, vocab, n)]
    p0 = fresh(40)
    return [p0, p0[:16] + fresh(24), p0[:16] + fresh(24), fresh(40)]


@pytest.mark.parametrize("arch", ["llama32_3b", "starcoder2_7b"])
def test_serve_engine_with_prefix_hits_equals_reference_re_prefill(arch):
    """``ServeEngine`` over a device ``PrefixKVCache`` (2 hits, whose
    remaining prompt is decoded over the cached rows): every request's
    ids equal the reference's greedy re-prefill's."""
    rcfg, params, cfg, model = _pair(arch, sliding_window=W)
    prompts = _serve_prompts(cfg.vocab_size)
    cache = PrefixKVCache(block_tokens=8, capacity_blocks=16,
                          backend="device", device="cpu", q_log2=10,
                          r_log2=6)
    done = ServeEngine(cfg, model, prefix_cache=cache).serve(
        [Request(prompt=list(p), max_new_tokens=8) for p in prompts])
    assert [r.cached_tokens for r in done] == [0, 16, 16, 0]
    cache.close()
    want = _oracle(rcfg, params, [p + r.output[:-1]
                                  for p, r in zip(prompts, done)])
    for p, r, lw in zip(prompts, done, want):
        assert r.output == [int(np.argmax(row[:cfg.vocab_size]))
                            for row in lw[len(p) - 1:]]


def test_continuous_scheduler_equals_serial_engine():
    """The continuous scheduler (chunked prefill into slot caches, packed
    decode at mixed depths, prefix hits) gives the serial engine's ids
    under a window of 8, and the serial engine the reference's greedy
    re-prefill's."""
    rcfg, params, cfg, model = _pair(sliding_window=W)
    rng = np.random.default_rng(3)
    shared = [int(t) for t in rng.integers(1, cfg.vocab_size, 16)]
    prompts = [shared + [int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (5, 9, 0, 16)]
    cache = PrefixKVCache(block_tokens=16, capacity_blocks=32,
                          backend="device", device="cpu", q_log2=10,
                          r_log2=6)
    sched = ContinuousBatchingScheduler(cfg, model, prefix_cache=cache,
                                        max_slots=2, max_context=64)
    done = sorted(sched.run([SchedRequest(prompt=list(p), max_new_tokens=6,
                                          request_id=i)
                             for i, p in enumerate(prompts)]),
                  key=lambda r: r.request_id)
    cache.close()
    assert sched.chunk_calls > 0 and sched.decode_steps > 0
    assert any(r.cached_tokens for r in done)
    serial = ServeEngine(cfg, model).serve(
        [Request(prompt=list(p), max_new_tokens=6) for p in prompts])
    assert [r.output for r in done] == [r.output for r in serial]
    for p, r in zip(prompts, serial):
        want = _oracle(rcfg, params, [p + r.output[:-1]])[0]
        assert r.output == [int(np.argmax(row[:cfg.vocab_size]))
                            for row in want[len(p) - 1:]]


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
def test_loss_and_grads_match_reference(attn_impl):
    """``loss_fn`` and every parameter's gradient against ``jax.grad`` of
    the reference's windowed ``loss_fn`` (64 tokens, a window of 8; 16 x
    8 chunks) within 1e-4 · max(1, max|g_ref|)."""
    rcfg, params, cfg, model = _pair(sliding_window=W, attn_impl=attn_impl,
                                     attn_q_chunk=16, attn_kv_chunk=8)
    model.requires_grad_(True)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    labels[rng.random((2, 64)) < 0.2] = -1
    (loss_j, _), gj = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        params, rcfg, {"tokens": jnp.asarray(toks),
                       "labels": jnp.asarray(labels)})
    loss_t, _ = model.loss_fn({"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss_t, [p for _, p in
                                         model.named_parameters()])
    ref = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, gj))
    for n, g in zip(names, grads):
        gr = ref[n].numpy()
        np.testing.assert_allclose(
            _np(g), gr, rtol=0, atol=1e-4 * max(1.0, float(np.abs(gr).max())),
            err_msg=n)


def test_mla_keeps_no_window():
    """minicpm3 (MLA) with a window: its prefill attention (``mla_full``)
    equals the reference's dense ``mla_full``, which ignores the window,
    and the port's prefill equals its own without a window."""
    rcfg, params, cfg, model = _pair("minicpm3_4b", sliding_window=W)
    x = _x(cfg, 1, 24, seed=7)
    pos = np.arange(24, dtype=np.int32)[None, :]
    want = rattn.mla_full(_layer0(params), rcfg, jnp.asarray(x),
                          jnp.asarray(pos))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 24)))
    with torch.inference_mode():
        got = attn.mla_full(model.layers[0].mixer, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos))
        lt, _ = model.prefill(toks)
        model.cfg = dataclasses.replace(cfg, sliding_window=0)
        plain, _ = model.prefill(toks)
    _close(got, want)
    assert torch.equal(lt, plain)


# ---------------------------------------------------------------------------
# sharded: a simulated 2×4 mesh
# ---------------------------------------------------------------------------
@pytest.fixture
def world():
    quiet()
    ensure_world(8)
    yield
    leave_world()


def _rel(a, b):
    """‖a − b‖ / ‖b‖ of two tensors' whole values."""
    a, b = (t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in (a, b))
    a, b = (t.reconcile() if hasattr(t, "reconcile") else t for t in (a, b))
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_sharded_windowed_prefill_and_decode_equal_the_unsharded(world):
    """TINY llama32 with a window of 8 on a simulated 2×4 mesh (heads split
    over the model axis, 8 sequences over data, the decode caches' key
    axis split over data): a 24-token prefill and a decode step at
    position 24 equal the unsharded port's within 1e-5 (norm-wise)."""
    cfg = dataclasses.replace(get_config("llama32_3b", tiny=True),
                              dtype="float32", sliding_window=W)
    shape = ShapeConfig("tiny_dec", seq_len=32, global_batch=8,
                        kind="decode")
    plain = M.Model(cfg, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 24)), dtype=torch.int32)
    nxt = toks[:, :1].clone()
    want, caches = steps.make_prefill_step(cfg)(plain, {"tokens": toks})
    caches = M.pad_caches(cfg, caches, shape.seq_len)
    want_dec, _, _ = steps.make_decode_step(cfg)(
        plain, M.pad_caches(cfg, caches, shape.seq_len), nxt, 24)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(plain.state_dict())
    with LocalTensorMode(8):
        plan = mesh_mod.plan_for(cfg, model_axis=4)
        mesh = mesh_mod.arch_mesh(
            mesh_mod.small_mesh((2, 4), ("data", "model"), "cpu"), plan)
        pp = shd.ParallelPlan()
        shd.distribute_model(model, mesh,
                             shd.param_shardings(mesh, cfg, plan, pp))
        data = shd.placements_from_spec(mesh, ("data", None))
        with steps.sharded(mesh, shd.logical_rules(plan, pp)):
            got, _ = steps.make_prefill_step(cfg)(
                model, {"tokens": shd.distribute_tree(toks, mesh, data)})
            sc = shd.distribute_tree(
                caches, mesh, shd.cache_shardings(mesh, cfg, plan, pp,
                                                  shape))
            got_dec, _, _ = steps.make_decode_step(cfg)(
                model, sc, shd.distribute_tree(nxt, mesh, data), 24)
        assert _rel(got, want) <= 1e-5
        assert _rel(got_dec, want_dec) <= 1e-5
