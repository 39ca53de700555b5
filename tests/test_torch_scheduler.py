"""The port's continuous batching against the reference, on the CPU.

Packed decode and chunked append are held to the reference's
``gqa_decode_packed`` / ``gqa_chunk_append`` (f32 within 1e-5, bf16
within 5e-2) and ``Model.prefill_chunk`` / ``decode_step_packed`` to
``M.prefill_chunk`` / ``M.decode_step_packed`` (f32, logits and every
cache row). ``make_trace`` must draw the reference's trace. The paged
``PrefixKVCache`` API runs one script of operations on both packages'
caches, on ``sim`` and on the device backend. The scheduler, on llama32
``TINY`` in f32 with the reference's weights (``convert.params_from_numpy``),
must give the reference scheduler's outputs, cached prefixes, chunk and
decode counts and cache stats, and the port's serial engine's outputs.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as rattn
from repro.models import model as RM
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import PrefixKVCache as RefPrefixKVCache
from repro.serving import SchedRequest as RefSchedRequest
from repro.serving import make_trace as ref_make_trace
from repro.serving import replay_trace as ref_replay_trace
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.attention import KVCache
from repro_torch.serving import (ContinuousBatchingScheduler, PrefixKVCache,
                                 Request, SchedRequest, ServeEngine,
                                 make_trace, replay_trace)

torch.set_num_threads(1)
GEOM = dict(q_log2=10, r_log2=6)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
F32_TOL = 1e-4
#: prefix-cache counters that depend on how often H_R drains
FLUSH_STATS = ("tile_stores", "carried", "query_batches", "query_cache_hits",
               "query_device_keys", "write_buffered", "write_cancelled",
               "write_flushes", "write_dispatches")


def _pair(dtype="float32"):
    """(reference cfg, reference params, port cfg, port model) on llama32
    TINY, the port carrying the reference's weights."""
    rcfg = dataclasses.replace(ref_config("llama32_3b", tiny=True),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("llama32_3b", tiny=True),
                              dtype=dtype)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _to(a, dtype):
    """A numpy f32 array as (jnp, torch) in ``dtype``."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _kv(rng, cfg, b, s_max, dtype, filled):
    """A KV cache whose first ``filled`` rows hold draws, zeros after."""
    shape = (b, s_max, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    k[:, filled:] = 0
    v[:, filled:] = 0
    (kj, kt), (vj, vt) = _to(k, dtype), _to(v, dtype)
    return rattn.KVCache(kj, vj), KVCache(kt, vt)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["groups"][0]["mixer"])


# ---------------------------------------------------------------------------
# attention: packed decode and chunked append
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_packed_matches_reference(dtype):
    """Four rows at their own depths, the last parked on the scratch row
    (``s_max - 1``): each row's K/V lands at its index, each row attends
    to its own prefix."""
    rcfg, params, cfg, model = _pair(dtype)
    rng = np.random.default_rng(3)
    b, s_max = 4, 33
    cj, ct = _kv(rng, cfg, b, s_max, dtype, filled=24)
    xj, xt = _to(rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32),
                 dtype)
    idx = np.asarray([5, 23, 0, s_max - 1], np.int32)
    want, wc = rattn.gqa_decode_packed(_layer0(params), rcfg, xj, cj,
                                       jnp.asarray(idx))
    with torch.inference_mode():
        got, gc = attn.gqa_decode_packed(model.layers[0].mixer, cfg, xt, ct,
                                         torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _assert_close(got, want, TOL[dtype])
    _assert_close(gc.k, wc.k, TOL[dtype])
    _assert_close(gc.v, wc.v, TOL[dtype])
    assert gc.k is ct.k                                # written in place


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_chunk_append_matches_reference(dtype):
    """A 16-token chunk at ``start=16`` over a cache whose first 16 rows
    already hold K/V: rows [16, 32) are written, the rest kept."""
    rcfg, params, cfg, model = _pair(dtype)
    rng = np.random.default_rng(4)
    cj, ct = _kv(rng, cfg, 2, 41, dtype, filled=16)
    xj, xt = _to(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32),
                 dtype)
    want, wc = rattn.gqa_chunk_append(_layer0(params), rcfg, xj, cj,
                                      16)
    with torch.inference_mode():
        got, gc = attn.gqa_chunk_append(model.layers[0].mixer, cfg, xt, ct,
                                        16)
    _assert_close(got, want, TOL[dtype])
    _assert_close(gc.k, wc.k, TOL[dtype])
    _assert_close(gc.v, wc.v, TOL[dtype])
    with pytest.raises(IndexError, match="outside"):
        attn.gqa_chunk_append(model.layers[0].mixer, cfg, xt, ct, 32)


def test_model_prefill_chunk_and_packed_decode_match_reference():
    """Two chunks into a two-row cache, then three packed decode steps
    with the rows at different depths (row 1 parked on the last one):
    logits and every cache row within 1e-4 in f32."""
    rcfg, params, cfg, model = _pair()
    rng = np.random.default_rng(5)
    s_max = 49
    cj = RM.init_caches(rcfg, 2, s_max, jnp.float32)
    ct = M.init_caches(cfg, 2, s_max, torch.float32, device="cpu")
    toks = rng.integers(1, cfg.vocab_size, (2, 32))
    for start in (0, 16):
        chunk = toks[:, start:start + 16]
        lj, cj = RM.prefill_chunk(params, rcfg, jnp.asarray(chunk, jnp.int32),
                                  cj, start)
        with torch.inference_mode():
            lt, ct = model.prefill_chunk(torch.from_numpy(chunk), ct, start)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        _assert_close(lt, lj, F32_TOL)
    for idx in ([32, 20], [33, 21], [34, s_max - 1]):
        tok = rng.integers(1, cfg.vocab_size, (2, 1))
        idx = np.asarray(idx, np.int32)
        lj, cj = RM.decode_step_packed(params, rcfg,
                                       jnp.asarray(tok, jnp.int32), cj,
                                       jnp.asarray(idx))
        with torch.inference_mode():
            lt, ct = model.decode_step_packed(torch.from_numpy(tok), ct,
                                              torch.from_numpy(idx))
        assert lt.shape == lj.shape == (2, 1, cfg.padded_vocab)
        _assert_close(lt, lj, F32_TOL)
    for name in ("k", "v"):
        _assert_close(getattr(ct[0], name), getattr(cj[0], name), F32_TOL)


def test_prefill_chunk_refuses_a_recurrent_stack():
    _, _, cfg, model = _pair()
    model.cfg = dataclasses.replace(cfg, layer_pattern=("ssm",))
    with pytest.raises(ValueError, match="pure-attention"):
        model.prefill_chunk(torch.zeros((1, 16), dtype=torch.int64), [], 0)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_make_trace_matches_reference(seed):
    kw = dict(num_requests=12, num_users=4, prefix_blocks=2,
              block_tokens=16, suffix_tokens=(4, 40), max_new_tokens=6,
              vocab_size=509, seed=seed)
    a, b = ref_make_trace(**kw), make_trace(**kw)
    assert [dataclasses.astuple(t) for t in a] == [dataclasses.astuple(t)
                                                   for t in b]
    assert all(0 not in t.prompt for t in b)
    assert len({t.user for t in b}) > 1


# ---------------------------------------------------------------------------
# the paged prefix-cache API
# ---------------------------------------------------------------------------
def _paged_script(c):
    """The paged API's cases in one sequence; returns what it observed."""
    seen = []
    toks = list(range(1, 11))                           # 2 whole blocks + 2
    k0 = c.insert_block(toks, 0, "seg0")
    k1 = c.insert_block(toks, 1, "seg1")
    seen += [k0, k1, c.insert_block(toks, 0, "dup")]    # resident: None
    seen.append(c.lookup(toks))
    n, values, pinned = c.acquire_blocks(toks)
    seen += [n, values, pinned, c._count(pinned).tolist()]
    c.release(pinned)
    c.release([k0, k1])
    seen.append(c._count(pinned).tolist())
    seen.append(c.lookup(toks[:4] + [99, 98, 97, 96]))  # 1st block only
    seen += list(c.acquire_blocks([5, 6, 7]))           # no whole block
    for i in range(6):                                  # pool of 4: evicts
        t = [10 * i + j for j in range(20, 24)]
        k = c.insert_block(t, 0, f"s{i}")
        if i % 2:
            c.release([k])                              # odd ones unpinned
    seen.append(sorted(c.store))
    seen.append(c._count(sorted(c.store)).tolist())
    seen.append(c.lookup([20, 21, 22, 23]))             # evicted or not
    return seen


@pytest.mark.parametrize("backend", ["sim", "device"])
def test_paged_prefix_cache_matches_reference(backend):
    kw = dict(block_tokens=4, capacity_blocks=4, backend=backend)
    if backend == "device":
        kw.update(GEOM)
    ref, port = RefPrefixKVCache(**kw), PrefixKVCache(device="cpu", **kw)
    a, b = _paged_script(ref), _paged_script(port)
    assert a == b
    assert a[2] is None and a[3] == 8
    assert a[4:8] == [8, ["seg0", "seg1"], [a[0], a[1]], [2, 2]]
    assert a[8] == [0, 0] and a[9] == 4
    assert a[10:13] == [0, [], []]
    assert ref.stats() == port.stats()
    s = port.stats()
    assert (s["hits"], s["misses"]) == (1, 1)
    assert s["evictions"] > 0 and s["dropped"] == 0
    port.close()


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
def _prompts(vocab, shared_tokens=16, suffixes=(5, 9, 0, 16), seed=2):
    """The reference scheduler test's prompts: a shared 16-token block, one
    prompt exactly that block (a full-prompt hit)."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, vocab, size=shared_tokens)]
    return [shared + [int(t) for t in rng.integers(1, vocab, size=n)]
            for n in suffixes]


def _ref_cache(backend, **kw):
    kw = dict(dict(block_tokens=16, capacity_blocks=32), **kw)
    return RefPrefixKVCache(backend=backend, **(GEOM if backend == "device"
                                                else {}), **kw)


def _port_cache(backend, **kw):
    kw = dict(dict(block_tokens=16, capacity_blocks=32), **kw)
    return PrefixKVCache(backend=backend, device="cpu",
                         **(GEOM if backend == "device" else {}), **kw)


def _serial(cfg, model, prompts, max_new):
    return [r.output for r in ServeEngine(cfg, model).serve(
        [Request(prompt=list(p), max_new_tokens=max_new) for p in prompts])]


def _by_id(done):
    done = sorted(done, key=lambda r: r.request_id)
    return [r.output for r in done], [r.cached_tokens for r in done]


@pytest.mark.parametrize("flush_threshold", [None, 1])
@pytest.mark.parametrize("backend", ["sim", "device"])
@pytest.mark.parametrize("max_slots", [2, 3])
def test_scheduler_matches_reference(max_slots, backend, flush_threshold):
    """The reference scheduler's prompts through both schedulers: the same
    outputs, cached prefixes, chunk calls, decode steps and cache stats
    (with every pin drained into the table, the stats that count drains
    aside), and the port's serial engine's outputs."""
    rcfg, params, cfg, model = _pair()
    prompts = _prompts(cfg.vocab_size)
    rc = _ref_cache(backend)
    pc = _port_cache(backend, flush_threshold=flush_threshold)
    ref = RefScheduler(rcfg, params, prefix_cache=rc, max_slots=max_slots,
                       max_context=64)
    port = ContinuousBatchingScheduler(cfg, model, prefix_cache=pc,
                                       max_slots=max_slots, max_context=64)
    a = ref.run([RefSchedRequest(prompt=list(p), max_new_tokens=5,
                                 request_id=i)
                 for i, p in enumerate(prompts)])
    b = port.run([SchedRequest(prompt=list(p), max_new_tokens=5,
                               request_id=i) for i, p in enumerate(prompts)])
    assert _by_id(a) == _by_id(b)
    outputs, cached = _by_id(b)
    assert outputs == _serial(cfg, model, prompts, 5)
    # the full-prompt hit (#2) rides block 0 only if admitted after #0's
    # first chunk: with three slots it is admitted beside #0
    assert cached == {2: [0, 0, 16, 16], 3: [0, 0, 0, 16]}[max_slots]
    assert ((ref.chunk_calls, ref.decode_steps)
            == (port.chunk_calls, port.decode_steps))
    assert port.chunk_calls > 0 and port.decode_steps > 0
    rs, ps = rc.stats(), pc.stats()
    if flush_threshold is not None:
        rs = {k: v for k, v in rs.items() if k not in FLUSH_STATS}
        ps = {k: v for k, v in ps.items() if k not in FLUSH_STATS}
        if backend == "device":
            assert pc.stats()["write_dispatches"] > 0
    assert rs == ps
    pc._refs.flush()
    assert pc._count(list(pc.store)).tolist() == [0] * len(pc.store)
    pc.close()


def test_pooled_blocks_survive_the_reuse_of_their_slot():
    """One slot, three requests: the first inserts two blocks, the other
    two (one sharing the first block) prefill and decode into the same
    slot rows. The pooled segments stay bit-equal, and serving the first
    prompt again from them reproduces its output."""
    _, _, cfg, model = _pair()
    rng = np.random.default_rng(6)
    p0 = rng.integers(1, cfg.vocab_size, 40).tolist()
    p1 = p0[:16] + rng.integers(1, cfg.vocab_size, 30).tolist()
    p2 = rng.integers(1, cfg.vocab_size, 40).tolist()
    cache = _port_cache("sim")
    sched = ContinuousBatchingScheduler(cfg, model, prefix_cache=cache,
                                        max_slots=1, max_context=64)
    first = sched.run([SchedRequest(prompt=p0, max_new_tokens=6)])[0]
    stored = {k: [x.clone() for c in cache._value(k) for x in c]
              for k in cache.store}
    assert len(stored) == 2
    sched.run([SchedRequest(prompt=p, max_new_tokens=6) for p in (p1, p2)])
    for k, before in stored.items():
        after = [x for c in cache._value(k) for x in c]
        assert all(torch.equal(x, y) for x, y in zip(before, after))
    again = sched.run([SchedRequest(prompt=p0, max_new_tokens=6)])[-1]
    assert again.cached_tokens == 32 and again.output == first.output


def test_pins_released_and_oversized_requests_refused():
    _, _, cfg, model = _pair()
    cache = _port_cache("device")
    sched = ContinuousBatchingScheduler(cfg, model, prefix_cache=cache,
                                        max_slots=2, max_context=64)
    sched.run([SchedRequest(prompt=list(p), max_new_tokens=3, request_id=i)
               for i, p in enumerate(_prompts(cfg.vocab_size))])
    keys = list(cache.store)
    assert keys, "prefill should have inserted blocks"
    assert cache._count(keys).tolist() == [0] * len(keys)
    assert sched._free_slots and all(r is None for r in sched._active)
    with pytest.raises(ValueError, match="max_context"):
        sched.submit(SchedRequest(prompt=[1] * 60, max_new_tokens=8))
    # fits max_context, but its last chunk pads past the cache's rows
    tight = ContinuousBatchingScheduler(cfg, model, max_slots=1,
                                        max_context=40)
    with pytest.raises(ValueError, match="pads to 48 rows"):
        tight.submit(SchedRequest(prompt=[1] * 33, max_new_tokens=7))
    cache.close()


def _hold_crank_until_submitted(sched, n):
    """Make ``sched.step`` wait until ``n`` requests were submitted, so the
    first tick admits a full slot table whatever the feeders' interleaving
    (which prefixes are cached then depends on the trace alone)."""
    submitted, ready = [], threading.Event()
    submit, step = sched.submit, sched.step

    def counted(req):
        out = submit(req)
        submitted.append(req)
        if len(submitted) >= n:
            ready.set()
        return out

    def held():
        if not ready.wait(timeout=60):
            raise TimeoutError("the feeders never submitted the trace")
        return step()
    sched.submit, sched.step = counted, held


def test_replay_trace_matches_serial_and_reference():
    """Two feeder threads, one user (every request shares its prefix
    block): every output equals the serial engine's; the report's request
    count, generated tokens and hit rate equal the reference replay's."""
    rcfg, params, cfg, model = _pair()
    kw = dict(num_requests=6, num_users=1, prefix_blocks=1, block_tokens=16,
              max_new_tokens=3, vocab_size=cfg.vocab_size, seed=5)
    trace = make_trace(**kw)
    port = ContinuousBatchingScheduler(
        cfg, model, prefix_cache=_port_cache("sim", capacity_blocks=64),
        max_slots=3, max_context=64)
    ref = RefScheduler(rcfg, params,
                       prefix_cache=_ref_cache("sim", capacity_blocks=64),
                       max_slots=3, max_context=64)
    for sched in (port, ref):
        _hold_crank_until_submitted(sched, len(trace))
    rep = replay_trace(port, trace, workers=2)
    want = ref_replay_trace(ref, ref_make_trace(**kw), workers=2)
    outputs, cached = _by_id(port.completed)
    assert outputs == _serial(cfg, model, [t.prompt for t in trace], 3)
    assert sorted(cached) == [0, 0, 0, 16, 16, 16]
    assert ((rep.requests, rep.generated_tokens, rep.hit_rate)
            == (want.requests, want.generated_tokens, want.hit_rate))
    assert rep.requests == 6 and rep.generated_tokens == 18
    assert rep.p99_latency_s >= rep.p50_latency_s > 0
    assert "fig7dev" in rep.summary()
