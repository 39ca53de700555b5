"""The port's serving path against the reference, on the CPU.

``BlockPool`` cases run on both packages' pools. ``PrefixKVCache`` runs on
the device backend on both sides (the reference's Pallas kernels in
interpret mode, the port's plain versions) and must give identical
refcounts and ``stats()``. ``ServeEngine`` on llama32 ``TINY`` in f32 must
give identical greedy outputs, ``cached_tokens`` and cache stats,
including the exact full-prompt hit served three times in a row, which
must leave the pool's stored caches untouched."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro.serving import BlockPool as RefBlockPool
from repro.serving import PrefixKVCache as RefPrefixKVCache
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import Model
from repro_torch.serving import BlockPool, PrefixKVCache, Request, ServeEngine

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
GEOM = dict(q_log2=10, r_log2=6)


def _caches(**kw):
    kw = {**GEOM, **kw}
    return RefPrefixKVCache(backend="device", **kw), PrefixKVCache(
        device="cpu", **kw)


# ---------------------------------------------------------------------------
# block pool (the reference's cases, on both pools)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Pool", [RefBlockPool, BlockPool])
class TestBlockPool:
    def test_alloc_free_roundtrip(self, Pool):
        pool = Pool(4)
        bids = [pool.alloc(f"v{i}") for i in range(4)]
        assert sorted(bids) == [0, 1, 2, 3]
        assert pool.alloc("overflow") is None
        assert [pool.get(b) for b in bids] == ["v0", "v1", "v2", "v3"]
        pool.free(bids[1])
        assert pool.num_free == 1 and pool.in_use == 3
        assert pool.alloc("again") == bids[1]          # LIFO reuse
        assert pool.high_water == 4

    def test_double_free_rejected(self, Pool):
        pool = Pool(2)
        b = pool.alloc("x")
        pool.free(b)
        with pytest.raises(ValueError, match="double free"):
            pool.free(b)

    def test_stats_and_validation(self, Pool):
        with pytest.raises(ValueError):
            Pool(0)
        pool = Pool(3)
        pool.alloc("a")
        s = pool.stats()
        assert s["pool_capacity"] == 3 and s["pool_in_use"] == 1
        assert s["pool_allocs"] == 1 and s["pool_high_water"] == 1


# ---------------------------------------------------------------------------
# prefix cache: one script of operations, both packages, same observations
# ---------------------------------------------------------------------------
def _script(c):
    """The engine path's cache cases in one sequence; returns what it
    observed (keys, counts, values, residency)."""
    seen = []
    toks = list(range(1, 11))                           # 2 whole blocks + 2
    slicer = lambda v, n: f"{v}[:{n}]"                  # noqa: E731
    pinned = c.insert(toks, "p", slicer=slicer)
    seen += [pinned, c.insert(toks, "dup", slicer=slicer)]  # resident: []
    n, value, held = c.acquire(toks)
    seen += [n, value, held, c._count(held).tolist()]
    c.release(held)
    c.release(pinned)
    seen.append(c._count(pinned).tolist())
    n, value, held = c.acquire(toks[:4] + [99, 98, 97, 96])  # 1st block only
    seen += [n, value, held, c._count(held).tolist()]
    c.release(held)
    seen += list(c.acquire([1, 2, 3]))                  # no whole block
    for i in range(6):                                  # pool of 4: evicts
        t = [10 * i + j for j in range(20, 24)]
        k = c.insert(t, f"s{i}")                        # full prefix only
        if i % 2:
            c.release(k)                                # odd ones unpinned
    seen.append(sorted(c.store))
    seen.append(c._count(sorted(c.store)).tolist())
    return seen


def test_prefix_cache_refcounts_and_stats_match_reference():
    ref, port = _caches(block_tokens=4, capacity_blocks=4)
    a, b = _script(ref), _script(port)
    assert a == b
    assert len(a[0]) == 2 and a[1] == []
    assert a[2:6] == [8, "p[:8]", a[0], [2, 2]]
    assert a[6] == [0, 0]
    assert a[7:11] == [4, "p[:4]", a[0][:1], [1]]
    assert a[11:14] == [0, None, []]
    assert ref.stats() == port.stats()
    assert port.stats()["evictions"] > 0 and port.stats()["dropped"] == 0


def test_refcounts_that_reach_the_device_table_match_reference():
    """More pins than the flush threshold (2 x capacity) drain H_R into
    the table, so counts come back through the flash-hash kernels' plain
    versions; both packages agree on every count and the wear."""
    ref, port = _caches(block_tokens=2, capacity_blocks=4)
    for c in (ref, port):
        for i in range(12):
            toks = [3 * i + 1, 3 * i + 2]
            c.insert(toks, f"v{i}", slicer=lambda v, n: v)
            c.acquire(toks)                             # a second pin
        c._refs.flush()
    keys = sorted(set(ref.store) | set(port.store))
    assert ref._count(keys).tolist() == port._count(keys).tolist()
    rs, ps = ref.stats(), port.stats()
    timing = ("query_cache_hits", "query_device_keys", "query_batches")
    assert ({k: v for k, v in rs.items() if k not in timing}
            == {k: v for k, v in ps.items() if k not in timing})
    assert ps["tile_stores"] > 0 and ps["write_dispatches"] > 0


def test_prefix_cache_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PrefixKVCache(backend="sim", device="cpu")
    with pytest.raises(ValueError, match="eviction"):
        PrefixKVCache(eviction="lru", device="cpu")
    c = PrefixKVCache(device="cpu", **GEOM)
    for fn in (c.snapshot, c.restore):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn("somewhere")
    c.close()


# ---------------------------------------------------------------------------
# the serial engine
# ---------------------------------------------------------------------------
def _models():
    rcfg = dataclasses.replace(ref_config("llama32_3b", tiny=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("llama32_3b", tiny=True),
                              dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _serve_both(prompts, max_new, **cache_kw):
    rcfg, params, cfg, model = _models()
    rc, pc = _caches(**cache_kw)
    ref = RefServeEngine(rcfg, params, prefix_cache=rc)
    port = ServeEngine(cfg, model, prefix_cache=pc)
    a = [ref.generate(RefRequest(prompt=list(p), max_new_tokens=max_new))
         for p in prompts]
    b = [port.generate(Request(prompt=list(p), max_new_tokens=max_new))
         for p in prompts]
    return a, b, rc, pc


def _smoke_prompts():
    """The smoke's request order, scaled down: a 40-token prompt fills a
    5-block pool, three requests share its first 16 tokens (hits), four
    fresh prompts evict."""
    rng = np.random.default_rng(0)
    p0 = rng.integers(0, 509, 40).tolist()
    return ([p0] + [p0[:16] + rng.integers(0, 509, 24).tolist()
                    for _ in range(3)]
            + [rng.integers(0, 509, 40).tolist() for _ in range(4)])


def test_engine_matches_reference_with_prefix_hits_and_evictions():
    prompts = _smoke_prompts()
    a, b, rc, pc = _serve_both(prompts, 6, block_tokens=8,
                               capacity_blocks=5)
    assert [r.output for r in a] == [r.output for r in b]
    assert [r.cached_tokens for r in b] == [0, 16, 16, 16, 0, 0, 0, 0]
    assert rc.stats() == pc.stats()
    s = pc.stats()
    assert (s["hits"], s["misses"]) == (3, 5) and s["evictions"] > 0
    assert pc._count(list(pc.store)).tolist() == [0] * len(pc.store)


def _read_pins_on_release(cache) -> list:
    """Make ``cache.release`` record the refcounts it is about to drop;
    returns the list they go into."""
    held, release = [], cache.release

    def read_then_release(pinned):
        held.append(cache._count(pinned).tolist())
        release(pinned)
    cache.release = read_then_release
    return held


def test_engine_with_every_pin_drained_to_the_table_matches_reference():
    """``flush_threshold=1`` drains every pin and unpin into the device
    table (the serial engine's pins otherwise cancel in H_R), so the
    counts are merged and read back through the flash-hash kernels' plain
    versions. Each request's pins, read before release, and everything
    the engine returns match the reference's default cache."""
    rcfg, params, cfg, model = _models()
    rc = RefPrefixKVCache(backend="device", block_tokens=8,
                          capacity_blocks=5, **GEOM)
    pc = PrefixKVCache(device="cpu", block_tokens=8, capacity_blocks=5,
                       flush_threshold=1, **GEOM)
    held = {"ref": _read_pins_on_release(rc),
            "port": _read_pins_on_release(pc)}
    prompts = _smoke_prompts()
    a = [RefServeEngine(rcfg, params, prefix_cache=rc).generate(
        RefRequest(prompt=list(p), max_new_tokens=4)) for p in prompts]
    port = ServeEngine(cfg, model, prefix_cache=pc)
    b = [port.generate(Request(prompt=list(p), max_new_tokens=4))
         for p in prompts]
    assert [r.output for r in a] == [r.output for r in b]
    assert ([r.cached_tokens for r in a] == [r.cached_tokens for r in b]
            == [0, 16, 16, 16, 0, 0, 0, 0])
    assert held["ref"] == held["port"]
    assert [len(h) for h in held["port"]] == [5, 2, 2, 2, 5, 5, 5, 5]
    assert all(c == 1 for h in held["port"] for c in h)
    pc._refs.flush()
    assert pc._count(list(pc.store)).tolist() == [0] * len(pc.store)
    rs, ps = rc.stats(), pc.stats()
    same = ("hits", "misses", "evictions", "resident", "dropped",
            "pool_allocs", "pool_frees", "pool_in_use")
    assert {k: rs[k] for k in same} == {k: ps[k] for k in same}
    assert ps["write_dispatches"] > 0 and ps["query_device_keys"] > 0
    assert ps["tile_stores"] > 0 and rs["write_dispatches"] == 0


def test_exact_full_prompt_hit_three_times_leaves_the_pool_untouched():
    """A block-multiple prompt served three times: the 2nd and 3rd hit
    every block (decode re-enters at the last position). Decode writes
    its caches in place, so the pool's values must come out bit-equal."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 509, 32).tolist()
    rcfg, params, cfg, model = _models()
    rc, pc = _caches(block_tokens=8, capacity_blocks=16)
    ref = RefServeEngine(rcfg, params, prefix_cache=rc)
    port = ServeEngine(cfg, model, prefix_cache=pc)
    a = [ref.generate(RefRequest(prompt=list(prompt), max_new_tokens=4))]
    b = [port.generate(Request(prompt=list(prompt), max_new_tokens=4))]
    stored = {k: [x.clone() for c in pc._value(k) for x in c]
              for k in pc.store}
    for _ in range(2):
        a.append(ref.generate(RefRequest(prompt=list(prompt),
                                         max_new_tokens=4)))
        b.append(port.generate(Request(prompt=list(prompt),
                                       max_new_tokens=4)))
    assert [r.output for r in a] == [r.output for r in b]
    assert b[0].output == b[1].output == b[2].output
    assert [r.cached_tokens for r in b] == [0, 32, 32]
    for k, before in stored.items():
        after = [x for c in pc._value(k) for x in c]
        assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert rc.stats() == pc.stats()


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--tiny",
         "--device", "cpu", "--requests", "3", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "[serve:serial] 3 requests, 12 tokens" in out.stdout
    assert "cached=16" in out.stdout and "[prefix-cache]" in out.stdout


@pytest.mark.parametrize("flags", [["--continuous"], ["--backend", "sim"]])
def test_serve_cli_refuses_what_is_not_ported(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--tiny", "--device", "cpu", *flags])
    assert exc.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err
