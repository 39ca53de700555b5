"""The port's table (``table_torch``) against the reference's
(``table_jax``) under MB / MDB / MDB-L: the same op sequence on both, the
full state and every ``TableStats`` counter compared bit for bit after
every op (through ``convert.state_to_numpy``), and the lookups, filter
verdicts and load factor compared exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segments as jseg
from repro.core import table_jax as tj
from repro_torch import convert
from repro_torch.core import segments as tseg
from repro_torch.core import table_torch as tt

torch.set_num_threads(1)
SCHEMES = ["MB", "MDB", "MDB-L"]
EMPTY = -1


def _cfgs(scheme, **kw):
    base = dict(q_log2=10, r_log2=6, scheme=scheme, log_capacity=256,
                cs_partitions=4, max_updates_per_block=16,
                overflow_capacity=256)
    base.update(kw)
    return tj.FlashTableConfig(**base), tt.FlashTableConfig(**base)


def _same_state(js, ts, where):
    want = jax.tree.map(np.asarray, js)
    got = convert.state_to_numpy(ts)
    for f in tt.DeviceTableState._fields:
        if f == "stats":
            continue
        w = getattr(want, f)
        assert (got[f].dtype, got[f].shape) == (w.dtype, w.shape), (where, f)
        np.testing.assert_array_equal(got[f], w, err_msg=f"{where}: {f}")
    for f in tt.TableStats._fields:
        g, w = got["stats"][f], getattr(want.stats, f)
        assert g.shape == w.shape == () and int(g) == int(w), (where, f)


def _hot_keys(pair, block, n):
    """``n`` distinct keys of one block (``pair``: the port's hash pair)."""
    x = torch.arange(1 << 16, dtype=torch.int32)
    return x[pair.s(x) == block][:n].numpy().astype(np.int64)


B = 128  # one batch shape: the reference compiles one program per shape


def _pad(a, fill):
    return np.concatenate([a, np.full(B - len(a), fill, np.int64)])


def _ops(cfg):
    """The op sequence: (name, tokens, deltas) per update, then flush."""
    rng = np.random.default_rng(len(cfg.scheme))
    hot = _hot_keys(cfg.pair, 3, 60)
    return [
        ("update", rng.integers(0, 600, B), None),
        ("update+deltas", rng.integers(0, 600, B), rng.integers(-2, 4, B)),
        ("hot block", _pad(hot[:40], EMPTY), None),
        ("hot block+deltas", _pad(hot[20:60], EMPTY), _pad(np.full(40, 2), 0)),
        ("update", rng.integers(0, 5000, B), None),
        ("update", rng.integers(0, 5000, B), None),
    ]


def _run_both(jcfg, tcfg, js, ts, with_deltas=True):
    for name, toks, dels in _ops(tcfg):
        if dels is not None and not with_deltas:
            continue
        jt = jnp.asarray(toks, jnp.int32)
        tt_ = torch.as_tensor(toks.astype(np.int32))
        if dels is None:
            js = tj.update(jcfg, js, jt)
            ts = tt.update(tcfg, ts, tt_)
        else:
            js = tj.update(jcfg, js, jt, deltas=jnp.asarray(dels, jnp.int32))
            ts = tt.update(tcfg, ts, tt_,
                           deltas=torch.as_tensor(dels.astype(np.int32)))
        _same_state(js, ts, name)
    q = np.concatenate([np.arange(0, 600, 3), _hot_keys(tcfg.pair, 3, 60),
                        [EMPTY, EMPTY], np.arange(7000, 7050)])
    q = q.astype(np.int32)
    for stage in ("staged", "flushed"):
        if stage == "flushed":
            js = tj.flush(jcfg, js)
            ts = tt.flush(tcfg, ts)
            _same_state(js, ts, "flush")
        want = tj.lookup_ex(jcfg, js, jnp.asarray(q))
        got = tt.lookup_ex(tcfg, ts, torch.as_tensor(q))
        for name, w, g in zip(("counts", "dists", "tiles"), want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{stage}: {name}")
        np.testing.assert_array_equal(
            tt.filter_probe(tcfg, ts, torch.as_tensor(q)).numpy(),
            np.asarray(tj.filter_probe(jcfg, js, jnp.asarray(q))))
        assert float(tt.load_factor(tcfg, ts)) == float(
            tj.load_factor(jcfg, js))
    rebuilt = tseg.rebuild_filters(tcfg.pair, ts).filter_words
    np.testing.assert_array_equal(
        rebuilt.numpy().view(np.uint32),
        np.asarray(jseg.rebuild_filters(jcfg.pair, js).filter_words))
    return js, ts


@pytest.mark.parametrize("scheme", SCHEMES)
def test_op_sequence_matches_reference(scheme):
    jcfg, tcfg = _cfgs(scheme)
    js, ts = _run_both(jcfg, tcfg, tj.init(jcfg), tt.init(tcfg, "cpu"))
    st = ts.stats
    assert int(st.carried) > 0           # the hot block exercised carry
    assert int(st.merges) > 0
    if scheme != "MB":
        assert int(st.staged_entries) > 0


def test_mdb_partition_full_path_matches_reference():
    """Small partitions: staging overflows a partition, which drains
    first and retries (the drain-until-fits loop)."""
    jcfg, tcfg = _cfgs("MDB", log_capacity=64, max_updates_per_block=4)
    js, ts = _run_both(jcfg, tcfg, tj.init(jcfg), tt.init(tcfg, "cpu"),
                       with_deltas=False)
    assert int(ts.stats.merges) >= 3


@pytest.mark.parametrize("scheme", SCHEMES)
def test_port_continues_from_reference_state(scheme):
    """A state built by the reference, carried across with
    ``state_from_numpy``, then driven by both packages in lockstep."""
    jcfg, tcfg = _cfgs(scheme)
    rng = np.random.default_rng(9)
    js = tj.init(jcfg)
    for _ in range(3):
        js = tj.update(jcfg, js, jnp.asarray(rng.integers(0, 900, B),
                                              jnp.int32))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    _same_state(js, ts, "carried across")
    back = convert.state_from_numpy(convert.state_to_numpy(ts), "cpu")
    _same_state(js, back, "round trip")
    _run_both(jcfg, tcfg, js, ts)


def test_consumed_state_is_refused():
    _, tcfg = _cfgs("MDB-L")
    s0 = tt.init(tcfg, "cpu")
    s1 = tt.update(tcfg, s0, torch.arange(10, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="donated"):
        tt.update(tcfg, s0, torch.arange(10, dtype=torch.int32))
    tt.assert_live(s1)
    cnt, _ = tt.lookup(tcfg, s1, torch.arange(12, dtype=torch.int32))
    assert cnt.tolist() == [1] * 10 + [0, 0]


def test_config_fields_match_reference_minus_interpret():
    want = {f.name for f in dataclasses.fields(tj.FlashTableConfig)}
    got = {f.name for f in dataclasses.fields(tt.FlashTableConfig)}
    assert got == want - {"interpret"}
    with pytest.raises(ValueError):
        tt.FlashTableConfig(scheme="MDB-X")
    with pytest.raises(ValueError):
        tt.FlashTableConfig(scheme="MDB", cs_partitions=7)
