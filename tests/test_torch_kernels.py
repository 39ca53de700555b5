"""The port's plain kernel versions and ops glue against the Pallas
kernels (interpret mode) and ops of the reference, exactly.

Inputs are made with numpy from a seed and fed to both packages; integer
results must match bit for bit (tolerance 0). ``query_grid``/``query``
are compared on the gathered lanes only: other lanes are junk by
contract."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.hashing import Pow2Hash as JPair
from repro.core.hashing import filter_words_for
from repro.kernels.flash_hash import ops as jops
from repro_torch.core.hashing import Pow2Hash as TPair
from repro_torch.kernels.flash_hash import kernel as tk
from repro_torch.kernels.flash_hash import ops as tops
from repro_torch.kernels.flash_hash import ref as tref

torch.set_num_threads(1)
EMPTY = -1


def _np(x):
    return np.asarray(x)


def _t(a):
    """numpy -> CPU tensor (uint32 filter words as int32, same bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a.copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _pairs(q_log2, r_log2):
    return JPair(q_log2=q_log2, r_log2=r_log2), TPair(q_log2=q_log2,
                                                      r_log2=r_log2)


def _block_keys(pair, rng, n_keys, key_space):
    keys = rng.integers(0, key_space, size=n_keys).astype(np.int32)
    return keys, np.asarray(pair.s(keys)).astype(np.int64)


def _table(jp, rng, fill_keys):
    """A table merged once through the reference (realistic layout)."""
    n_b, r = jp.num_slots, jp.r
    fw = filter_words_for(r)
    keys, cnts = jops.accumulate(jnp.asarray(fill_keys, jnp.int32))
    uk, uc, _, _, _ = jops.bucket_updates(jp, keys, cnts, 4 * r)
    tk0 = jnp.full((n_b, r), EMPTY, jnp.int32)
    tc0 = jnp.zeros((n_b, r), jnp.int32)
    tf0 = jnp.zeros((n_b, fw), jnp.uint32)
    nk, nc, nf, _, _ = jops.merge(jp, tk0, tc0, tf0, uk, uc)
    return _np(nk), _np(nc), _np(nf)


MERGE_SHAPES = [(8, 5, 16), (10, 7, 64), (12, 8, 512), (13, 10, 256),
                (11, 11, 128)]


@pytest.mark.parametrize("q_log2,r_log2,max_u", MERGE_SHAPES)
def test_merge_plain_matches_pallas(q_log2, r_log2, max_u):
    jp, tp = _pairs(q_log2, r_log2)
    n_b, r = jp.num_slots, jp.r
    rng = np.random.default_rng(q_log2)
    tk0, tc0, tf0 = _table(jp, rng, rng.integers(0, 1 << 20, jp.q // 4))
    toks = rng.integers(0, 1 << 20, size=jp.q // 2)
    keys, cnts = jops.accumulate(jnp.asarray(toks, jnp.int32))
    uk, uc, _, _, _ = jops.bucket_updates(jp, keys, cnts, max_u)
    want = jops.merge(jp, jnp.asarray(tk0), jnp.asarray(tc0),
                      jnp.asarray(tf0), uk, uc)
    got = tk.merge(tp, _t(tk0), _t(tc0), _t(tf0), _t(_np(uk)), _t(_np(uc)))
    for name, w, g in zip(("keys", "counts", "filter", "spill_k", "spill_c"),
                          want, got):
        g = _u32(g) if name == "filter" else g.numpy()
        np.testing.assert_array_equal(g, _np(w), err_msg=name)


@pytest.mark.parametrize("q_log2,r_log2,max_u", [(10, 6, 64), (9, 4, 32)])
def test_merge_dirty_plain_matches_pallas(q_log2, r_log2, max_u):
    """A partial, shuffled dirty list with hot blocks that spill, on a
    table that already holds keys."""
    jp, tp = _pairs(q_log2, r_log2)
    n_b, r = jp.num_slots, jp.r
    rng = np.random.default_rng(100 + q_log2)
    tk0, tc0, tf0 = _table(jp, rng, rng.integers(0, 1 << 20, jp.q // 3))
    dirty = rng.permutation(n_b)[: n_b // 2].astype(np.int32)
    keys, blk = _block_keys(jp, rng, 4 * max_u * n_b, 1 << 24)
    uk = np.full((len(dirty), max_u), EMPTY, np.int32)
    uc = np.zeros_like(uk)
    for i, b in enumerate(dirty):
        mine = np.unique(keys[blk == b])
        hot = i < 2                       # overfull rows: spill
        mine = mine[: max_u if hot else max_u // 4]
        uk[i, : len(mine)] = mine
        uc[i, : len(mine)] = rng.integers(-3, 9, len(mine))
    want = jops.merge_dirty(jp, jnp.asarray(tk0), jnp.asarray(tc0),
                            jnp.asarray(tf0), jnp.asarray(dirty),
                            jnp.asarray(uk), jnp.asarray(uc))
    got = tk.merge_dirty(tp, _t(tk0), _t(tc0), _t(tf0), _t(dirty), _t(uk),
                         _t(uc))
    assert int((_np(want[3]) != EMPTY).sum()) > 0, "no spill exercised"
    for name, w, g in zip(("keys", "counts", "filter", "spill_k", "spill_c"),
                          want, got):
        g = _u32(g) if name == "filter" else g.numpy()
        np.testing.assert_array_equal(g, _np(w), err_msg=name)


def test_merge_dirty_padding_id_is_a_no_op():
    """A repeated id on a row without valid updates writes nothing, so the
    merged tile survives. (The reference's interpret mode re-reads the
    stale input tile on the repeat and loses the merge; the documented
    contract, which the port keeps, is a no-op.)"""
    _, tp = _pairs(9, 4)
    n_b, r = tp.num_slots, tp.r
    keys = torch.arange(100_000, dtype=torch.int32)
    mine = keys[tp.s(keys) == 5][:3]
    uk = torch.full((2, 4), EMPTY, dtype=torch.int32)
    uk[0, :3] = mine
    outs = []
    for ids in ([5, 5], [5, 6]):
        tkeys = torch.full((n_b, r), EMPTY, dtype=torch.int32)
        tf = torch.zeros((n_b, filter_words_for(r)), dtype=torch.int32)
        outs.append(tk.merge_dirty(tp, tkeys, torch.zeros_like(tkeys), tf,
                                   torch.tensor(ids, dtype=torch.int32), uk,
                                   torch.ones_like(uk)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert set(outs[0][0][5].tolist()) == {EMPTY, *mine.tolist()}


def test_merge_dirty_refuses_repeated_id_with_updates():
    _, tp = _pairs(8, 5)
    n_b, r = tp.num_slots, tp.r
    tkeys = torch.full((n_b, r), EMPTY, dtype=torch.int32)
    tcnt = torch.zeros((n_b, r), dtype=torch.int32)
    tf = torch.zeros((n_b, filter_words_for(r)), dtype=torch.int32)
    uk = torch.tensor([[5, EMPTY], [6, EMPTY]], dtype=torch.int32)
    with pytest.raises(ValueError, match="repeated id"):
        tk.merge_dirty(tp, tkeys, tcnt, tf, torch.tensor([3, 3],
                                                         dtype=torch.int32),
                       uk, torch.ones_like(uk))
    with pytest.raises(TypeError):
        tk.merge_dirty(tp, tkeys.long(), tcnt, tf,
                       torch.tensor([3], dtype=torch.int32), uk[:1],
                       torch.ones_like(uk[:1]))


def test_merge_plain_matches_oracles():
    """The plain kernel version agrees with the per-key oracle."""
    _, tp = _pairs(8, 4)
    rng = np.random.default_rng(3)
    n_b, r = tp.num_slots, tp.r
    keys = torch.as_tensor(rng.integers(0, 3000, 600).astype(np.int32))
    k, c = tops.accumulate(keys)
    uk, uc, _, _, _ = tops.bucket_updates(tp, k, c, 32)
    tkeys = torch.full((n_b, r), EMPTY, dtype=torch.int32)
    tcnt = torch.zeros((n_b, r), dtype=torch.int32)
    tf = torch.zeros((n_b, filter_words_for(r)), dtype=torch.int32)
    want = tref.merge_ref(tp, tkeys, tcnt, uk, uc)
    got = tk.merge(tp, tkeys.clone(), tcnt.clone(), tf, uk, uc)
    for w, g in zip(want, (got[0], got[1], got[3], got[4])):
        assert torch.equal(w, g)
    q = torch.as_tensor(rng.integers(0, 4000, 256).astype(np.int32))
    wc, wd = tref.query_ref(tp, got[0], got[1], q)
    gc, gd = tops.query_sorted(tp, got[0], got[1], q)
    assert torch.equal(wc, gc) and torch.equal(wd, gd)


def _grid_layout(pair, keys, qcap):
    """Rows = distinct blocks of ``keys``; lanes = that block's keys."""
    blk = np.asarray(pair.s(keys)).astype(np.int64)
    blocks = np.unique(blk)
    q2 = np.full((len(blocks), qcap), EMPTY, np.int32)
    lanes = np.zeros((len(blocks), qcap), bool)
    for i, b in enumerate(blocks):
        mine = keys[blk == b][:qcap]
        q2[i, : len(mine)] = mine
        lanes[i, : len(mine)] = True
    return blocks.astype(np.int32), q2, lanes


@pytest.mark.parametrize("q_log2,r_log2,qcap", [(9, 6, 16), (12, 8, 128),
                                                (11, 11, 64)])
def test_query_grid_plain_matches_pallas(q_log2, r_log2, qcap):
    from repro.kernels.flash_hash import kernel as jk
    jp, tp = _pairs(q_log2, r_log2)
    rng = np.random.default_rng(200 + q_log2)
    tk0, tc0, _ = _table(jp, rng, rng.integers(0, 4 * jp.q, jp.q // 2))
    keys = rng.integers(0, 4 * jp.q, 3 * qcap).astype(np.int32)
    blocks, q2, lanes = _grid_layout(jp, keys, qcap)
    wc, wd = jk.query_grid(jp, jnp.asarray(tk0), jnp.asarray(tc0),
                           jnp.asarray(blocks), jnp.asarray(q2))
    gc, gd = tk.query_grid(tp, _t(tk0), _t(tc0), _t(blocks), _t(q2))
    np.testing.assert_array_equal(gc.numpy()[lanes], _np(wc)[lanes])
    np.testing.assert_array_equal(gd.numpy()[lanes], _np(wd)[lanes])


def test_query_plain_matches_pallas():
    from repro.kernels.flash_hash import kernel as jk
    jp, tp = _pairs(10, 7)
    rng = np.random.default_rng(7)
    tk0, tc0, _ = _table(jp, rng, rng.integers(0, 5000, 600))
    q = rng.integers(0, 6000, 256).astype(np.int32)
    q = q[np.argsort(np.asarray(jp.s(q)), kind="stable")]
    wc, wd = jk.query(jp, jnp.asarray(tk0), jnp.asarray(tc0),
                      jnp.asarray(q), 32)
    gc, gd = tk.query(tp, _t(tk0), _t(tc0), _t(q), 32)
    blk = np.asarray(jp.s(q)).reshape(-1, 32)
    lanes = (blk == blk[:, :1]).reshape(-1)
    np.testing.assert_array_equal(gc.numpy()[lanes], _np(wc)[lanes])
    np.testing.assert_array_equal(gd.numpy()[lanes], _np(wd)[lanes])


@pytest.mark.parametrize("q_log2,r_log2,qcap", [(9, 6, 16), (12, 10, 128)])
def test_filter_probe_grid_plain_matches_pallas(q_log2, r_log2, qcap):
    from repro.kernels.flash_hash import kernel as jk
    jp, _ = _pairs(q_log2, r_log2)
    rng = np.random.default_rng(300 + q_log2)
    _, _, tf0 = _table(jp, rng, rng.integers(0, 4 * jp.q, jp.q // 2))
    keys = rng.integers(0, 4 * jp.q, 3 * qcap).astype(np.int32)
    blocks, q2, _ = _grid_layout(jp, keys, qcap)
    want = jk.filter_probe_grid(jnp.asarray(tf0), jnp.asarray(blocks),
                                jnp.asarray(q2))
    got = tk.filter_probe_grid(_t(tf0), _t(blocks), _t(q2))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got.sum() > 0 and (got == 0).any()


def test_bucket_rows_and_accumulate_match_reference():
    rng = np.random.default_rng(11)
    toks = rng.integers(-4, 300, 700).astype(np.int32)
    toks[::17] = EMPTY
    for a, b in zip(jops.accumulate(jnp.asarray(toks)),
                    tops.accumulate(_t(toks))):
        np.testing.assert_array_equal(b.numpy(), _np(a))
    rows = rng.integers(-2, 12, 700).astype(np.int32)
    cnts = rng.integers(-5, 5, 700).astype(np.int32)
    want = jops.bucket_rows(jnp.asarray(rows), jnp.asarray(toks),
                            jnp.asarray(cnts), 10, 8)
    got = tops.bucket_rows(_t(rows), _t(toks), _t(cnts), 10, 8)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), _np(a))


@pytest.mark.parametrize("qcap", [1, 3, 16, 128])
@pytest.mark.parametrize("filtered", [False, True])
def test_query_blocked_ex_matches_reference(qcap, filtered):
    jp, tp = _pairs(9, 6)
    rng = np.random.default_rng(12)
    tk0, tc0, tf0 = _table(jp, rng, rng.integers(0, 1000, 300))
    q = np.concatenate([rng.integers(0, 1500, 90), np.full(6, EMPTY),
                        rng.integers(0, 40, 32)]).astype(np.int32)
    want = jops.query_blocked_ex(
        jp, jnp.asarray(tk0), jnp.asarray(tc0), jnp.asarray(q), qcap, True,
        jnp.asarray(tf0) if filtered else None)
    got = tops.query_blocked_ex(tp, _t(tk0), _t(tc0), _t(q), qcap,
                                _t(tf0) if filtered else None)
    for name, a, b in zip(("counts", "dists", "n_tiles"), want, got):
        np.testing.assert_array_equal(b.numpy(), _np(a), err_msg=name)


def test_query_sorted_matches_reference():
    jp, tp = _pairs(10, 7)
    rng = np.random.default_rng(13)
    tk0, tc0, _ = _table(jp, rng, rng.integers(0, 4000, 500))
    q = rng.integers(0, 5000, 128).astype(np.int32)
    want = jops.query_sorted(jp, jnp.asarray(tk0), jnp.asarray(tc0),
                             jnp.asarray(q))
    got = tops.query_sorted(tp, _t(tk0), _t(tc0), _t(q))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), _np(a))


def test_wrappers_refuse_bad_inputs():
    _, tp = _pairs(8, 5)
    n_b, r = tp.num_slots, tp.r
    keys = torch.full((n_b, r), EMPTY, dtype=torch.int32)
    q2 = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="block ids"):
        tk.query_grid(tp, keys, torch.zeros_like(keys),
                      torch.tensor([0, n_b], dtype=torch.int32), q2)
    with pytest.raises(ValueError, match="contiguous"):
        tk.filter_probe_grid(torch.zeros((n_b, 8), dtype=torch.int32),
                             torch.tensor([0, 1], dtype=torch.int32),
                             torch.zeros((4, 2), dtype=torch.int32).t())
