"""The port's plain kernel versions and ops glue against the Pallas
kernels (interpret mode) and ops of the reference, exactly.

Inputs are made with numpy from a seed and fed to both packages; integer
results must match bit for bit (tolerance 0). ``query_grid``/``query``
are compared on the gathered lanes at the layouts of the older tests,
and on every lane at the lookup path's own layout."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.hashing import Pow2Hash as JPair
from repro.core.hashing import filter_words_for
from repro_torch.core.hashing import bloom_positions, filter_bits_log2
from repro.kernels.flash_hash import ops as jops
from repro_torch.core import segments as tseg
from repro_torch.core.hashing import Pow2Hash as TPair
from repro_torch.kernels.flash_hash import check as tcheck
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


#: (q_log2, r_log2, keys a dispatch): more blocks than keys (rows of one
#: or two keys and surplus rows at block 0, as at the main path's size),
#: and fewer
PATH_SHAPES = [(10, 4, 64), (12, 6, 256)]


def _path_case(q_log2, r_log2, n_keys):
    jp, tp = _pairs(q_log2, r_log2)
    rng = np.random.default_rng(400 + q_log2)
    nk, nc, nf = _table(jp, rng, rng.integers(0, 4 * jp.q, jp.q // 2))
    table = (_t(nk), _t(nc), _t(nf))
    # one dispatch chunk of the query engine: the mix, Bloom-filtered
    mix = tcheck.lookup_mix(table[0], q_log2, n_keys)
    chunk = tcheck.padded(mix[tseg.filter_may_contain(tp, table[2], mix)],
                          n_keys)
    return jp, tp, (nk, nc, nf), table, (
        chunk, *tcheck.path_query_layout(tp, table[2], chunk))


@pytest.mark.parametrize("q_log2,r_log2,n_keys", PATH_SHAPES)
def test_path_query_layout_is_what_the_lookup_path_launches(
        q_log2, r_log2, n_keys, monkeypatch):
    """``check.path_query_layout`` gives exactly the ``(blocks, q2)`` that
    ``ops.query_blocked_ex`` hands ``filter_probe_grid`` and
    ``query_grid`` for its dispatch chunk, recorded at the wrappers."""
    _, tp, _, table, (chunk, probed, queried) = _path_case(q_log2, r_log2,
                                                           n_keys)
    seen = {}
    for name in ("query_grid", "filter_probe_grid"):
        def record(*args, _name=name, _fn=getattr(tk, name)):
            seen.setdefault(_name, []).append(args)
            return _fn(*args)
        monkeypatch.setattr(tk, name, record)
    tops.query_blocked_ex(tp, table[0], table[1], chunk, 128, table[2])
    assert [len(seen[n]) for n in ("filter_probe_grid", "query_grid")] == [
        1, 1]
    for got, want in ((seen["filter_probe_grid"][0][1:], probed),
                      (seen["query_grid"][0][3:], queried)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # a full chunk of the smoke's mix: keys the table holds, sorted
    assert chunk.shape == (n_keys,) and bool((chunk != EMPTY).all())
    assert bool((chunk[1:] > chunk[:-1]).all())
    assert bool(torch.isin(chunk, table[0]).all())


@pytest.mark.parametrize("q_log2,r_log2,n_keys", PATH_SHAPES)
def test_lookup_plain_matches_pallas_on_every_lane_of_the_path_layout(
        q_log2, r_log2, n_keys):
    """At the path's layout the Pallas kernels (interpret mode) and the
    plain versions agree on every lane, EMPTY padding and the surplus
    rows at block 0 included: the CUDA kernels are held to the plain
    versions on every lane."""
    from repro.kernels.flash_hash import kernel as jk
    jp, tp, (nk, nc, nf), table, (_, probed, queried) = _path_case(
        q_log2, r_log2, n_keys)
    blocks, q2 = queried
    assert bool((q2 == EMPTY).any())
    wc, wd = jk.query_grid(jp, jnp.asarray(nk), jnp.asarray(nc),
                           jnp.asarray(blocks.numpy()),
                           jnp.asarray(q2.numpy()))
    gc, gd = tref.query_grid_plain(tp, table[0], table[1], blocks, q2)
    np.testing.assert_array_equal(gc.numpy(), _np(wc))
    np.testing.assert_array_equal(gd.numpy(), _np(wd))
    blocks, q2 = probed
    want = jk.filter_probe_grid(jnp.asarray(nf), jnp.asarray(blocks.numpy()),
                                jnp.asarray(q2.numpy()))
    got = tref.filter_probe_grid_plain(table[2], blocks, q2)
    np.testing.assert_array_equal(got.numpy(), _np(want))


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


# ---------------------------------------------------------------------------
# the CUDA merge kernel's phased fold, modelled in Python
# ---------------------------------------------------------------------------
def _wrap32(x):
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _phased_fold(tp, tk0, tc0, tf0, blocks, uk, uc, chunk):
    """The fold of ``merge_dirty_kernel`` step by step, one row at a time,
    in chunks of ``chunk`` updates: a bitmap of the free slots; every
    update classified against the tile as it stands (present in its
    window, home up to the first free slot, or new); whether every tile
    key lies in its window; the first occurrences of new keys placed in
    batches of those among 32 updates: each takes the first free slot from
    its home in the bitmap as it stands (where a tile key lies outside its
    window, unless it meets itself on the way there); the keys before the
    first one that wants a slot an earlier key of the batch wants are
    final; a repeat takes its first occurrence's placement; counts and
    Bloom bits applied; spills compacted in update order. Returns numpy
    arrays like the kernel's outputs."""
    r = tp.r
    keys, counts = tk0.astype(np.int64).copy(), tc0.astype(np.int64).copy()
    filt = tf0.view(np.uint32).astype(np.int64).copy()
    n_d, max_u = uk.shape
    sk = np.full((n_d, max_u), EMPTY, np.int32)
    sc = np.zeros((n_d, max_u), np.int32)
    bits = filter_bits_log2(filt.shape[1])
    home = lambda k: int(tp.home_within_block(k))

    def first_free(h, free):
        return next(((h + d) % r for d in range(r) if (h + d) % r in free),
                    -1)

    for i, b in enumerate(blocks.tolist()):
        kl, cl, fl = keys[b].tolist(), counts[b].tolist(), filt[b].tolist()
        spills = []
        for c0 in range(0, max_u, chunk):
            ks, cs = uk[i, c0:c0 + chunk].tolist(), uc[i, c0:c0 + chunk]
            if all(k == EMPTY for k in ks):
                continue
            free = {s for s in range(r) if kl[s] == EMPTY}
            irregular = any(
                kl[s] != EMPTY and free and (s - home(kl[s])) % r
                > (first_free(home(kl[s]), free) - home(kl[s])) % r
                for s in range(r))
            cls, first = [], {}
            for j, k in enumerate(ks):
                if k == EMPTY:
                    cls.append(None)
                    continue
                h = home(k)
                f0 = first_free(h, free)
                n = r if f0 < 0 else (f0 - h) % r
                d = next((d for d in range(n) if kl[(h + d) % r] == k), -1)
                cls.append(("present", (h + d) % r) if d >= 0 else
                           ("new", f0))
                if d < 0:
                    first.setdefault(k, j)
            place = {}
            for base in range(0, len(ks), 32):
                todo = [j for j in range(base, min(base + 32, len(ks)))
                        if cls[j] is not None and cls[j][0] == "new"
                        and first[ks[j]] == j]
                while todo:     # one batch: the keys before the first clash
                    taken, done = set(), []
                    for j in todo:
                        k, f0 = ks[j], cls[j][1]
                        h = home(k)
                        f = first_free(h, free)
                        if f >= 0 and f in taken:
                            break
                        taken.add(f)
                        pl = ("insert", f) if f >= 0 else ("spill", -1)
                        if irregular and f0 >= 0 and f != f0:
                            hi = r if f < 0 else (f - h) % r
                            d = next((d for d in range((f0 - h) % r, hi)
                                      if kl[(h + d) % r] == k), -1)
                            if d >= 0:
                                pl = ("found", (h + d) % r)
                        done.append((j, pl))
                    for j, (kind, slot) in done:
                        if kind == "insert":
                            free.discard(slot)
                            kl[slot] = ks[j]
                        place[j] = (kind, slot)
                    todo = todo[len(done):]
            for j, (k, c) in enumerate(zip(ks, cs.tolist())):
                if cls[j] is None:
                    continue
                for p in bloom_positions(torch.tensor([k]), bits):
                    p = int(p)
                    fl[p >> 5] |= 1 << (p & 31)
                kind, slot = (cls[j] if cls[j][0] == "present"
                              else place[first[k]])
                if kind == "spill":
                    spills.append((k, c))
                else:
                    cl[slot] += c
        if (uk[i] != EMPTY).any():
            keys[b], counts[b], filt[b] = kl, cl, fl
        for n, (k, c) in enumerate(spills):
            sk[i, n], sc[i, n] = k, c
    return (keys.astype(np.int32), _wrap32(counts).astype(np.int32),
            filt.astype(np.uint32), sk, sc)


def _block_pool(jp, rng, n):
    """``n`` random keys grouped by block: {block: distinct keys}."""
    keys, blk = _block_keys(jp, rng, n, 1 << 24)
    return {b: np.unique(keys[blk == b]) for b in range(jp.num_slots)}


def _scramble(jp, tk0, tc0, rng):
    """Permute the slots of every tile, so that keys sit past an EMPTY
    from their home (a tile the fold would never build)."""
    tk0, tc0 = tk0.copy(), tc0.copy()
    for b in range(jp.num_slots):
        perm = rng.permutation(jp.r)
        tk0[b], tc0[b] = tk0[b][perm], tc0[b][perm]
    return tk0, tc0


#: name: (q_log2, r_log2, max_u, fill, hot rows, scrambled tiles, chunk)
FOLD_CASES = {
    "repeats": (10, 6, 64, 3, 0, False, 1024),
    "full_tiles": (9, 5, 64, 2, 4, False, 1024),
    "r8": (8, 3, 16, 4, 2, False, 1024),
    "keys_past_empty": (10, 6, 64, 3, 2, True, 1024),
    "max_u_not_multiple_of_4": (9, 4, 23, 3, 2, False, 1024),
    "chunked": (10, 6, 80, 3, 2, True, 16),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_phased_fold_model_matches_pallas(case):
    """The CUDA kernel's phased fold (classify against the tile before the
    merge, first occurrences placed in batches at the first free slot,
    keys past an EMPTY found on the way, spills compacted in order),
    modelled in Python, against the reference's
    Pallas ``merge_dirty`` in interpret mode and the port's plain version:
    bit for bit, on rows of repeated keys, hits, new keys and hot rows that
    fill their tile and spill."""
    from repro.kernels.flash_hash import kernel as jk
    q_log2, r_log2, max_u, fill, hot, scrambled, chunk = FOLD_CASES[case]
    jp, tp = _pairs(q_log2, r_log2)
    n_b, r = jp.num_slots, jp.r
    rng = np.random.default_rng(q_log2 * 100 + r_log2 + max_u)
    tk0, tc0, tf0 = _table(jp, rng, rng.integers(0, 1 << 24, jp.q // fill))
    if scrambled:
        tk0, tc0 = _scramble(jp, tk0, tc0, rng)
    pool = _block_pool(jp, rng, 8 * jp.q)
    dirty = rng.permutation(n_b)[: max(n_b // 2, hot + 1)].astype(np.int32)
    uk = np.full((len(dirty), max_u), EMPTY, np.int32)
    for i, b in enumerate(dirty):
        held = tk0[b][tk0[b] != EMPTY]
        fresh = pool[b][~np.isin(pool[b], held)]
        if i < hot:       # new keys enough to fill the tile, then spill,
            # then keys the tile held (past an EMPTY, in a scrambled tile)
            row = np.concatenate([fresh[: max_u - max_u // 4],
                                  rng.choice(held, max_u // 4)])
        else:
            n = rng.integers(1, max_u + 1)
            mix = np.concatenate([held[: n // 3], fresh[: n // 3 + 1]])
            row = rng.choice(mix, n)          # with repeats
        uk[i, : len(row)] = row
    uc = np.where(uk != EMPTY, rng.integers(-3, 9, uk.shape), 0).astype(
        np.int32)
    want = jk.merge_dirty(jp, jnp.asarray(tk0), jnp.asarray(tc0),
                          jnp.asarray(tf0), jnp.asarray(dirty),
                          jnp.asarray(uk), jnp.asarray(uc))
    model = _phased_fold(tp, tk0, tc0, tf0, dirty, uk, uc, chunk)
    plain = tk.merge_dirty(tp, _t(tk0), _t(tc0), _t(tf0), _t(dirty), _t(uk),
                           _t(uc))
    for name, w, m, p in zip(("keys", "counts", "filter", "spill_k",
                              "spill_c"), want, model, plain):
        p = _u32(p) if name == "filter" else p.numpy()
        np.testing.assert_array_equal(m, _np(w), err_msg=f"model {name}")
        np.testing.assert_array_equal(p, _np(w), err_msg=f"plain {name}")
    if hot:
        assert (_np(want[3]) != EMPTY).any(), "no row spilled"
        assert (_np(want[0])[dirty[:hot]] != EMPTY).all(), "no tile filled"
