"""The kernel checks' least-time bounds against a per-key count.

``check.py`` counts the 32-byte sectors a kernel's work needs with
vectorised masks (the merge's probe windows read back from the merged
tile). Here the same counts come from walking every probe one key at a
time, on small tables on the CPU."""
import pytest
import torch

from repro_torch.core import segments as seg
from repro_torch.core.hashing import Pow2Hash, bloom_positions
from repro_torch.core.hashing import filter_bits_log2
from repro_torch.kernels.flash_hash import check as C

torch.set_num_threads(1)
EMPTY = -1
W = C.SECTOR // 4


def _bits(k, fw):
    p0, p1 = bloom_positions(torch.tensor([k]), filter_bits_log2(fw))
    return int(p0), int(p1)


def _merge_walk(pair, table, blocks, uk, uc):
    """Sectors read and written, and compares made, by folding each key
    into its tile one at a time."""
    keys, counts, filt = (t.clone() for t in table)
    r, fw = pair.r, filt.shape[1]
    sectors, ops = 0, 0
    for i, b in enumerate(blocks.tolist()):
        row = uk[i].tolist()
        if all(k == EMPTY for k in row):
            continue
        k0, c0, f0 = keys[b].tolist(), counts[b].tolist(), filt[b].tolist()
        kl, cl, fl = list(k0), list(c0), list(f0)
        key_rd, cnt_rd, flt_rd, upd_rd = set(), set(), set(), set()
        for j, (k, c) in enumerate(zip(row, uc[i].tolist())):
            if k == EMPTY:
                continue
            upd_rd.add(j // W)
            ops += 6
            home = pair.home_within_block(k)
            for d in range(r):
                slot = (home + d) % r
                key_rd.add(slot // W)
                ops += 1
                if kl[slot] in (k, EMPTY):
                    kl[slot] = k
                    cl[slot] += c
                    cnt_rd.add(slot // W)
                    break
            for p in _bits(k, fw):
                flt_rd.add((p >> 5) // W)
                fl[p >> 5] |= 1 << (p & 31)
        changed = sum(
            len({s // W for s in range(len(a)) if a[s] != z[s]})
            for a, z in ((k0, kl), (c0, cl),
                         ([v & 0xFFFFFFFF for v in f0],
                          [v & 0xFFFFFFFF for v in fl])))
        sectors += (len(key_rd) + len(cnt_rd) + len(flt_rd) + len(upd_rd)
                    + changed)
    n_d, max_u = uk.shape
    return C.SECTOR * sectors + 4 * (n_d + 3 * n_d * max_u), ops


def _query_walk(pair, keys, blocks, q2):
    r = pair.r
    per_block, ops = {}, 0
    for i, b in enumerate(blocks.tolist()):
        kl = keys[b].tolist()
        key_s, cnt_s = per_block.setdefault(b, (set(), set()))
        for k in q2[i].tolist():
            if k == EMPTY or pair.s(k) != b:
                continue
            home = pair.home_within_block(k)
            for d in range(r):
                slot = (home + d) % r
                key_s.add(slot // W)
                ops += 1
                if kl[slot] == k:
                    cnt_s.add(slot // W)
                    break
                if kl[slot] == EMPTY or d == r - 1:
                    break
    sectors = sum(len(a) + len(c) for a, c in per_block.values())
    n_rows, qcap = q2.shape
    return C.SECTOR * sectors + 4 * (n_rows + 3 * n_rows * qcap), ops


def _filter_walk(filt, blocks, q2):
    fw = filt.shape[1]
    per_block, ops = {}, 0
    for i, b in enumerate(blocks.tolist()):
        need = per_block.setdefault(b, set())
        for k in q2[i].tolist():
            if k == EMPTY:
                continue
            ops += 8
            p0, p1 = _bits(k, fw)
            need.add((p0 >> 5) // W)
            if (int(filt[b, p0 >> 5]) >> (p0 & 31)) & 1:
                need.add((p1 >> 5) // W)
    n_rows, qcap = q2.shape
    return (C.SECTOR * sum(len(s) for s in per_block.values())
            + 4 * (n_rows + 2 * n_rows * qcap), ops)


@pytest.mark.parametrize("q_log2,r_log2,max_u,identity",
                         [(9, 5, 16, False), (9, 5, 16, True),
                          (10, 6, 32, False)])
def test_merge_bound_counts_the_sectors_each_key_needs(q_log2, r_log2, max_u,
                                                       identity):
    pair = Pow2Hash(q_log2, r_log2)
    n_b = pair.num_slots
    table = C.fill_table(pair, 0.6, q_log2, "cpu")
    n_d = n_b if identity else n_b // 2
    blocks, uk, uc = C.merge_case(pair, table[0], n_d, max_u, max_u // 4, 3,
                                  r_log2, identity)
    res = C.check_merge_dirty(pair, table, blocks, uk, uc, reps=1,
                              identity=identity)
    assert res["max_abs_err"] == 0 and res["spills"] > 0
    want_bytes, want_ops = _merge_walk(pair, table, blocks, uk, uc)
    assert (res["bound_bytes"], res["bound_ops"]) == (want_bytes, want_ops)
    assert res["bound_by"] == "bytes"


@pytest.mark.parametrize("q_log2,r_log2,qcap,repeat,layout", [
    pytest.param(9, 5, 8, False, "dense", id="9-5-8-False"),
    pytest.param(10, 6, 16, False, "dense", id="10-6-16-False"),
    pytest.param(10, 6, 16, True, "dense", id="10-6-16-True"),
    pytest.param(10, 4, 64, False, "path", id="10-4-64-path"),
    pytest.param(12, 6, 128, False, "path", id="12-6-128-path"),
])
def test_query_and_filter_bounds_count_the_sectors_each_lane_needs(
        q_log2, r_log2, qcap, repeat, layout):
    """At the dense layout and at the lookup path's (``path_query_layout``:
    the Bloom probe sees the dispatch's layout, the query its survivors
    bucketed again)."""
    pair = Pow2Hash(q_log2, r_log2)
    table = C.fill_table(pair, 0.7, q_log2 + 1, "cpu")
    if layout == "path":   # one dispatch of the query engine's chunk
        mix = C.lookup_mix(table[0], r_log2, qcap)
        chunk = C.padded(mix[seg.filter_may_contain(pair, table[2], mix)],
                         qcap)
        probed, (blocks, q2) = C.path_query_layout(pair, table[2], chunk)
    else:
        blocks, q2 = C.query_layout(pair, table[0], pair.num_slots // 2,
                                    qcap, r_log2)
        if repeat:  # rows of one block share its sectors
            blocks = torch.cat([blocks, blocks[:4]])
            q2 = torch.cat([q2, torch.flip(q2[:4], [1])]).contiguous()
        probed = blocks, q2
    res = C.check_query_grid(pair, table, blocks, q2, reps=1)
    assert res["max_abs_err"] == 0
    assert ((res["bound_bytes"], res["bound_ops"])
            == _query_walk(pair, table[0], blocks, q2))
    res = C.check_filter_probe_grid(table, *probed, reps=1)
    assert ((res["bound_bytes"], res["bound_ops"])
            == _filter_walk(table[2], *probed))


def test_device_timing_needs_a_card():
    """``device_ms`` and ``profiled_ms`` time CUDA launches only: given a
    CPU device they raise, and never time the host under a device's
    name."""
    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        C.device_ms({"x": lambda i: None}, 1, cpu)
    with pytest.raises(RuntimeError, match="CUDA device"):
        C.device_ms({"x": lambda i: None}, 1, cpu, C.L2_FLUSH_BYTES)
    with pytest.raises(RuntimeError, match="CUDA device"):
        C.profiled_ms({"x": lambda i: None}, {"x": "kernel"}, 1, cpu)


def test_window_sectors_wrap_around_the_row():
    home = torch.tensor([[30, 3, 0]])
    dist = torch.tensor([[4, 1, 0]])
    # 32 slots = 4 sectors: slots 30..33 wrap to 30, 31, 0, 1
    got = C.window_sectors(home, dist, 32)
    assert got.tolist() == [[True, False, False, True]]
