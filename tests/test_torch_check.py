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


@pytest.mark.parametrize("s,causal,window,f32", [
    (1, True, 0, None), (64, False, 0, None), (1000, True, 0, None),
    (1, True, 1, None), (65, True, 1, None), (1000, True, 17, None),
    (1000, True, 64, None), (1000, True, 4096, None),
    (8192, True, 4096, None),
    # the f32 cases at llama3.2-3b's heads: (bound ms, bound_by)
    (512, True, 0, (0.009786285, "operations")),
    (512, True, 77, (0.005008124, "bytes")),
    (4096, True, 0, (0.625253978, "operations"))])
def test_attention_bound_counts_the_pairs_the_mask_keeps(s, causal, window,
                                                         f32):
    """The attention bound's (query, key) pairs and FLOPs against a count
    of the plain version's mask, and the windowed serve's predicted pair
    counts (s = 8,192: causal 33,558,528, w = 4,096: 25,167,872). In f32
    the FLOPs go at the faster of the CUDA cores' 67 TFLOP/s and three
    TF32 passes at 494.7: always the latter (s = 512 causal: 1.614e9
    FLOPs, 0.0098 ms against 0.0241)."""
    from repro_torch.kernels.flash_attn import check as FC
    pos = torch.arange(s)
    keep = torch.ones((s, s), dtype=torch.bool)
    if causal:
        keep = pos[None, :] <= pos[:, None]
        if window:
            keep &= pos[None, :] > pos[:, None] - window
    pairs = int(keep.sum())
    assert FC.kept_pairs(s, causal, window) == pairs
    b = FC.attention_bound(1, s, 36, 4, 128, 64, torch.bfloat16, causal,
                           window)
    assert b["bound_pairs"] == pairs
    assert b["bound_flops"] == 2 * 36 * (128 + 64) * pairs
    if (s, window) == (8192, 4096):
        assert pairs == 25_167_872
        assert FC.kept_pairs(s, True) == 33_558_528
    if f32 is not None:
        fb = FC.attention_bound(1, s, 24, 8, 128, 128, torch.float32, causal,
                                window)
        flops = 2 * 24 * 256 * pairs
        assert fb["bound_flops"] == flops
        assert fb["bound_bytes"] == 4 * s * 8192
        assert fb["bound_peak"] == "tf32 x3 tensor cores"
        by_ops = 3 * flops / 494.7e12 * 1e3
        assert by_ops < flops / 67e12 * 1e3
        assert fb["bound_ms"] == pytest.approx(
            max(by_ops, fb["bound_bytes"] / 3.35e12 * 1e3), rel=1e-12)
        assert (fb["bound_ms"], fb["bound_by"]) == (pytest.approx(
            f32[0], rel=1e-6), f32[1])


@pytest.mark.parametrize("dtype,item", [(torch.bfloat16, 2),
                                        (torch.float32, 4)])
def test_attention_bound_counts_the_true_widths(dtype, item):
    """At starcoder2 TINY's heads (6 / 2 of d = 12, rows the kernels load
    without TMA into boxes padded to 64 bf16 or 32 f32 columns) and at d =
    10, dv = 5, the bound counts the bytes and FLOPs of the true d and dv,
    never of the padded box."""
    from repro_torch.kernels.flash_attn import check as FC
    s = 512
    pairs = s * (s + 1) // 2
    for d, dv in ((12, 12), (10, 5)):
        b = FC.attention_bound(1, s, 6, 2, d, dv, dtype, True)
        assert b["bound_bytes"] == item * s * (6 * d + 2 * d + 2 * dv
                                               + 6 * dv)
        assert b["bound_flops"] == 2 * 6 * (d + dv) * pairs
        assert b["bound_ms"] == pytest.approx(max(
            b["bound_bytes"] / 3.35e12, b["bound_flops"]
            / b["peak_flops_per_s"]) * 1e3, rel=1e-12)
    # s = 512 at d = 12 in bf16: 196,608 bytes, the PR 27 figure's 5.9e-5 ms
    b = FC.attention_bound(1, s, 6, 2, 12, 12, torch.bfloat16, True)
    assert b["bound_bytes"] == 196_608
    assert b["bound_ms"] == pytest.approx(5.87e-5, rel=1e-3)
