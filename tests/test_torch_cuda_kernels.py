"""The CUDA kernels against their plain PyTorch versions on the card.

Flash-hash kernels: exact equality at several geometries (blocks of one
slot up to 2**21-slot blocks, every merge route) and at the main path's
shapes, plus the table driven on the card against the same table driven
on the CPU.
Flash attention: the two kernels within the reference's tolerances (2e-5
f32, 2e-2 bf16, TF32 off in PyTorch's own products; f16 4e-3) from tiny
heads to llama3.2-3b's, ragged lengths included, each call counted under
the kernel the dtype picks; the wgmma kernel (its bf16 and f16
instances) at every tile boundary, GQA ratio, head width and with q and
k scaled x8; the f32 one (three TF32 passes) on
every lane of its own (lengths at tile edges, GQA ratios, head widths, d
!= dv, two rows, non-causal, windows at tile edges); each with a sliding
window at tile edges, every GQA ratio and head width; both at widths whose
rows are no multiple of 16 bytes (loaded without TMA), odd ones on 2-byte
boundaries and tensors that start off 16 bytes; both at heads wider
than 256 (the wide instances: two warpgroups, each half of the scores
and half of a CTA's columns of o, d in chunks, o in slices of 512 or 256
columns; the f32
one's pre-pass bit for bit against its plain split) at the design's
edges, one launch a call, and with a q of more than 2**31 elements; and the
serving path on the card against the CPU. Needs a CUDA card:
every test skips without one (run them on the card with
``python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py``)."""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import segments as seg
from repro_torch.core import table_torch as tt
from repro_torch.core.hashing import Pow2Hash
from repro_torch.kernels.flash_attn import check as FC
from repro_torch.kernels.flash_attn import kernel as FK
from repro_torch.kernels.flash_hash import check as C
from repro_torch.kernels.flash_hash import kernel as K
from repro_torch.kernels.flash_hash import ref as R

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

GEOMS = [(8, 3, 16), (12, 6, 64), (16, 10, 512), (14, 11, 1024),
         (24, 10, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


@pytest.mark.parametrize("q_log2,r_log2,max_u", GEOMS)
def test_merge_kernels_match_plain(cuda, q_log2, r_log2, max_u):
    pair = Pow2Hash(q_log2, r_log2)
    n_b = pair.num_slots
    table = C.fill_table(pair, 0.55, q_log2, cuda)
    for n_d, ident in ((n_b, True), (n_b, False), (max(n_b // 4, 1), False)):
        blocks, uk, uc = C.merge_case(pair, table[0], n_d, max_u,
                                      max(max_u // 4, 1), min(8, n_d),
                                      r_log2, ident)
        res = C.check_merge_dirty(pair, table, blocks, uk, uc, reps=1,
                                  identity=ident)
        assert res["max_abs_err"] == 0, (n_d, ident)
        assert res["serial_max_abs_err"] == 0, (n_d, ident)
        assert res["spills"] > 0


def _fold_case(q_log2, r_log2, max_u, load, hot, scrambled, seed):
    """A table at ``load`` (every tile's slots permuted with
    ``scrambled``, so that keys sit past an EMPTY from their home) and
    update rows for half its blocks: the first ``hot`` rows new keys
    enough to fill their tile and spill, then keys the tile holds; the
    others a random mix of held and new keys, with repeats."""
    pair = Pow2Hash(q_log2, r_log2)
    n_b, r = pair.num_slots, pair.r
    rng = np.random.default_rng(seed)
    # a plain merge steps once per key of the fullest block: past 8,192
    # slots fill by rounds of parallel probing instead
    fill = C.fill_table if r_log2 <= 13 else C.probe_fill_table
    keys, counts, filt = fill(pair, load, seed, "cpu")
    if scrambled:
        perm = torch.as_tensor(np.argsort(rng.random((n_b, r)), axis=1))
        keys, counts = keys.gather(1, perm), counts.gather(1, perm)
    pool = torch.as_tensor(rng.integers(0, 1 << 30, 8 * pair.q)
                           .astype(np.int32))
    blk = pair.s(pool).numpy()
    pool = pool.numpy()
    dirty = rng.permutation(n_b)[: max(n_b // 2, hot, 1)].astype(np.int32)
    uk = np.full((len(dirty), max_u), -1, np.int32)
    for i, b in enumerate(dirty):
        held = keys[b][keys[b] != -1].numpy()
        fresh = np.unique(pool[blk == b])
        fresh = fresh[~np.isin(fresh, held)]
        if i < hot:   # (a one-slot tile may hold no key to repeat)
            row = np.concatenate([fresh[: max_u - max_u // 4],
                                  rng.choice(held, max_u // 4)
                                  if held.size else []]).astype(np.int32)
        else:
            n = rng.integers(1, max_u + 1)
            row = rng.choice(np.concatenate([held[: n // 3],
                                             fresh[: n // 3 + 1]]), n)
        uk[i, : len(row)] = row
    uc = np.where(uk != -1, rng.integers(-3, 9, uk.shape), 0)
    return (pair, (keys, counts, filt), torch.as_tensor(dirty),
            torch.as_tensor(uk), torch.as_tensor(uc.astype(np.int32)))


def _on_card(t, cuda, misaligned):
    """``t`` on the card, its data 4 bytes past a 16-byte boundary with
    ``misaligned`` (so the kernel loads it without bulk copies)."""
    if not misaligned:
        return t.to(cuda)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:]
    out = buf.view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


#: name: (q_log2, r_log2, max_u, load, hot rows, scrambled tiles). From
#: ``r1`` on, every width the staged fold does not take and its edges
#: (r8, r8192): the in-place route's blocks of 1, 2 and 4 slots, 2**20
#: (one block, the free bitmap at its most in shared memory) and 2**21
#: (the bitmap in the wrapper's scratch); the cluster route's 16,384 (a
#: cluster of one CTA), 2**15, the paper's 65,536 (hot rows fill their
#: tiles and spill; scrambled tiles; rows longer than a chunk, with
#: chunks of EMPTY only after them) and 2**17 (a cluster of 8)
FOLD_CASES = {
    "repeats": (12, 6, 64, 0.4, 0, False),
    "full_tiles": (12, 5, 64, 0.7, 16, False),
    "r8": (10, 3, 16, 0.5, 16, False),
    "keys_past_empty": (12, 6, 64, 0.4, 8, True),
    "max_u_not_multiple_of_4": (12, 4, 23, 0.4, 16, False),
    "all_hot": (14, 10, 1024, 0.55, 16, False),
    "r2048": (16, 11, 1024, 0.7, 4, True),
    "chunked": (16, 11, 2500, 0.5, 4, False),
    "r1": (8, 0, 8, 0.5, 16, False),
    "r2": (8, 1, 8, 0.5, 16, False),
    "r4": (10, 2, 16, 0.5, 16, False),
    "r4_keys_past_empty": (10, 2, 16, 0.5, 0, True),
    "r8192": (16, 13, 2048, 0.9, 2, False),
    "r16384": (16, 14, 4096, 0.9, 2, False),
    "r16384_keys_past_empty": (16, 14, 2048, 0.6, 0, True),
    "r2**15": (17, 15, 4096, 0.95, 2, False),
    "r65536": (18, 16, 8192, 0.95, 2, False),
    "r65536_keys_past_empty": (18, 16, 4096, 0.6, 0, True),
    "r65536_chunked": (18, 16, 8192, 0.5, 0, False),
    "r2**17": (18, 17, 8192, 0.97, 1, False),
    "r2**20": (20, 20, 4096, 0.5, 0, False),
    "r2**21": (21, 21, 2048, 0.5, 0, False),
}


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_merge_fold_matches_plain(cuda, case, misaligned):
    """The path's merge (the route its width takes), the serial kernel
    (where it can stage the tile) and, at the cluster route's widths, the
    in-place route too, each against ``merge_dirty_plain`` exactly, on
    repeated keys, full tiles, keys past an EMPTY, rows longer than a
    chunk, all-hot rows, a row width that is not a multiple of 4 and
    every block width from 1 to 2**21 slots; with tensors on 16-byte
    boundaries (bulk copies) and 4 bytes past them (plain loads).
    Replaces a test that pinned the card's refusal of blocks past 8,192
    slots, which the reference takes."""
    pair, table, blocks, uk, uc = _fold_case(*FOLD_CASES[case],
                                             seed=len(case))
    want = R.merge_dirty_plain(pair, *(t.to(cuda) for t in table),
                               blocks.to(cuda), uk.to(cuda), uc.to(cuda))
    want = [w.cpu() for w in want]
    if FOLD_CASES[case][4]:
        assert (want[3] != -1).any()
    route = K.merge_route(pair.r_log2)
    variants = ["per_row"]
    if K.serial_fits(pair.r_log2, table[2].shape[1]):
        variants.append("serial")
    if route == "cluster":
        variants.append("in_place")
    counters = K.LAUNCHES, K.BASELINE_LAUNCHES, K.MERGE_ROUTES
    before = [dict(c) for c in counters]
    for variant in variants:
        args = [_on_card(t, cuda, misaligned)
                for t in (*table, blocks, uk, uc)]
        spill = [torch.empty(uk.shape, dtype=torch.int32, device=cuda)
                 for _ in range(2)]
        K._launch_merge_dirty(pair, *args, *spill, variant)
        got = args[:3] + spill
        for name, g, w in zip(("keys", "counts", "filter", "spill_k",
                               "spill_c"), got, want):
            assert torch.equal(g.cpu(), w), (variant, name)
    in_place = "in_place" in variants
    assert K.LAUNCHES["merge_dirty"] == before[0]["merge_dirty"] + 1 + in_place
    assert (K.BASELINE_LAUNCHES["merge_dirty_serial"]
            == before[1]["merge_dirty_serial"] + ("serial" in variants))
    assert K.MERGE_ROUTES == {**before[2], route: before[2][route] + 1,
                              **({"in_place": before[2]["in_place"] + 1}
                                 if in_place else {})}
    assert route == ("staged" if 3 <= pair.r_log2 <= 13 else
                     "cluster" if 14 <= pair.r_log2 <= 17 else "in_place")


@pytest.mark.parametrize("r_log2", [14, 16])
def test_cluster_merge_takes_a_repeated_padding_id(cuda, r_log2):
    """A block id repeated on rows without a valid update (the path's
    padding) beside the row that carries that block's updates, at the
    cluster route's widths: the padding rows' clusters write no tile, so
    the result equals ``merge_dirty_plain``'s bit for bit, spills
    included, whichever cluster runs first."""
    pair, table, blocks, uk, uc = _fold_case(r_log2 + 2, r_log2, 4096, 0.97,
                                             1, False, seed=r_log2)
    pad = blocks[0].repeat(3)
    blocks = torch.cat([pad[:1], blocks, pad[1:]])
    empty = torch.full((1, uk.shape[1]), -1, dtype=torch.int32)
    uk = torch.cat([empty, uk, empty, empty])
    uc = torch.cat([torch.zeros_like(empty), uc, torch.zeros_like(empty),
                    torch.zeros_like(empty)])
    args = [t.to(cuda) for t in (*table, blocks, uk, uc)]
    want = [w.cpu() for w in R.merge_dirty_plain(
        pair, *(t.clone() for t in args[:3]), *args[3:])]
    before = dict(K.MERGE_ROUTES)
    got = K.merge_dirty(pair, *args)
    assert K.MERGE_ROUTES == {**before, "cluster": before["cluster"] + 1}
    assert (want[3] != -1).any()
    for name, g, w in zip(("keys", "counts", "filter", "spill_k", "spill_c"),
                          got, want):
        assert torch.equal(g.cpu(), w), name


#: name: (q_log2, r_log2, qcap, table, layout, misaligned). Tables:
#: "half" filled to half load, "dense" to 0.9 (long runs: windows wrap
#: past the tile's end), "full" every tile full (absent keys walk all r
#: slots), "scrambled" half load with every tile's slots permuted (keys
#: past an EMPTY). Layouts: ``check.query_layout`` ("dense") or the
#: path's dispatch (``check.path_query_layout``). Misaligned: "q2" 4 bytes
#: past a 16-byte boundary, "all" the table too (the query's slot-by-slot
#: walk).
QUERY_CASES = {
    "8-3-8": (8, 3, 8, "half", "dense", None),
    "12-6-32": (12, 6, 32, "half", "dense", None),
    "16-10-128": (16, 10, 128, "half", "dense", None),
    "14-11-64": (14, 11, 64, "half", "dense", None),
    "24-10-128": (24, 10, 128, "half", "dense", None),
    "full_tiles": (12, 6, 64, "full", "dense", None),
    "wrapping_windows": (12, 6, 64, "dense", "dense", None),
    "keys_past_empty": (12, 6, 64, "scrambled", "dense", None),
    "r8_fw4": (10, 3, 16, "half", "dense", None),
    "r8192": (20, 13, 128, "half", "dense", None),
    "qcap_23": (12, 6, 23, "half", "dense", None),
    "q2_misaligned": (12, 6, 64, "half", "dense", "q2"),
    "all_misaligned": (12, 8, 64, "dense", "dense", "all"),
    "path_layout": (16, 10, 128, "half", "path", None),
    "path_layout_main_shapes": (24, 10, 128, "half", "path", None),
}


def _query_case(cuda, q_log2, r_log2, qcap, kind, layout, misaligned):
    pair = Pow2Hash(q_log2, r_log2)
    n_b, r = pair.num_slots, pair.r
    seed = q_log2 + 1
    if kind == "full":
        table = C.full_table(pair, seed, cuda)
    else:
        table = C.fill_table(pair, 0.9 if kind == "dense" else 0.5, seed,
                             cuda)
    if kind == "scrambled":
        perm = torch.argsort(torch.rand((n_b, r), generator=torch.Generator()
                                        .manual_seed(seed)), 1).to(cuda)
        table = (table[0].gather(1, perm), table[1].gather(1, perm),
                 table[2])
    table = [_on_card(t, cuda, misaligned == "all") for t in table]
    if layout == "path":
        mix = C.lookup_mix(table[0], r_log2, 1024)
        chunk = C.padded(mix[seg.filter_may_contain(pair, table[2], mix)],
                         1024)
        probed, queried = C.path_query_layout(pair, table[2], chunk, qcap)
    else:
        probed = queried = C.query_layout(pair, table[0],
                                          min(n_b, 1024), qcap, r_log2)
    if misaligned:
        probed, queried = ((b, _on_card(q, cuda, True))
                           for b, q in (probed, queried))
    return pair, table, probed, queried


@pytest.mark.parametrize("case", list(QUERY_CASES))
def test_query_kernels_match_plain(cuda, case):
    """Both query kernels and the Bloom probe, each against its plain
    version on every lane (padding and lanes of other blocks included),
    at block widths from 8 to 8192 slots, on full tiles, windows that
    wrap, keys past an EMPTY, a lane count that is not a multiple of 4,
    tensors off 16-byte boundaries and the lookup path's own layout."""
    pair, table, probed, queried = _query_case(cuda, *QUERY_CASES[case])
    res = C.check_query_grid(pair, table, *queried, reps=1)
    assert res["max_abs_err"] == 0 and res["staged_max_abs_err"] == 0, res
    res = C.check_filter_probe_grid(table, *probed, reps=1)
    assert res["max_abs_err"] == 0, res
    assert 0 < res["maybe"]
    blocks, q2 = queried
    assert C.check_query(pair, table, q2.reshape(-1), q2.shape[1],
                         reps=1)["max_abs_err"] == 0
    # the case holds what it is named for
    cnt, dist = (t.cpu() for t in K.query_grid(pair, *table[:2], blocks,
                                                q2))
    lanes = C._lanes_of_block(pair, blocks, q2).cpu()
    home = pair.home_within_block(q2).cpu()
    kind = QUERY_CASES[case][3]
    if kind == "full":
        assert (dist[lanes] == pair.r).any()
    if kind == "dense":
        assert ((home + dist)[lanes] > pair.r).any()
    if kind == "scrambled":
        held = (table[0].cpu()[blocks.long().cpu()].unsqueeze(1)
                == q2.cpu().unsqueeze(2)).any(2)
        assert (held & lanes & (cnt == 0)).any()
    if QUERY_CASES[case][4] == "path":   # bucketed: no foreign keys
        assert torch.equal(lanes, (q2 != -1).cpu())


@pytest.mark.parametrize("scheme", ["MB", "MDB", "MDB-L"])
def test_table_on_card_equals_table_on_cpu(cuda, scheme):
    """The same updates through the card's kernels and through the plain
    versions on the CPU leave identical states; every kernel launched."""
    cfg = tt.FlashTableConfig(q_log2=14, r_log2=8, scheme=scheme,
                              log_capacity=2048, cs_partitions=4,
                              max_updates_per_block=32,
                              overflow_capacity=1024)
    rng = np.random.default_rng(1)
    states = {d: tt.init(cfg, d) for d in ("cpu", cuda)}
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    for _ in range(6):
        toks = rng.integers(0, 20000, 1024).astype(np.int32)
        for d in states:
            states[d] = tt.update(cfg, states[d], torch.as_tensor(toks))
    q = torch.as_tensor(rng.integers(0, 30000, 512).astype(np.int32))
    looked = {d: tt.lookup_ex(cfg, s, q) for d, s in states.items()}
    for d in states:
        states[d] = tt.flush(cfg, states[d])
    a, b = (convert.state_to_numpy(s) for s in states.values())
    for f in a:
        if f == "stats":
            assert ({k: int(v) for k, v in a[f].items()}
                    == {k: int(v) for k, v in b[f].items()})
        else:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for x, y in zip(*looked.values()):
        np.testing.assert_array_equal(x.numpy(), y.cpu().numpy())
    assert min(K.LAUNCHES.values()) > 0, K.LAUNCHES


def test_wrappers_refuse_mixed_devices(cuda):
    pair = Pow2Hash(8, 5)
    keys = torch.full((pair.num_slots, pair.r), -1, dtype=torch.int32,
                      device=cuda)
    with pytest.raises(ValueError, match="expected cuda"):
        K.query_grid(pair, keys, torch.zeros_like(keys),
                     torch.zeros(2, dtype=torch.int32),
                     torch.zeros((2, 4), dtype=torch.int32, device=cuda))


#: every dtype a kernel takes: f32 (the TF32 kernel), bf16 and f16 (the
#: wgmma kernel's two instances)
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
WGMMA_DTYPES = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("b,s,h,kvh,d,dv,causal", [
    (2, 128, 4, 4, 32, 32, True),      # MHA
    (1, 256, 8, 2, 64, 64, True),      # GQA 4:1
    (2, 128, 6, 2, 16, 16, False),     # GQA 3:1, narrow heads, non-causal
    (1, 1, 4, 2, 16, 16, True),        # one position
    (1, 100, 6, 2, 16, 16, True),      # ragged
    (1, 77, 4, 1, 32, 48, False),      # dv != d, ragged, non-causal
    (1, 64, 4, 2, 256, 256, True),     # the widest heads
    (1, 1000, 24, 8, 128, 128, True),  # llama3.2-3b, ragged
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_plain(cuda, b, s, h, kvh, d, dv, causal,
                                       dtype):
    _check_and_count(cuda, b, s, h, kvh, d, dv, dtype, causal)


def _check_and_count(cuda, b, s, h, kvh, d, dv, dtype, causal, qk_scale=1.0):
    """The kernel that runs the case within tolerance; one call of the
    wrapper counts one launch, of the kernel the split picks."""
    name = FK.kernel_for(dtype, d, dv)
    before = dict(FK.LAUNCHES)
    res = FC.check_flash_attention(b, s, h, kvh, d, dv, dtype, causal, s,
                                   cuda, reps=1, qk_scale=qk_scale)
    assert res["kernel"] == name
    assert res["loads"] == ("tma" if FK.tma_loads(dtype, d, dv) else "warp")
    assert res["finite"] and res["within_tolerance"], res
    assert FK.LAUNCHES == before   # checks do not count
    q, k, v = FC.make_inputs(b, s, h, kvh, d, dv, dtype, 1, cuda, qk_scale)
    FK.flash_attention_fwd(q, k, v, causal=causal)
    assert FK.LAUNCHES == {**before, name: before[name] + 1}
    return name


@pytest.mark.parametrize("b,s,h,kvh,d,dv,causal,qk_scale", [
    (1, 1, 4, 4, 64, 64, True, 1),          # one position, MHA
    (1, 63, 6, 2, 64, 64, True, 1),         # GQA 3:1, below one tile
    (1, 64, 8, 2, 128, 128, True, 1),       # GQA 4:1, one whole tile
    (1, 65, 8, 2, 128, 128, True, 1),       # one key past a tile
    (1, 1000, 4, 1, 128, 128, True, 1),     # ragged, many tiles, MQA
    (2, 1000, 24, 8, 128, 128, True, 1),    # llama3.2-3b heads, two rows
    (1, 200, 4, 4, 256, 256, True, 1),      # the widest heads
    (1, 130, 6, 2, 64, 64, False, 1),       # non-causal, ragged
    (2, 257, 6, 3, 256, 256, False, 1),     # non-causal, widest, two rows
    (1, 300, 4, 2, 64, 128, True, 1),       # d < dv
    (1, 129, 4, 1, 128, 64, False, 1),      # d > dv, non-causal
    (1, 100, 6, 2, 40, 24, True, 1),        # widths below a box, not 2**n
    (1, 512, 24, 8, 128, 128, True, 8),     # q, k x8: scores x64
    (2, 333, 6, 2, 64, 64, False, 8),       # the same, non-causal, ragged
    (1, 512, 40, 40, 96, 64, True, 1),      # minicpm3's MLA prefill heads
    (1, 1000, 40, 40, 96, 64, True, 1),     # the same, ragged
    (1, 512, 16, 8, 64, 64, True, 1),       # granite-moe-1b
    (1, 512, 36, 4, 128, 128, True, 1),     # starcoder2-7b, h/kvh = 9
    (1, 512, 96, 8, 192, 192, True, 1),     # nemotron-4-340b
    (1, 512, 8, 2, 320, 320, True, 1),      # wider than 256: TMA, 2 slices
    (1, 1024, 40, 1, 288, 256, True, 1),    # minicpm3's latent attention
    (1, 1024, 128, 1, 576, 512, True, 1),   # DeepSeek-V3's absorbed MLA
    (1, 1000, 6, 2, 333, 301, True, 1),     # warp route, 2 slices, ragged
    (2, 300, 6, 3, 1030, 517, False, 1),    # 9 chunks of d, 3 slices
    (1, 200, 4, 2, 512, 512, True, 8),      # wide, q and k x8
])
@pytest.mark.parametrize("dtype", WGMMA_DTYPES)
def test_wgmma_flash_attention_matches_plain(cuda, b, s, h, kvh, d, dv,
                                             causal, qk_scale, dtype):
    name = _check_and_count(cuda, b, s, h, kvh, d, dv, dtype, causal,
                            qk_scale)
    assert name == (FK.WGMMA if dtype == torch.bfloat16 else FK.WGMMA_F16)


@pytest.mark.parametrize("b,s,h,kvh,d,dv,causal,w", [
    (1, 1, 4, 4, 128, 128, True, 0),       # one position, MHA
    (1, 63, 6, 2, 64, 64, True, 0),        # GQA 3, below one tile
    (1, 64, 8, 2, 128, 128, True, 0),      # GQA 4, one whole tile
    (1, 65, 8, 2, 128, 128, True, 0),      # one key past a tile
    (1, 1000, 24, 8, 128, 128, True, 0),   # llama3.2-3b's heads, ragged
    (2, 1000, 24, 8, 128, 128, True, 0),   # the same, two rows
    (1, 40, 4, 2, 16, 16, True, 0),        # the TINY twins' prefill
    (2, 100, 6, 2, 16, 16, False, 0),      # narrow heads, non-causal
    (1, 200, 4, 4, 256, 256, True, 0),     # the widest: 32-key tiles
    (2, 257, 6, 3, 256, 256, False, 0),    # the same, non-causal, GQA 2
    (1, 300, 4, 1, 64, 128, True, 0),      # d < dv, MQA
    (1, 129, 4, 1, 128, 64, False, 0),     # d > dv, non-causal
    (1, 100, 6, 2, 12, 20, True, 0),       # widths no multiple of 8
    (1, 100, 6, 2, 256, 8, True, 0),       # the widest d, narrowest dv
    (1, 512, 40, 40, 96, 64, True, 0),     # minicpm3's MLA heads
    (1, 1000, 4, 1, 128, 128, True, 1),    # a window of one key
    (1, 512, 24, 8, 128, 128, True, 77),   # an edge across two tiles
    (2, 1000, 9, 1, 64, 64, True, 100),    # GQA 9, two rows
    (1, 65, 4, 4, 256, 256, True, 63),     # widest heads, windowed
    (1, 1000, 9, 1, 256, 256, True, 17),   # the same, a short window
    (1, 512, 8, 2, 320, 320, True, 0),     # wider than 256: TMA, 2 slices
    (1, 512, 40, 1, 288, 256, True, 0),    # minicpm3's latent attention
    (1, 256, 128, 1, 576, 512, True, 0),   # DeepSeek-V3's absorbed MLA
    (1, 300, 6, 2, 1030, 517, False, 0),   # warp route, 9 chunks, 3 slices
    (2, 257, 6, 3, 333, 301, True, 0),     # odd widths, two rows
    (1, 1000, 6, 2, 512, 512, True, 100),  # wide, windowed
    (1, 65, 4, 4, 300, 200, True, 63),     # wide d, narrow dv, windowed
])
def test_tf32x3_flash_attention_matches_plain(cuda, b, s, h, kvh, d, dv,
                                              causal, w):
    """The f32 kernel (three TF32 passes on the tensor cores) against the
    plain version within the reference's 2e-5 on every lane; one wrapper
    call counts one launch of it."""
    assert FK.kernel_for(torch.float32, d, dv) == FK.TF32X3
    if w:
        _check_window(cuda, b, s, h, kvh, d, dv, torch.float32, w)
    else:
        _check_and_count(cuda, b, s, h, kvh, d, dv, torch.float32, causal)


#: the wide instances at their edges: (b, s, h, kvh, d, dv, causal, window);
#: 40 query heads at s = 200 are 160 query tiles, enough CTAs for slices of
#: 512 columns (``kernel.slice_cols``), 4 heads take slices of 256
WIDE_EDGES = [
    (1, 200, 40, 8, 300, 256, True, 0),    # dv 256: both warpgroups 128
    (1, 200, 40, 8, 300, 257, True, 0),    # dv 257: the second's first one
    (1, 200, 40, 8, 320, 512, True, 0),    # dv 512: both 256, one CTA
    (1, 200, 40, 8, 320, 513, False, 0),   # dv 513: the first extra slice
    (1, 200, 4, 2, 320, 513, True, 0),     # slices of 256: three
    (1, 130, 4, 2, 257, 64, True, 0),      # d 257: the first chunk past 256
    (1, 300, 6, 2, 577, 255, True, 0),     # d 577: bf16's Q streamed
    (2, 150, 6, 3, 1030, 300, False, 0),   # d 1,030: the ninth 128-chunk
    (1, 256, 128, 1, 576, 512, True, 0),   # MQA 128 / 1 (absorbed MLA)
    (1, 333, 9, 1, 320, 320, True, 0),     # GQA 9, ragged
    (1, 1000, 4, 1, 320, 320, True, 100),  # a window
    (1, 1000, 40, 1, 512, 513, True, 65),  # a window, slices of 512
    (2, 40, 4, 2, 320, 320, True, 0),      # s < 64
    (1, 63, 4, 2, 301, 299, False, 0),     # s < 64, odd widths
    (1, 65, 2, 1, 333, 517, True, 0),      # a key tile's second half past s
    (1, 97, 2, 1, 322, 258, True, 0),      # its 33rd key the last
]


@pytest.mark.parametrize("b,s,h,kvh,d,dv,causal,w", WIDE_EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_instances_at_their_edges(cuda, b, s, h, kvh, d, dv, causal,
                                       w, dtype):
    """Each wide instance where its design has an edge (the warpgroups'
    columns, o's slices of 512, d's chunks, a streamed Q, MQA and GQA 9, a
    window, short and ragged lengths, a key tile's half wholly past s)
    within the type's tolerance of the plain version, one launch a call;
    then the same call on q, k and v 4 bytes past a 16-byte boundary,
    which only a TMA route on the caller's tensors refuses (the f32 wide
    instance's pre-pass reads them with plain loads)."""
    if w:
        _check_window(cuda, b, s, h, kvh, d, dv, dtype, w)
    else:
        _check_and_count(cuda, b, s, h, kvh, d, dv, dtype, causal)
    q, k, v = (_shifted(x, 4) for x in FC.make_inputs(
        b, s, h, kvh, d, dv, dtype, 3, cuda))
    if FK.wide_plan(dtype, b, s, h, d, dv)["loads"] == "tma":
        with pytest.raises(ValueError, match="16-byte aligned"):
            FK.flash_attention_fwd(q, k, v, causal=causal, window=w)
        return
    got = FK.flash_attention_fwd(q, k, v, causal=causal, window=w)
    want = FC.ref.sdpa_ref(q, k, v, causal=causal, window=w)
    torch.cuda.synchronize(cuda)
    err = FC._error(got, want, FC.TOLERANCE[dtype])
    assert err["finite"] and err["within_tolerance"], err


@pytest.mark.parametrize("b,s,h,kvh,d,dv", [
    (1, 512, 8, 2, 320, 320),     # the smoke's wide_f32
    (2, 37, 4, 2, 300, 257),      # ragged s, widths no multiple of 32
    (1, 300, 6, 2, 1030, 517),    # no multiple of 4
    (1, 5, 3, 3, 1, 1),           # narrower than a box
])
@pytest.mark.parametrize("misaligned", [False, True])
def test_tf32_split_matches_plain_bit_for_bit(cuda, b, s, h, kvh, d, dv,
                                              misaligned):
    """The f32 wide instance's pre-pass writes, bit for bit, the hi / lo /
    V^T split of ``ref.tf32_split`` (which the CPU tests hold to the
    model's ``_tf32``), also from tensors 4 bytes off 16; its launches are
    counted under its own name and restored by the check."""
    before = dict(FK.SPLIT_LAUNCHES)
    res = FC.check_tf32_split(b, s, h, kvh, d, dv, 11, cuda, reps=1,
                              misaligned=misaligned)
    assert res["mismatches"] == 0, res
    assert FK.SPLIT_LAUNCHES == before
    q, k, v = FC.make_inputs(b, s, h, kvh, d, dv, torch.float32, 1, cuda)
    if max(d, dv) > FK.NARROW_MAX:
        FK.flash_attention_fwd(q, k, v)
        assert FK.SPLIT_LAUNCHES == {
            FK.TF32X3_SPLIT: before[FK.TF32X3_SPLIT] + 1}


WINDOW_S = [1, 63, 64, 65, 1000, 8192]
WINDOW_W = [1, 17, 63, 64, 65, 4096]


def _check_window(cuda, b, s, h, kvh, d, dv, dtype, window):
    """The kernel the split picks against ``sdpa_ref(window=)`` within
    the reference's tolerance; one call of the wrapper counts one launch,
    of that kernel."""
    q, k, v = FC.make_inputs(b, s, h, kvh, d, dv, dtype, s + window, cuda)
    want = FC.ref.sdpa_ref(q, k, v, window=window)
    name = FK.kernel_for(dtype, d, dv)
    before = dict(FK.LAUNCHES)
    got = FK.launch(q, k, v, True, name, window)
    torch.cuda.synchronize(cuda)
    err = FC._error(got, want, FC.TOLERANCE[dtype])
    assert err["finite"] and err["within_tolerance"], (name, err)
    FK.LAUNCHES.update(before)
    FK.flash_attention_fwd(q, k, v, window=window)
    assert FK.LAUNCHES == {**before, name: before[name] + 1}


@pytest.mark.parametrize("w", WINDOW_W)
@pytest.mark.parametrize("s", WINDOW_S)
@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_flash_attention_matches_plain(cuda, s, w, dtype):
    """A sliding window at tile edges (63, 64, 65 keys; 1 and 17 inside
    a tile, 4,096 past most lengths), over lengths at tile edges, ragged
    and long; d = dv = 128, GQA 4."""
    _check_window(cuda, 1, s, 4, 1, 128, 128, dtype, w)


@pytest.mark.parametrize("b,s,h,kvh,d,dv,w", [
    (1, 1000, 4, 4, 64, 64, 65),        # MHA, narrow heads
    (2, 1000, 9, 1, 64, 64, 100),       # GQA 9, two rows
    (1, 65, 4, 4, 256, 256, 63),        # the widest heads
    (1, 1000, 9, 1, 256, 256, 17),      # widest, GQA 9
    (1, 8192, 36, 4, 128, 128, 4096),   # starcoder2-7b's heads and window
    (1, 1000, 8, 2, 64, 128, 77),       # d < dv
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_flash_attention_heads(cuda, b, s, h, kvh, d, dv, w,
                                        dtype):
    _check_window(cuda, b, s, h, kvh, d, dv, dtype, w)


def _shifted(x, by=None):
    """x's values in a contiguous tensor that starts one element past an
    aligned allocation (2 bytes off 16 in bf16, 4 in f32), or ``by`` bytes
    past it."""
    n = 1 if by is None else by // x.element_size()
    buf = torch.empty(x.numel() + n, dtype=x.dtype, device=x.device)
    y = buf[n:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("b,s,h,kvh,d,dv,causal,w", [
    (1, 512, 6, 2, 12, 12, True, 0),      # starcoder2 TINY's heads
    (1, 1000, 6, 2, 10, 5, True, 0),      # odd dv: 2-byte rows, ragged
    (2, 129, 4, 4, 3, 7, False, 0),       # odd d and dv, non-causal
    (1, 512, 4, 2, 6, 6, True, 0),        # f32 rows of 24 bytes
    (1, 65, 4, 1, 1, 1, True, 0),         # one column, one key past a tile
    (1, 300, 6, 3, 130, 66, True, 0),     # three boxes of d: P = 256
    (1, 200, 4, 2, 255, 255, False, 0),   # the widest odd width
    (1, 1000, 6, 2, 12, 12, True, 100),   # windowed
    (1, 1000, 9, 1, 10, 5, True, 17),     # windowed, GQA 9
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_not_16_bytes_match_plain(cuda, b, s, h, kvh, d, dv, causal,
                                       w, dtype):
    """Widths whose rows are no multiple of 16 bytes, which each kernel's
    producer warp loads without TMA into the boxes TMA would write (zeros
    past d, dv and s), within the reference's tolerance, one launch a
    wrapper call; then the same call on tensors that start one element
    past an aligned allocation (bf16 rows of odd width start on 2-byte
    boundaries anyway), which only the TMA route refuses."""
    if w:
        _check_window(cuda, b, s, h, kvh, d, dv, dtype, w)
    else:
        _check_and_count(cuda, b, s, h, kvh, d, dv, dtype, causal)
    q, k, v = (_shifted(x) for x in FC.make_inputs(b, s, h, kvh, d, dv,
                                                   dtype, 2, cuda))
    if FK.tma_loads(dtype, d, dv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            FK.flash_attention_fwd(q, k, v, causal=causal, window=w)
        return
    got = FK.flash_attention_fwd(q, k, v, causal=causal, window=w)
    want = FC.ref.sdpa_ref(q, k, v, causal=causal, window=w)
    torch.cuda.synchronize(cuda)
    err = FC._error(got, want, FC.TOLERANCE[dtype])
    assert err["finite"] and err["within_tolerance"], err


#: (d, dv): rows of every alignment (odd bf16 widths on 2-byte
#: boundaries), each instance (P = 64, 128, 256 and the wide one: d in
#: chunks, o in slices) and d != dv on each side of 256
WIDTHS = [(1, 1), (2, 3), (3, 7), (5, 5), (6, 6), (7, 9), (10, 5), (12, 12),
          (13, 17), (33, 31), (63, 65), (65, 63), (100, 100), (127, 129),
          (130, 66), (200, 250), (255, 255), (256, 255), (255, 256),
          (257, 257), (300, 200), (200, 300), (333, 301), (511, 513),
          (576, 512), (1024, 1024)]


@pytest.mark.parametrize("d,dv", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_width_matches_plain(cuda, d, dv, dtype):
    """Widths the reference takes, on each side of 256, at one position,
    one key past a tile, a ragged non-causal length and a window of 17,
    two rows of 6 / 2 heads: within the reference's tolerance."""
    for s, causal, w in ((1, True, 0), (65, True, 0), (300, False, 0),
                         (200, True, 17)):
        q, k, v = FC.make_inputs(2, s, 6, 2, d, dv, dtype, s + d, cuda)
        got = FK.flash_attention_fwd(q, k, v, causal=causal, window=w)
        want = FC.ref.sdpa_ref(q, k, v, causal=causal, window=w)
        torch.cuda.synchronize(cuda)
        err = FC._error(got, want, FC.TOLERANCE[dtype])
        assert err["finite"] and err["within_tolerance"], (s, causal, w, err)


@pytest.mark.parametrize("dtype", WGMMA_DTYPES)
def test_q_of_more_than_2_31_elements(cuda, dtype):
    """q, k, v and o of 2**31 elements each (4 GiB in bf16 or f16: b
    2,048, s 64, h 16, d 1,024), so that an offset taken in 32 bits would
    wrap: one launch, within the type's tolerance of the plain version,
    which is computed a batch slice at a time to bound its f32 copies."""
    b, s, h, d = 2048, 64, 16, 1024
    q, k, v = FC.make_inputs(b, s, h, h, d, d, dtype, 7, cuda)
    assert q.numel() == 2 ** 31
    name = FK.kernel_for(dtype, d, d)
    before = dict(FK.LAUNCHES)
    got = FK.flash_attention_fwd(q, k, v)
    assert FK.LAUNCHES == {**before, name: before[name] + 1}
    worst = 0.0
    for b0 in range(0, b, 256):
        part = slice(b0, b0 + 256)
        want = FC.ref.sdpa_ref(q[part], k[part], v[part])
        err = FC._error(got[part], want, FC.TOLERANCE[dtype])
        assert err["finite"] and err["within_tolerance"], (b0, err)
        worst = max(worst, err["max_abs_err"])
    # the last batch row, whose offsets pass 2**31 elements, holds data
    assert float(got[-1].float().abs().max()) > 0, worst


@pytest.mark.parametrize("b,h,d", [(65537, 1, 8), (1, 65537, 8),
                                   (65537, 1, 264)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_b_times_h_past_65535(cuda, b, h, d, dtype):
    """b * h = 65,537 CTAs along the grid's x, whose limit is 2**31 - 1
    (the wrapper refused past 65,535 before), at a short s, on each
    kernel and each one's wide instance: one launch, within the type's
    tolerance of the plain version."""
    q, k, v = FC.make_inputs(b, 16, h, 1, d, d, dtype, 5, cuda)
    name = FK.kernel_for(dtype, d, d)
    before = dict(FK.LAUNCHES)
    got = FK.flash_attention_fwd(q, k, v)
    assert FK.LAUNCHES == {**before, name: before[name] + 1}
    want = FC.ref.sdpa_ref(q, k, v)
    torch.cuda.synchronize(cuda)
    err = FC._error(got, want, FC.TOLERANCE[dtype])
    assert err["finite"] and err["within_tolerance"], err


@pytest.mark.parametrize("s,d", [(65536 * 64 + 1, 8), (32768 * 64 + 1, 520)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_query_tiles_past_65535(cuda, s, d, dtype):
    """More (query tile, o slice) pairs than the grid's y holds: 65,537
    tiles of 64 rows at d = 8, and 32,769 tiles x 2 slices of o at d =
    520 (the wide instance), so the pairs go on along z; h = kvh = 1 and
    a window of 64 keep it cheap. The first, a middle and the last 4,096
    rows against plain attention over those rows and the 63 keys before
    them; one launch."""
    w, n = 64, 4096
    q, k, v = FC.make_inputs(1, s, 1, 1, d, d, dtype, 9, cuda)
    name = FK.kernel_for(dtype, d, d)
    before = dict(FK.LAUNCHES)
    got = FK.flash_attention_fwd(q, k, v, window=w)
    assert FK.LAUNCHES == {**before, name: before[name] + 1}
    for lo in (0, (s // 2) // 64 * 64 + 13, s - n):
        a = max(lo - (w - 1), 0)
        part = slice(a, lo + n)
        want = FC.ref.sdpa_ref(q[:, part], k[:, part], v[:, part],
                               window=w)[:, lo - a:]
        torch.cuda.synchronize(cuda)
        err = FC._error(got[:, lo:lo + n], want, FC.TOLERANCE[dtype])
        assert err["finite"] and err["within_tolerance"], (lo, err)


def test_flash_attention_refuses_mixed_devices(cuda):
    q, k, v = FC.make_inputs(1, 8, 2, 2, 16, 16, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        FK.flash_attention_fwd(q, k.cpu(), v)


@pytest.mark.parametrize("flush_threshold", [None, 1])
def test_serving_on_card_equals_serving_on_cpu(cuda, flush_threshold):
    """llama32 TINY in f32 with the same weights on both devices: the
    same greedy outputs, cached prefixes and cache stats; every prefill
    went through the kernel. With ``flush_threshold=1`` every pin and
    unpin drains into the device table, so the flash-hash kernels hold
    the refcounts on the card (counters that depend on when a drain
    lands are left out)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import PrefixKVCache, Request, ServeEngine
    cfg = dataclasses.replace(get_config("llama32_3b", tiny=True),
                              dtype="float32")
    cpu_model = Model(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    p0 = rng.integers(0, cfg.vocab_size, 40).tolist()
    prompts = ([p0] + [p0[:16] + rng.integers(0, cfg.vocab_size, 24).tolist()
                       for _ in range(3)]
               + [rng.integers(0, cfg.vocab_size, 40).tolist()
                  for _ in range(4)])
    timing = (("query_cache_hits", "query_device_keys", "query_batches")
              if flush_threshold else ())
    runs = {}
    for k in FK.LAUNCHES:
        FK.LAUNCHES[k] = 0
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    for dev in ("cpu", cuda):
        model = Model(cfg, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        cache = PrefixKVCache(block_tokens=8, capacity_blocks=5, device=dev,
                              flush_threshold=flush_threshold)
        done = ServeEngine(cfg, model, cache).serve(
            [Request(prompt=list(p), max_new_tokens=8) for p in prompts])
        cache._refs.flush()
        stats = {k: v for k, v in cache.stats().items() if k not in timing}
        runs[str(dev)] = ([r.output for r in done],
                          [r.cached_tokens for r in done], stats,
                          cache._count(list(cache.store)).tolist())
        cache.close()
    assert runs["cpu"] == runs[str(cuda)]
    assert runs["cpu"][1] == [0, 16, 16, 16, 0, 0, 0, 0]
    assert FK.LAUNCHES == {FK.TF32X3: 5 * cfg.num_layers, FK.WGMMA: 0,
                           FK.WGMMA_F16: 0}
    if flush_threshold:
        assert min(K.LAUNCHES.values()) > 0, K.LAUNCHES


@pytest.mark.parametrize("arch", ["granite_moe_1b", "phi35_moe_42b",
                                  "minicpm3_4b", "starcoder2_7b",
                                  "nemotron4_340b", "llava_next_mistral_7b",
                                  "mamba2_2p7b", "musicgen_large",
                                  "jamba15_large_398b"])
def test_family_serving_on_card_equals_serving_on_cpu(cuda, arch):
    """Each family's TINY in f32 with the same weights on both devices:
    the same greedy outputs, cached prefixes and cache stats; every
    attention prefill on the card went through the f32 tensor-core
    kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving import PrefixKVCache, Request, ServeEngine
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    cpu_model = Model(cfg, device="cpu", seed=3)
    n = 32 if "ssm" in cfg.layer_pattern else 40
    rng = np.random.default_rng(0)
    p0 = rng.integers(0, cfg.vocab_size, n).tolist()
    prompts = ([p0] + [p0[:16] + rng.integers(0, cfg.vocab_size,
                                              n - 16).tolist()
                       for _ in range(3)]
               + [rng.integers(0, cfg.vocab_size, n).tolist()
                  for _ in range(4)])
    runs = {}
    for k in FK.LAUNCHES:
        FK.LAUNCHES[k] = 0
    for dev in ("cpu", cuda):
        model = Model(cfg, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        cache = PrefixKVCache(block_tokens=8, capacity_blocks=5, device=dev)
        done = ServeEngine(cfg, model, cache).serve(
            [Request(prompt=list(p), max_new_tokens=8) for p in prompts])
        cache._refs.flush()
        runs[str(dev)] = ([r.output for r in done],
                          [r.cached_tokens for r in done], cache.stats())
        cache.close()
    assert runs["cpu"] == runs[str(cuda)]
    attn_layers = cfg.num_groups * cfg.layer_pattern.count("attn")
    prefills = 5 if "ssm" not in cfg.layer_pattern else 8
    assert FK.LAUNCHES == {FK.TF32X3: prefills * attn_layers,
                           FK.WGMMA: 0, FK.WGMMA_F16: 0}
