"""The CUDA kernels against their plain PyTorch versions on the card.

Flash-hash kernels: exact equality at several geometries (blocks narrower
than a warp up to 2048-slot blocks) and at the main path's shapes, plus
the table driven on the card against the same table driven on the CPU.
Flash attention: both kernels within the reference's tolerances (2e-5
f32, 2e-2 bf16, TF32 off) from tiny heads to llama3.2-3b's, ragged lengths
included, each call counted under the kernel the dtype/shape split picks;
the tensor-core kernel at every tile boundary, GQA ratio, head width and
with q and k scaled x8; and the serving path on the card against the
CPU. Needs a CUDA card:
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
    keys, counts, filt = C.fill_table(pair, load, seed, "cpu")
    if scrambled:
        perm = torch.as_tensor(np.argsort(rng.random((n_b, r)), axis=1))
        keys, counts = keys.gather(1, perm), counts.gather(1, perm)
    pool = torch.as_tensor(rng.integers(0, 1 << 30, 8 * pair.q)
                           .astype(np.int32))
    blk = pair.s(pool).numpy()
    pool = pool.numpy()
    dirty = rng.permutation(n_b)[: max(n_b // 2, hot)].astype(np.int32)
    uk = np.full((len(dirty), max_u), -1, np.int32)
    for i, b in enumerate(dirty):
        held = keys[b][keys[b] != -1].numpy()
        fresh = np.unique(pool[blk == b])
        fresh = fresh[~np.isin(fresh, held)]
        if i < hot:
            row = np.concatenate([fresh[: max_u - max_u // 4],
                                  rng.choice(held, max_u // 4)])
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


#: name: (q_log2, r_log2, max_u, load, hot rows, scrambled tiles)
FOLD_CASES = {
    "repeats": (12, 6, 64, 0.4, 0, False),
    "full_tiles": (12, 5, 64, 0.7, 16, False),
    "r8": (10, 3, 16, 0.5, 16, False),
    "keys_past_empty": (12, 6, 64, 0.4, 8, True),
    "max_u_not_multiple_of_4": (12, 4, 23, 0.4, 16, False),
    "all_hot": (14, 10, 1024, 0.55, 16, False),
    "r2048": (16, 11, 1024, 0.7, 4, True),
    "chunked": (16, 11, 2500, 0.5, 4, False),
}


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_merge_fold_matches_plain(cuda, case, misaligned):
    """The parallel fold and the serial kernel, each against ``merge_dirty_plain`` exactly, on
    repeated keys, full tiles, r=8 and r=2048, keys past an EMPTY, rows
    longer than a chunk, all-hot rows and a row width that is not a
    multiple of 4; with tensors on 16-byte boundaries (bulk copies) and
    4 bytes past them (plain loads)."""
    pair, table, blocks, uk, uc = _fold_case(*FOLD_CASES[case],
                                             seed=len(case))
    want = K.merge_dirty(pair, *(t.clone() for t in table), blocks, uk, uc)
    if FOLD_CASES[case][4]:
        assert (want[3] != -1).any()
    launches = dict(K.LAUNCHES), dict(K.BASELINE_LAUNCHES)
    for variant in K.MERGE_ENTRIES:
        args = [_on_card(t, cuda, misaligned)
                for t in (*table, blocks, uk, uc)]
        spill = [torch.empty(uk.shape, dtype=torch.int32, device=cuda)
                 for _ in range(2)]
        K._launch_merge_dirty(pair, *args, *spill, variant)
        got = args[:3] + spill
        for name, g, w in zip(("keys", "counts", "filter", "spill_k",
                               "spill_c"), got, want):
            assert torch.equal(g.cpu(), w), (variant, name)
    assert K.LAUNCHES["merge_dirty"] == launches[0]["merge_dirty"] + 1
    assert (K.BASELINE_LAUNCHES["merge_dirty_serial"]
            == launches[1]["merge_dirty_serial"] + 1)


def test_merge_refuses_blocks_past_8192_slots(cuda):
    """The parallel fold takes blocks of 8 to 8192 slots; the kernel's
    entry point refuses wider ones and the launch raises."""
    pair = Pow2Hash(16, 14)
    table = [t.to(cuda) for t in C.fill_table(pair, 0.1, 1, "cpu")]
    blocks = torch.zeros(1, dtype=torch.int32, device=cuda)
    uk = torch.full((1, 8), 5, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        K.merge_dirty(pair, *table, blocks, uk, torch.ones_like(uk))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, b, s, h, kvh, d, dv, causal,
                                       dtype):
    _check_and_count(cuda, b, s, h, kvh, d, dv, dtype, causal)


def _check_and_count(cuda, b, s, h, kvh, d, dv, dtype, causal, qk_scale=1.0):
    """Both kernels that run the case within tolerance; one call of the
    wrapper counts one launch, of the kernel the split picks."""
    name = FK.kernel_for(dtype, d, dv)
    before = dict(FK.LAUNCHES)
    res = FC.check_flash_attention(b, s, h, kvh, d, dv, dtype, causal, s,
                                   cuda, reps=1, qk_scale=qk_scale)
    assert res["kernel"] == name
    assert res["finite"] and res["within_tolerance"], res
    if name == FK.WGMMA:    # the CUDA-core kernel, timed as the "before"
        assert res["simt_finite"] and res["simt_within_tolerance"], res
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
])
def test_wgmma_flash_attention_matches_plain(cuda, b, s, h, kvh, d, dv,
                                             causal, qk_scale):
    name = _check_and_count(cuda, b, s, h, kvh, d, dv, torch.bfloat16,
                            causal, qk_scale)
    assert name == FK.WGMMA


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
    assert FK.LAUNCHES == {FK.SIMT: 5 * cfg.num_layers, FK.WGMMA: 0}
    if flush_threshold:
        assert min(K.LAUNCHES.values()) > 0, K.LAUNCHES
