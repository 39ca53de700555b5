"""The CUDA kernels against their plain PyTorch versions on the card.

Exact equality at several geometries (blocks narrower than a warp up to
2048-slot blocks) and at the main path's shapes, plus the table driven on
the card against the same table driven on the CPU. Needs a CUDA card:
every test skips without one (run them on the card with
``python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py``)."""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import table_torch as tt
from repro_torch.core.hashing import Pow2Hash
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
    return torch.device("cuda", 0)


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
        assert res["spills"] > 0


@pytest.mark.parametrize("q_log2,r_log2,qcap", [(8, 3, 8), (12, 6, 32),
                                                (16, 10, 128), (14, 11, 64),
                                                (24, 10, 128)])
def test_query_kernels_match_plain(cuda, q_log2, r_log2, qcap):
    pair = Pow2Hash(q_log2, r_log2)
    table = C.fill_table(pair, 0.5, q_log2 + 1, cuda)
    n_rows = min(pair.num_slots, 1024)
    blocks, q2 = C.query_layout(pair, table[0], n_rows, qcap, r_log2)
    for res in (C.check_query_grid(pair, table, blocks, q2, reps=1),
                C.check_query(pair, table, q2.reshape(-1), qcap, reps=1),
                C.check_filter_probe_grid(table, blocks, q2, reps=1)):
        assert res["max_abs_err"] == 0


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
