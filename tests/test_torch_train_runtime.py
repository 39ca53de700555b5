"""The port's ``CheckpointManager`` and ``ResilientTrainer``: the
reference's cases (``tests/test_checkpoint.py``,
``tests/test_fault_tolerance.py``, except the elastic mesh plan, which
comes with ``launch/sharding.py``) on torch trees, plus what the port
adds: bf16 leaves round-trip by their bit pattern and a checkpoint of
either package restores in the other; ``FlashStore.snapshot(manager=...)``
saves through the manager while a drain is in flight, and that snapshot
restores in the reference (and the reference's in the port); the
trainer registers its stores' quiesce barriers."""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import save_checkpoint as rsave
from repro.core import table_jax as tj
from repro.core.store import FlashStore as RefStore
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import table_torch as tt
from repro_torch.core.store import FlashStore
from repro_torch.runtime import NaNGuard, ResilientTrainer, StepWatchdog

torch.set_num_threads(1)
TABLE = dict(q_log2=10, r_log2=6, log_capacity=1 << 9,
             max_updates_per_block=1 << 6, overflow_capacity=1 << 9)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 4), generator=g),
                       "b": torch.randn(4, generator=g)},
            "opt": {"m": torch.zeros((4, 4)),
                    "count": torch.tensor(17, dtype=torch.int32)}}


# ---------------------------------------------------------------------------
# checkpoints (the reference's cases)
# ---------------------------------------------------------------------------
def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 5, t)
    restored, meta = restore_checkpoint(tmp_path, t)
    assert meta["step"] == 5
    assert torch.equal(restored["params"]["w"], t["params"]["w"])
    assert restored["opt"]["count"].dtype == torch.int32
    assert int(restored["opt"]["count"]) == 17


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, every_steps=2, keep=2)
    t = _tree()
    for step in range(8):
        mgr.maybe_save(step, t, blocking=True)
    assert latest_step(tmp_path) == 6
    assert len(sorted(tmp_path.glob("step_*"))) == 2   # retention


def test_async_save_copies_before_the_writer_runs(tmp_path):
    """The device→host copy happens in ``save``: a change to the tree
    right after it does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, every_steps=1, keep=3)
    t = _tree()
    want = t["params"]["w"].clone()
    mgr.save(3, t, blocking=False)
    t["params"]["w"].add_(1.0)
    mgr.wait()
    assert latest_step(tmp_path) == 3
    got, _ = restore_checkpoint(tmp_path, _tree())
    assert torch.equal(got["params"]["w"], want)


def test_atomic_publish(tmp_path):
    """A .tmp directory never counts as a checkpoint."""
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)
    assert latest_step(tmp_path) is None
    save_checkpoint(tmp_path, 2, _tree())
    assert latest_step(tmp_path) == 2


def test_restore_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        restore_checkpoint(tmp_path, {"b": torch.zeros(3)})
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, {"a": torch.zeros(4)})


def test_emergency(tmp_path):
    mgr = CheckpointManager(tmp_path, every_steps=100)
    mgr.emergency(42, _tree())
    _, meta = restore_checkpoint(tmp_path, _tree())
    assert meta.get("emergency") is True and meta["step"] == 42


def test_data_state_in_meta(tmp_path):
    save_checkpoint(tmp_path, 11, _tree())
    meta = json.loads((tmp_path / "step_00000011" / "meta.json").read_text())
    assert meta["data_state"]["step"] == 11


def test_bf16_and_cross_package_checkpoints(tmp_path):
    """bf16 leaves are stored as uint16 with ``"bfloat16"`` in ``dtypes``
    and come back bit for bit; the reference reads the port's checkpoint
    and the port the reference's, names and dtypes included."""
    g = torch.Generator().manual_seed(1)
    t = {"params": {"w": torch.randn((3, 5), generator=g).to(torch.bfloat16),
                    "b": torch.randn(5, generator=g)},
         "opt": {"count": torch.tensor(4, dtype=torch.int32)}}
    save_checkpoint(tmp_path / "port", 7, t)
    meta = json.loads((tmp_path / "port" / "step_00000007" /
                       "meta.json").read_text())
    assert meta["dtypes"]["params/w"] == "bfloat16"
    back, _ = restore_checkpoint(tmp_path / "port", t)
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"].view(torch.int16),
                       t["params"]["w"].view(torch.int16))
    like = {"params": {"w": jnp.zeros((3, 5), jnp.bfloat16),
                       "b": jnp.zeros(5)}, "opt": {"count": jnp.int32(0)}}
    rback, rmeta = rrestore(tmp_path / "port", like)
    assert rmeta["step"] == 7 and int(rback["opt"]["count"]) == 4
    np.testing.assert_array_equal(
        np.asarray(rback["params"]["w"], np.float32),
        t["params"]["w"].float().numpy())
    rsave(tmp_path / "ref", 9, rback)
    pback, pmeta = restore_checkpoint(tmp_path / "ref", t)
    assert pmeta["step"] == 9
    assert torch.equal(pback["params"]["w"].view(torch.int16),
                       t["params"]["w"].view(torch.int16))
    assert torch.equal(pback["params"]["b"], t["params"]["b"])


# ---------------------------------------------------------------------------
# the resilient trainer (the reference's cases)
# ---------------------------------------------------------------------------
def _quadratic_step(poison_at=None):
    """Minimize (w-3)^2 by gradient descent; optionally poison one step
    with NaN."""
    def step_fn(state, step):
        w = state["w"]
        if poison_at is not None and step == poison_at:
            return state, {"loss": torch.tensor(float("nan"))}
        w = w - 0.1 * 2 * (w - 3.0)
        return {"w": w}, {"loss": (w - 3.0) ** 2}
    return step_fn


def test_runs_to_completion(tmp_path):
    tr = ResilientTrainer(_quadratic_step(),
                          CheckpointManager(tmp_path, every_steps=5))
    _, report = tr.run({"w": torch.tensor(0.0)}, num_steps=40)
    assert report.steps_done == 40 and report.restarts == 0
    assert report.final_loss < 1e-3


def test_restart_from_checkpoint(tmp_path):
    tr = ResilientTrainer(_quadratic_step(),
                          CheckpointManager(tmp_path, every_steps=5),
                          inject_failure_at=17)
    _, report = tr.run({"w": torch.tensor(0.0)}, num_steps=40)
    assert report.restarts == 1
    # steps 0-16, then 16-39 again from step 15's checkpoint (the trainer
    # waits for an in-flight save before it restores)
    assert report.steps_done == 17 + 24
    assert report.final_loss < 1e-3


def test_nan_rollback(tmp_path):
    tr = ResilientTrainer(_quadratic_step(poison_at=12),
                          CheckpointManager(tmp_path, every_steps=5))
    _, report = tr.run({"w": torch.tensor(0.0)}, num_steps=30)
    assert report.rollbacks == 1
    assert math.isfinite(report.final_loss) and report.final_loss < 1e-2


def test_nan_guard_spike():
    g = NaNGuard(spike_factor=5.0, window=8)
    for _ in range(8):
        assert g.check(1.0)
    assert not g.check(100.0)   # spike
    assert g.check(1.1)


def test_watchdog():
    events = []
    w = StepWatchdog(factor=3.0, min_samples=3,
                     on_straggler=lambda s, t, m: events.append(s))
    for i in range(5):
        w.observe(i, 0.1)
    assert w.observe(5, 1.0)     # 10x the median
    assert events == [5]
    assert not w.observe(6, 0.12)


# ---------------------------------------------------------------------------
# stores behind the manager
# ---------------------------------------------------------------------------
def _store(**kw):
    return FlashStore.open(tt.FlashTableConfig(scheme="MDB-L", **TABLE),
                           backend="device", device="cpu", chunk=128,
                           flush_threshold=10_000, **kw)


def _ref_store():
    return RefStore.open(tj.FlashTableConfig(scheme="MDB-L", **TABLE),
                         backend="device", chunk=128, flush_threshold=10_000)


def test_manager_quiesce_joins_an_inflight_drain(tmp_path):
    st = _store()
    ck = CheckpointManager(tmp_path / "ck", every_steps=1, keep=2)
    ck.register_quiesce(st.quiesce)
    ck.register_quiesce(st.quiesce)      # registered once
    assert len(ck._quiesce) == 1
    st.update(np.arange(200))
    st.drain(wait=False)                 # in flight on the worker
    ck.save(0, {"w": torch.zeros(3)}, blocking=True)
    assert not st._b._disp.pending       # the save joined the drain
    st.update(np.arange(50))
    st.drain(wait=False)
    ck.emergency(1, {"w": torch.zeros(3)})
    assert not st._b._disp.pending
    assert (tmp_path / "ck" / "step_00000001").exists()
    st.close()


def test_resilient_trainer_registers_store_quiesce(tmp_path):
    st = FlashStore.open(backend="sim", scheme="MDB-L")
    ck = CheckpointManager(tmp_path / "ck", every_steps=1)
    tr = ResilientTrainer(lambda s, i: (s, {"loss": 1.0}), ck, stores=(st,))
    assert st.quiesce in ck._quiesce and tr.stores == (st,)
    st.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_snapshot_through_a_manager_crosses_packages(tmp_path, writer):
    """A snapshot taken through a manager (its directory, its quiesce
    barrier) while a drain is in flight restores in the other package
    with the same counts."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 900, 600).astype(np.int64)
    src = _store() if writer == "port" else _ref_store()
    ck = (CheckpointManager if writer == "port" else RManager)(
        tmp_path / "ck", every_steps=1, keep=3)
    ck.register_quiesce(src.quiesce)
    src.update(toks[:400])
    src.drain()
    src.update(toks[400:])
    src.drain(wait=False)                # in flight at the snapshot
    out = src.snapshot(tmp_path / "elsewhere", manager=ck)
    assert (tmp_path / "ck" / "step_00000000" / "arrays.npz").exists()
    if writer == "port":
        assert out == tmp_path / "ck" / "step_00000000"
    keys = np.arange(-1, 1000)
    want = src.query(keys)
    np.testing.assert_array_equal(
        want[1:], np.bincount(toks, minlength=1000))
    src.close()
    dst = _ref_store() if writer == "port" else _store()
    rep = dst.restore(tmp_path / "ck")
    assert rep.snapshot_step == 0
    np.testing.assert_array_equal(dst.query(keys), want)
    dst.close()
