"""The port's sharded FlashStore over two processes (torch.distributed,
gloo), the twin of ``tests/test_multihost.py``.

Each test runs ``helpers/torch_multihost_main.py`` as the parent, which
starts two worker processes of 4 shards each (one 8-shard store over a
localhost gloo group, every child under a wall-clock limit with
``faulthandler`` armed) and compares their answers with the truth, the
port's single-process 8-shard store and the port's sim. The equivalence
tests also hold them against the reference's single-process 8-shard
store on the same stream (``helpers/torch_sharded_ref_main.py``)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HELPERS = Path(__file__).parent / "helpers"


def _run(scenario, tmp_path, scheme="MDB-L", timeout=600):
    return subprocess.run(
        [sys.executable, str(HELPERS / "torch_multihost_main.py"),
         "--scenario", scenario, "--scheme", scheme, "--tmp", str(tmp_path)],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ))


@pytest.fixture(scope="module")
def ref_dump(tmp_path_factory):
    """The reference's single-process 8-shard store on the parity stream
    (the equivalence scenario's stream): its final answers per scheme."""
    out = tmp_path_factory.mktemp("ref_sharded")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable,
                        str(HELPERS / "torch_sharded_ref_main.py"), "dump",
                        str(out)], capture_output=True, text=True,
                       timeout=900, env=env)
    assert "REF_SHARDED_OK" in r.stdout, r.stdout[-3000:] + r.stderr[-3000:]
    return out


@pytest.mark.slow
@pytest.mark.parametrize("scheme", ["MB", "MDB", "MDB-L"])
def test_two_processes_match_one_and_the_reference(scheme, tmp_path,
                                                   ref_dump):
    """2 processes x 4 shards give the truth, the single-process 8-shard
    store's answers, the sim's and the reference's single-process
    answers; the waves carry nothing on either rank."""
    r = _run("equivalence", tmp_path, scheme)
    assert "MULTIHOST_OK" in r.stdout, r.stdout[-4000:] + r.stderr[-4000:]
    got = np.load(tmp_path / "mh_counts.npy")
    want = np.load(ref_dump / f"{scheme}.npz")["answers/final"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_partition_heat_does_not_depend_on_the_topology(tmp_path):
    """The same skewed trace gives the same per-block heat, and the same
    eviction victim, on 1 process x 8 shards and 2 x 4."""
    r = _run("heat", tmp_path)
    assert "MULTIHOST_OK" in r.stdout, r.stdout[-4000:] + r.stderr[-4000:]
    assert "HEAT_MATCH" in r.stdout


@pytest.mark.slow
def test_per_host_wals_restore_independently(tmp_path):
    """Each process replays its own WAL after a crash; the collective
    replay drain rebuilds the exact contents."""
    r = _run("wal_restore", tmp_path)
    assert "MULTIHOST_OK" in r.stdout, r.stdout[-4000:] + r.stderr[-4000:]


@pytest.mark.slow
def test_handoff_is_process_count_aware(tmp_path):
    """A departed store's WAL replayed by two surviving processes lands
    exactly once: disjoint round-robin slices, totals equal the truth."""
    r = _run("handoff", tmp_path)
    assert "MULTIHOST_OK" in r.stdout, r.stdout[-4000:] + r.stderr[-4000:]
    assert "HANDOFF0" in r.stdout and "HANDOFF1" in r.stdout
