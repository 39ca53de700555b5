"""The port's flashlint: twins of ``tests/test_flashlint.py``.

Every port fixture (one file per rule, under
``tests/torch_fixtures/lint_fixtures/src``) trips exactly its rule, the
port's tree and scripts lint clean, the CLI fails closed on empty input,
and suppressions and ``src`` scoping work. On the reference's own
fixtures for FL001 and FL003–FL006 (read in place), the port's checker
reports the reference's ``(rule, line, col)``. FL002 is the port's own:
a state consumed in place by ``table_torch.update`` / ``flush`` (or the
sharded ``distributed.update``) must be rebound before it is read."""
import re
from pathlib import Path

import pytest

from repro.analysis import flashlint as ref_flashlint
from repro_torch.analysis import flashlint

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_fixtures" / "lint_fixtures" / "src"
REF_FIXTURES = REPO / "tests" / "lint_fixtures" / "src"
RULES = ["FL001", "FL002", "FL003", "FL004", "FL005", "FL006"]
PORT_TREE = ([REPO / "src" / "repro_torch"]
             + sorted(REPO.glob("chip_*.py"))
             + sorted((REPO / "tests").glob("test_torch_*.py")))


@pytest.mark.parametrize("rule", RULES)
def test_each_fixture_trips_exactly_its_rule(rule):
    fixture = FIXTURES / f"{rule.lower()}_bad.py"
    vs = flashlint.lint_file(fixture)
    assert vs, f"{fixture.name} should trip {rule}"
    assert {v.rule for v in vs} == {rule}
    assert all(v.line > 0 for v in vs)
    assert re.match(rf".*{rule.lower()}_bad\.py:\d+:\d+: {rule} ",
                    vs[0].format())


@pytest.mark.parametrize("rule", ["FL001", "FL003", "FL004", "FL005",
                                  "FL006"])
def test_reference_fixtures_give_the_reference_findings(rule):
    fixture = REF_FIXTURES / f"{rule.lower()}_bad.py"
    want = [(v.rule, v.line, v.col)
            for v in ref_flashlint.lint_file(fixture)]
    got = [(v.rule, v.line, v.col) for v in flashlint.lint_file(fixture)]
    assert want and got == want


def test_fl002_flags_reads_of_consumed_states():
    vs = flashlint.lint_file(FIXTURES / "fl002_bad.py", select=["FL002"])
    assert [(v.line, v.message.split("'")[1]) for v in vs] == [
        (10, "state.keys"),             # after tt.update
        (16, "state.log_ptr"),          # after tt.flush
        (21, "states")]                 # after D.update
    assert "consumed on line 9" in vs[0].message
    assert "consumed on line 15" in vs[1].message
    assert all("donated" not in v.message for v in vs)


def test_fl002_passes_once_the_state_is_rebound(tmp_path):
    mod = tmp_path / "drain.py"
    mod.write_text(
        "from repro_torch.core import table_torch as tt\n"
        "\n"
        "class Engine:\n"
        "    def drain(self, toks):\n"
        "        tt.assert_live(self.state)\n"
        "        for t in toks:\n"
        "            self.state = tt.update(self.cfg, self.state, t)\n"
        "        self.state = tt.flush(self.cfg, self.state)\n"
        "        return self.state.keys\n"
        "\n"
        "    def stale(self, toks):\n"
        "        new = tt.update(self.cfg, self.state, toks)\n"
        "        return new, self.state.stats\n")
    vs = flashlint.lint_file(mod)
    assert [(v.rule, v.line) for v in vs] == [("FL002", 13)]
    assert "'self.state.stats'" in vs[0].message


def test_fl002_comprehension_target_is_local(tmp_path):
    """A comprehension that consumes its own target (``distributed.flush``
    over each shard) is clean; its iterable is not spent, but a state the
    comprehension consumes from outside is."""
    mod = tmp_path / "shards.py"
    mod.write_text(
        "from repro_torch.core import table_torch as tt\n"
        "\n"
        "def flush_all(cfg, states):\n"
        "    new = [tt.flush(cfg, s) for s in states]\n"
        "    return new, len(states)\n"
        "\n"
        "def flush_one(cfg, state, n):\n"
        "    new = [tt.flush(cfg, state) for _ in range(n)]\n"
        "    return new, state.keys\n")
    vs = flashlint.lint_file(mod)
    assert [(v.rule, v.line, v.message.split("'")[1]) for v in vs] == [
        ("FL002", 9, "state.keys")]


def test_fl002_ignores_modules_outside_the_port(tmp_path):
    mod = tmp_path / "other.py"
    mod.write_text(
        "import torch.distributed as dist\n"
        "from mylib import table_torch as tt\n"
        "\n"
        "def f(cfg, state, group, t):\n"
        "    tt.update(cfg, state, t)\n"
        "    dist.flush(cfg, state)\n"
        "    return state\n")
    assert flashlint.lint_file(mod) == []


def test_fl004_serving_scope():
    """The scheduler (trace-replay feeder threads) is allow-listed; every
    other serving file still trips FL004."""
    vs = flashlint.lint_file(FIXTURES / "serving" / "trace_bad.py")
    assert {v.rule for v in vs} == {"FL004"}
    sched = REPO / "src" / "repro_torch" / "serving" / "scheduler.py"
    assert "threading" in sched.read_text()
    assert [v for v in flashlint.lint_file(sched) if v.rule == "FL004"] == []


def test_fl004_keeps_the_checkpoint_writer_suppression():
    """The checkpoint writer thread is not allow-listed: its import line
    carries the suppression, and without it FL004 fires."""
    ckpt = REPO / "src" / "repro_torch" / "checkpoint" / "checkpoint.py"
    text = ckpt.read_text()
    assert "import threading  # flashlint: disable=FL004" in text
    assert flashlint.lint_file(ckpt) == []
    for name in ("runtime/fault_tolerance.py", "core/distributed.py"):
        assert flashlint.lint_file(REPO / "src" / "repro_torch" / name) == []


def test_cli_exit_codes(tmp_path, capsys):
    assert flashlint.main([str(FIXTURES)]) == 1
    out = capsys.readouterr()
    for rule in RULES:
        assert rule in out.out, f"{rule} missing from CLI output"
    assert re.search(r"fl001_bad\.py:\d+:\d+: FL001", out.out)
    assert flashlint.main([str(p) for p in PORT_TREE]) == 0
    assert "clean" in capsys.readouterr().err
    assert flashlint.main([str(tmp_path)]) == 2
    assert "no Python files" in capsys.readouterr().err


def test_port_tree_is_clean():
    violations, n_files = flashlint.lint_paths(PORT_TREE)
    assert n_files > 100
    assert violations == [], "\n".join(v.format() for v in violations)


def test_recursive_walk_skips_fixture_trees():
    files = list(flashlint.iter_py_files([REPO / "tests"]))
    assert files, "walk found no test files"
    assert not [f for f in files if "lint_fixtures" in f.parts]


def test_unknown_rule_select_rejected():
    with pytest.raises(ValueError, match="FL999"):
        flashlint.lint_file(FIXTURES / "fl001_bad.py", select=["FL999"])


def test_line_and_file_suppressions(tmp_path):
    mod = tmp_path / "src" / "mod.py"
    mod.parent.mkdir()
    mod.write_text(
        "import threading  # flashlint: disable=FL004\n"
        "import _thread\n")
    vs = flashlint.lint_file(mod)
    assert [v.rule for v in vs] == ["FL004"]
    assert vs[0].line == 2                    # only the unsuppressed one
    mod.write_text(
        "# flashlint: disable-file=FL004\n"
        "import threading\n"
        "import _thread\n")
    assert flashlint.lint_file(mod) == []


def test_src_scoping(tmp_path):
    """src-scoped rules stay quiet outside a src tree (tests and scripts
    legitimately construct engines and threads)."""
    mod = tmp_path / "helpers.py"
    mod.write_text("import threading\n")
    assert flashlint.lint_file(mod) == []


def test_syntax_error_is_a_violation(tmp_path):
    bad = tmp_path / "src" / "broken.py"
    bad.parent.mkdir()
    bad.write_text("def oops(:\n")
    vs = flashlint.lint_file(bad)
    assert [v.rule for v in vs] == ["FL000"]
