"""flashlint — the port's contract checker.

The store's correctness rests on conventions the type system cannot see:
engine pairing lives only in :mod:`repro_torch.core.store`, consumed
table states are rebound and never reused, every state rebind is fenced
by a query-engine invalidation, dispatcher-guarded fields are only
touched under the state lock. Without a checker those contracts are
enforced only by runtime ``assert_live`` guards that fire once the
damage is done. flashlint is the single static pass: each contract is a
named, individually suppressible rule.

Rules:

========  ==================================================================
FL001     no engine/backend construction outside ``core/store.py``
FL002     use after consumption: a state passed to a call that updates it
          in place (``table_torch.update`` / ``flush``,
          ``distributed.update`` / ``flush``, a local ``_consume`` user)
          must be rebound before any further read
FL003     every code path that rebinds ``<backend>.state`` must invalidate
          the paired query engine (the flush→invalidate contract)
FL004     no direct ``threading``/executor imports outside the store's
          dispatcher (plus the WAL, the race harness and the serving
          scheduler's trace-replay feeders)
FL005     no deprecated-shim imports/references (a real parser also
          catches aliased imports)
FL006     dispatcher-guarded fields (``_fl_guarded`` declarations) are
          only accessed under the state lock, or in methods annotated
          ``# flashlint: under-lock`` / ``# flashlint: quiescent``
========  ==================================================================

Suppression: append ``# flashlint: disable=FL002`` (comma-separate for
several rules) to the offending line, or put the comment on its own line
directly above; ``# flashlint: disable-file=FLxxx`` anywhere in a file
disables a rule for the whole file. Suppressions are for *intentional*
contract violations (e.g. the test that proves a consumed state really
is refused) — each one should read as documentation.

Scoping: rules marked ``scope="src"`` encode contracts about package
code only (tests and scripts legitimately construct bare engines or
spin threads to exercise them); they run only on files with a ``src``
path component. Rules marked ``scope="all"`` run everywhere. Fixture
trees (directories named ``lint_fixtures``) are skipped by the recursive
walk — point flashlint at a fixture file explicitly to lint it, and give
fixtures a ``src`` path component when they must trip src-scoped rules.

CLI::

    python -m repro_torch.analysis.flashlint src/repro_torch chip_smoke.py tests

exits 0 on a clean tree, 1 with ``file:line:col: FLxxx message`` per
violation, 2 when nothing was scanned (fail-closed: a typo'd path must
not pass CI).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

#: directories the recursive walk never descends into. ``lint_fixtures``
#: holds deliberately-violating files for the rule tests.
SKIP_DIRS = frozenset({"__pycache__", "lint_fixtures", ".git", ".github",
                       ".venv", "node_modules"})

_DISABLE_RE = re.compile(
    r"#\s*flashlint:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<ids>[A-Za-z0-9_*]+(?:\s*,\s*[A-Za-z0-9_*]+)*)")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class FileContext:
    """Parsed source + metadata handed to every rule's ``check``."""

    def __init__(self, path: Path, display: Optional[str] = None):
        self.path = Path(path)
        self.display = display if display is not None else str(path)
        self.source = self.path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        #: src-scoped rules only run when the file sits under a ``src``
        #: path component (the package tree, or a fixture mimicking it)
        parts = self.path.resolve().parts
        self.src_scoped = "src" in parts

    def violation(self, rule: str, node, message: str) -> Violation:
        return Violation(rule, self.display, getattr(node, "lineno", 0),
                         getattr(node, "col_offset", 0), message)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def def_marker_lines(self, node) -> str:
        """Source lines where FL006's ``under-lock``/``quiescent``
        markers live: the ``def`` signature plus the comment line
        directly above it (above any decorators)."""
        start = node.lineno
        if node.decorator_list:
            start = min(start, node.decorator_list[0].lineno)
        start = max(1, start - 1)     # the comment line above
        end = node.body[0].lineno if node.body else node.lineno + 1
        return "\n".join(self.lines[start - 1:end])


def _suppressions(ctx: FileContext) -> tuple[Dict[int, set], set]:
    """Per-line and file-level suppressed rule ids."""
    per_line: Dict[int, set] = {}
    whole_file: set = set()
    for i, text in enumerate(ctx.lines, start=1):
        m = _DISABLE_RE.search(text)
        if not m:
            continue
        ids = {s.strip().upper() for s in m.group("ids").split(",")}
        if m.group("file"):
            whole_file |= ids
        else:
            # a trailing comment covers its own line; a comment-only
            # line covers the statement below it
            target = i + 1 if text.lstrip().startswith("#") else i
            per_line.setdefault(target, set()).update(ids)
    return per_line, whole_file


def _is_suppressed(v: Violation, per_line: Dict[int, set],
                   whole_file: set) -> bool:
    if v.rule in whole_file or "*" in whole_file:
        return True
    ids = per_line.get(v.line)
    return bool(ids and (v.rule in ids or "*" in ids))


def all_rules():
    """The registry, id → rule module (import deferred so ``--list-rules``
    stays cheap and rule modules can share this module's helpers)."""
    from . import rules_dataflow, rules_locks, rules_structure
    return {
        "FL001": rules_structure.FL001,
        "FL002": rules_dataflow.FL002,
        "FL003": rules_dataflow.FL003,
        "FL004": rules_structure.FL004,
        "FL005": rules_structure.FL005,
        "FL006": rules_locks.FL006,
    }


def iter_py_files(paths: Sequence) -> Iterable[Path]:
    for p in paths:
        p = Path(p)
        if p.is_file():
            if p.suffix == ".py":
                yield p
        elif p.is_dir():
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in SKIP_DIRS
                                 and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield Path(root) / f


def lint_file(path, select: Optional[Sequence[str]] = None,
              display: Optional[str] = None) -> List[Violation]:
    """Run every (selected) rule over one file, honoring scope and
    suppressions. Parse failures surface as an ``FL000`` violation so a
    broken file can never slip through as 'clean'."""
    rules = all_rules()
    if select:
        want = {s.strip().upper() for s in select}
        unknown = want - set(rules)
        if unknown:
            raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
        rules = {k: v for k, v in rules.items() if k in want}
    try:
        ctx = FileContext(path, display=display)
    except SyntaxError as e:
        return [Violation("FL000", display or str(path), e.lineno or 0,
                          e.offset or 0, f"file does not parse: {e.msg}")]
    per_line, whole_file = _suppressions(ctx)
    out: List[Violation] = []
    for rule in rules.values():
        if rule.scope == "src" and not ctx.src_scoped:
            continue
        for v in rule.check(ctx):
            if not _is_suppressed(v, per_line, whole_file):
                out.append(v)
    return out


def lint_paths(paths: Sequence,
               select: Optional[Sequence[str]] = None
               ) -> tuple[List[Violation], int]:
    """Lint every ``.py`` file under ``paths``. Returns
    ``(violations, files_scanned)``."""
    violations: List[Violation] = []
    n = 0
    cwd = Path.cwd()
    for f in iter_py_files(paths):
        n += 1
        try:
            display = str(f.resolve().relative_to(cwd))
        except ValueError:
            display = str(f)
        violations.extend(lint_file(f, select=select, display=display))
    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return violations, n


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.flashlint",
        description="contract checker for the port's FlashStore "
                    "concurrency invariants")
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid}  [{rule.scope:>3}]  {rule.summary}")
        return 0
    if not args.paths:
        ap.error("no paths given (and --list-rules not requested)")
    select = args.select.split(",") if args.select else None
    violations, n_files = lint_paths(args.paths, select=select)
    for v in violations:
        print(v.format())
    if n_files == 0:
        # fail-closed: a typo'd path in CI must not read as a clean pass
        print("flashlint: error: no Python files found under "
              f"{list(map(str, args.paths))}", file=sys.stderr)
        return 2
    if violations:
        print(f"flashlint: {len(violations)} violation(s) "
              f"in {n_files} file(s) scanned", file=sys.stderr)
        return 1
    print(f"flashlint: clean ({n_files} file(s) scanned)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
