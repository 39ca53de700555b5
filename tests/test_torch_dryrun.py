"""The dry-run: loop weighting against a trace of every layer, each step
kind on a fake 2×4 mesh at TINY width, and a production cell against the
reference's own dry-run.

``dryrun.trace`` runs a step over fake local shards (no allocation) and
counts rank 0's ops; ``op_analysis.weighted`` extrapolates the traces of
one and two layer groups to the model's depth. Every count is linear in
the depth, so the weighted FLOPs and collective bytes equal a trace of
every layer exactly."""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import Replicate, distribute_tensor

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, op_analysis, sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.config import ShapeConfig

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TINY_SHAPES = (ShapeConfig("tiny_train", 64, 8, "train"),
               ShapeConfig("tiny_prefill", 64, 8, "prefill"),
               ShapeConfig("tiny_decode", 64, 8, "decode"))


@pytest.fixture(scope="module")
def world():
    dryrun.quiet()
    dryrun.ensure_world(512)
    yield
    dryrun.leave_world()


def _tiny_cell(arch, groups):
    cfg = get_config(arch, tiny=True)
    cfg = dataclasses.replace(cfg, num_layers=groups * cfg.group_size)
    plan = mesh_mod.plan_for(cfg, model_axis=4)
    mesh = mesh_mod.arch_mesh(mesh_mod.small_mesh((2, 4), ("data", "model"),
                                                  "cpu"), plan)
    return cfg, plan, mesh


@pytest.mark.parametrize("arch", ["llama32_3b", "granite_moe_1b",
                                  "minicpm3_4b", "mamba2_2p7b"])
def test_loop_weighting_equals_a_trace_of_every_layer(world, arch):
    pp = shd.ParallelPlan(microbatches=2)
    for shape in TINY_SHAPES:
        traced = {}
        for groups in (1, 2, 3):
            cfg, plan, mesh = _tiny_cell(arch, groups)
            traced[groups] = dryrun.trace(cfg, shape, pp, plan, mesh, "cpu",
                                          mb=2 if shape.kind == "train"
                                          else 1)
        got = op_analysis.weighted(traced[1], traced[2], 3)
        assert got["dot_flops"] > 0
        assert got["dot_flops"] == traced[3]["dot_flops"], shape.name
        assert got["collectives"] == traced[3]["collectives"], shape.name
        assert got["hbm_bytes_upper"] == traced[3]["hbm_bytes_upper"]
        # the dry-run's own depth: groups 2 and 3 extrapolated back to 1
        back = op_analysis.weighted(traced[2], traced[3], 1, depth=2)
        assert back["dot_flops"] == traced[1]["dot_flops"], shape.name
        assert back["collectives"] == traced[1]["collectives"], shape.name


def test_counter_counts_the_real_run_as_the_fake_one(world):
    """The same step over real tensors counts what it counts over fake
    ones (the card's check of a dry-run, at TINY width on the CPU)."""
    cfg, plan, mesh = _tiny_cell("llama32_3b", 1)
    shape, pp = TINY_SHAPES[0], shd.ParallelPlan(microbatches=2)
    fake = dryrun.trace(cfg, shape, pp, plan, mesh, "cpu", 2)
    gen = torch.Generator().manual_seed(0)

    def make(s, dtype):
        if dtype.is_floating_point:
            return torch.randn(s, generator=gen).to(dtype) * 0.02
        return torch.randint(0, cfg.vocab_size, s, generator=gen,
                             dtype=dtype)

    with dryrun.steps_mod.sharded(mesh, shd.logical_rules(plan, pp)):
        parts = dryrun.programs(cfg, shape, pp, plan, mesh, make, 2)
        sums = {k: op_analysis.count(fn, shape.seq_len, init)
                for k, (fn, init) in parts.items()}
    real = op_analysis.combine((2, sums["fb"]), (1, sums["apply"]))
    assert real["dot_flops"] == fake["dot_flops"]
    assert real["collectives"] == fake["collectives"]


def test_production_cell_matches_the_reference_dry_run(tmp_path):
    """llama3.2-3b × decode_32k on 16×16, each package's CLI in a process
    of its own: the port's per-device dot FLOPs equal the reference's (its
    HLO parse), and its JSON carries the reference's keys where they have
    a counterpart. The port's run takes the reference's ``--save-hlo``:
    its op listing's lines sum to the traced program's dot FLOPs and op
    count, which its header line states."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    recs = {}
    for pkg in ("repro", "repro_torch"):
        out = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.dryrun", "--arch",
             "llama32_3b", "--shape", "decode_32k", "--mesh", "single",
             "--out", str(tmp_path / pkg)]
            + (["--save-hlo"] if pkg == "repro_torch" else []),
            capture_output=True, text=True, env=env, timeout=600,
            cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        recs[pkg] = json.loads((tmp_path / pkg /
                                "llama32_3b__decode_32k__16_16.json"
                                ).read_text())
    rec, ref = recs["repro_torch"], recs["repro"]
    assert rec["flops"] == ref["flops"]
    assert rec["plan"] == ref["plan"]
    for key in ("arch", "config_name", "shape", "kind", "mesh", "chips",
                "params", "active_params"):
        assert rec[key] == ref[key], key
    assert set(ref["collectives"]) - set(rec["collectives"]) == \
        {"ragged-all-to-all"}
    assert rec["ops_traced"] > 0 and rec["memory"]["peak_bytes"] > 0
    lines = (tmp_path / "repro_torch" / "llama32_3b__decode_32k__16_16"
             ".ops.txt").read_text().splitlines()
    head = dict(f.split("=") for f in lines[0].split() if "=" in f)
    assert lines[0].startswith("# llama32_3b decode_32k ")
    assert head["mesh"] == "16x16" and int(head["depth"]) == 2
    ops = [ln for ln in lines[1:] if not ln.startswith("#")]
    flops = [int(f.removeprefix("flops=")) for ln in ops
             for f in ln.split("\t") if f.startswith("flops=")]
    assert len(flops) == len(ops) == int(head["ops"])
    assert sum(flops) == int(head["dot_flops"]) > 0
    assert any("all-reduce group=" in ln for ln in ops)


def test_opt_cell_plan_is_the_reference_optimized_config(tmp_path):
    """``--opt``: every architecture's config is the reference's
    ``optimized_config`` (``opt_conv_split`` and ``opt_bf16_grads`` set,
    nothing else changed) and its microbatches the reference's
    overrides. The reference's module sets XLA's device count on import,
    so it is read in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    code = ("import dataclasses, json\n"
            "from repro.configs import ARCH_IDS, get_config\n"
            "from repro.launch.dryrun import OPT_PLAN_OVERRIDES, "
            "optimized_config\n"
            "print(json.dumps({'cfg': {a: dataclasses.asdict("
            "optimized_config(get_config(a))) for a in ARCH_IDS}, "
            "'mb': OPT_PLAN_OVERRIDES}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.splitlines()[-1])
    shape = ShapeConfig("train_4k", 4096, 256, "train")
    for arch, want in ref["cfg"].items():
        cfg, pp, _ = dryrun.cell_plan(arch, shape, False, True)
        assert cfg.opt_bf16_grads and cfg.opt_conv_split, arch
        got = json.loads(json.dumps(dataclasses.asdict(cfg)))
        assert got == want, arch
        base = dryrun.cell_plan(arch, shape, False, False)[1]
        assert pp.microbatches == ref["mb"].get(arch, base.microbatches)


def test_cli_fails_on_a_failing_cell(world, tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no strategy")
    monkeypatch.setattr(dryrun, "dryrun_cell", boom)
    with pytest.raises(SystemExit, match="1 dry-run cells failed"):
        dryrun.main(["--arch", "llama32_3b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])


def test_leaving_a_world_forgets_its_meshes(world):
    """DTensor caches placement decisions keyed by a mesh's layout (its
    ``lru_cache``s, a native cache, the redistribution planners): after
    ``leave_world`` none may hold a mesh of the dead group, or a later
    world's mesh of the same layout runs its collectives over the dead
    mesh's group names."""
    cfg, plan, mesh = _tiny_cell("llama32_3b", 1)
    x = distribute_tensor(torch.ones(8, 16), mesh,
                          shd.placements_from_spec(mesh, ("data", "tp_kv")))
    whole = tuple(Replicate() for _ in mesh.mesh_dim_names)
    (x + 1).redistribute(mesh, whole).to_local()
    dead = weakref.ref(mesh)
    del x, mesh
    dryrun.leave_world()
    gc.collect()
    try:
        assert dead() is None
    finally:
        dryrun.ensure_world(512)
