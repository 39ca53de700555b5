"""Dry-run of the production meshes: trace every (arch × shape × mesh)
cell's per-device program on the host, without a card.

For each cell this shows, without hardware: (i) the sharding rules are
coherent (DTensor places every op of the step on the arch mesh), (ii)
what one device holds at its peak, and (iii) the roofline terms: dot
FLOPs, HBM bytes (upper and flash-projected) and collective bytes by
kind, per device (``op_analysis``; the reference lowers and compiles the
step and parses its HLO instead).

How: the process joins a fake process group of 512 ranks
(``torch.testing._internal.distributed.fake_pg``: collectives complete
without moving data) as rank 0; parameters, moments, caches and the
batch are DTensors of their production global shapes whose local shards
are fake tensors (``FakeTensorMode``: no allocation); the step is the
port's own ``train_step`` / ``prefill_step`` / ``decode_step``. Loop
weighting: two groups and three groups of layers are traced and every
count (and the peak) is extrapolated to ``num_groups``; a train step traces one
microbatch, and its grad accumulation is multiplied by the microbatch
count (the optimizer update, traced alone, counts once).

Artifacts: ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` with
the reference's keys where a key has a counterpart (``hlo_lines`` →
``ops_traced``; no XLA memory analysis → ``memory`` holds the reckoned
peaks). ``--save-hlo`` (the reference's flag, which writes its HLO) also
writes ``<arch>__<shape>__<mesh>.ops.txt``: a header line (arch, shape,
mesh, the traced depth, that trace's op count and dot FLOPs), then rank
0's traced program at that depth, one line an op.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama32_3b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import logging
import time
from pathlib import Path
from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCH_IDS, get_config
from ..models.config import SHAPES, ModelConfig, ShapeConfig, shapes_for
from ..optim import AdamWConfig
from ..optim.adamw import adamw_init
from . import input_specs as ispec
from . import op_analysis
from . import sharding as shd
from . import steps as steps_mod
from .mesh import arch_mesh, make_production_mesh, plan_for

OUT = "artifacts/dryrun_torch"
WORLD = 512

OPT_PLAN_OVERRIDES = {
    # fewer grad-accumulation microbatches → proportionally fewer FSDP
    # all-gathers a step (the reference's --opt plan)
    "nemotron4_340b": 2,
    "jamba15_large_398b": 4,
}


def ensure_world(n: int) -> None:
    """Join a fake process group of at least ``n`` ranks as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() >= n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def leave_world() -> None:
    """Destroy the default process group and forget DTensor's cached
    placement decisions (its native sharding cache, its redistribution
    planners and every ``lru_cache`` of ``torch.distributed.tensor``):
    they key a mesh by its layout, not by its groups, so a mesh of a later
    group would otherwise inherit a dead group's mesh and collectives over
    groups that no longer exist, or whose names the new world gives to
    other groups."""
    from torch.distributed.tensor import _redistribute
    if dist.is_initialized():
        dist.destroy_process_group()
    for clear in (getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None),
                  getattr(_redistribute, "clear_redistribute_planner_cache",
                          None)):
        if clear is not None:
            clear()
    for obj in gc.get_objects():
        if type(obj) is functools._lru_cache_wrapper and getattr(
                obj, "__module__", "").startswith("torch.distributed.tensor"):
            obj.cache_clear()


def quiet() -> None:
    """DTensor warns at every redistribution it plans as two steps."""
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)


def cell_plan(arch: str, shape: ShapeConfig, multi_pod: bool, opt: bool):
    """→ (config, parallel plan, mesh plan) of a cell; ``opt`` is the
    reference's ``--opt``: its ``optimized_config`` and plan overrides."""
    cfg = get_config(arch)
    pp = steps_mod.plan_of(arch)
    if opt:
        cfg = dataclasses.replace(cfg, opt_conv_split=True,
                                  opt_bf16_grads=True)
        if arch in OPT_PLAN_OVERRIDES:
            pp = dataclasses.replace(pp,
                                     microbatches=OPT_PLAN_OVERRIDES[arch])
    plan = plan_for(cfg, multi_pod=multi_pod)
    return cfg, pp, plan


def programs(cfg: ModelConfig, shape: ShapeConfig, pp, plan, mesh,
             make: Callable, mb: int = 1) -> Dict[str, tuple]:
    """The cell's step on local shards made by ``make(shape, dtype)``:
    ``{part: (fn, initial trees)}``. A train cell has two parts: ``fb``
    (one microbatch of the batch ``mb`` microbatches deep, forward and
    backward; the grads it leaves are ``apply``'s input) and ``apply``
    (the optimizer update); prefill and decode have one, ``step``."""
    p_sh = shd.param_shardings(mesh, cfg, plan, pp)
    model = shd.local_model(cfg, mesh, p_sh, make)
    b_sh = shd.batch_shardings(mesh, cfg, plan, shape)
    if shape.kind == "train":
        model.requires_grad_(True)
        opt_cfg = AdamWConfig(m_dtype="bfloat16" if pp.fsdp else "float32")
        opt = adamw_init(opt_cfg, dict(model.named_parameters()))
        specs = ispec.train_specs(cfg, shape, mb)
        one = {k: v[:1] for k, v in specs.items()}
        batch = shd.local_tree(one, mesh, b_sh, make)
        held = {}

        def fb():
            held["g"] = steps_mod.accumulate_grads(model, batch)

        def apply():
            grads, loss_sum, n = held.pop("g")
            steps_mod.apply_grads(model, opt, grads, loss_sum, n, opt_cfg,
                                  steps_mod.TrainHyper())

        return {"fb": (fb, (model.state_dict(), opt, batch)),
                "apply": (apply, ())}
    if shape.kind == "prefill":
        batch = shd.local_tree(ispec.prefill_specs(cfg, shape), mesh, b_sh,
                               make)
        step = steps_mod.make_prefill_step(cfg)
        return {"step": (lambda: step(model, batch),
                         (model.state_dict(), batch))}
    specs = ispec.decode_specs(cfg, shape)
    c_sh = shd.cache_shardings(mesh, cfg, plan, pp, shape)
    caches = shd.local_tree(specs["caches"], mesh, c_sh, make)
    tokens = shd.local_dtensor(specs["tokens"], mesh, b_sh["tokens"], make)
    step = steps_mod.make_decode_step(cfg)
    return {"step": (lambda: step(model, caches, tokens, shape.seq_len - 1),
                     (model.state_dict(), caches, tokens))}


def trace(cfg: ModelConfig, shape: ShapeConfig, pp, plan, mesh,
          device_type: str, mb: int, param_rules=None,
          listing=None) -> dict:
    """One trace of the cell at ``cfg``'s depth over fake local shards →
    the op summary of the whole step with ``mb`` microbatches. With a
    ``listing`` list, each part's op lines (``op_analysis.OpCounter``)
    are appended to it after a ``# <part>`` line (``# fb x<mb>``: a
    train step runs that part once a microbatch)."""
    rules = shd.logical_rules(plan, pp)
    with FakeTensorMode(allow_non_fake_inputs=False):
        def make(s, dtype):
            return torch.empty(s, dtype=dtype, device=device_type)

        with steps_mod.sharded(mesh, rules, param_rules):
            parts = programs(cfg, shape, pp, plan, mesh, make, mb)
            sums = {}
            for name, (fn, initial) in parts.items():
                if listing is not None:
                    listing.append(f"# {name}"
                                   + (f" x{mb}" if name == "fb" else ""))
                sums[name] = op_analysis.count(fn, shape.seq_len, initial,
                                               listing)
    if shape.kind != "train":
        return sums["step"]
    # mb × (forward + backward) + one update; the peak is one
    # microbatch's (they run one after another) over the update's
    out = op_analysis.combine((mb, sums["fb"]), (1, sums["apply"]))
    for k in ("peak_bytes", "peak_bytes_flashproj"):
        out[k] = max(sums["fb"][k], sums["apply"][k])
    return out


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                out_dir: Path, opt: bool = False,
                device_type: str = "cpu", save_hlo: bool = False) -> dict:
    """Trace one cell, write its record ``<arch>__<shape>__<mesh>.json``
    into ``out_dir`` and return it; with ``save_hlo`` also
    ``<...>.ops.txt``, rank 0's traced program at the traced depth, one
    line an op (the reference writes its HLO there)."""
    quiet()
    ensure_world(WORLD)
    shape = SHAPES[shape_name]
    cfg, pp, plan = cell_plan(arch, shape, multi_pod, opt)
    mesh = arch_mesh(make_production_mesh(multi_pod=multi_pod,
                                          device_type=device_type), plan)
    dp = shd.data_parallel(plan)
    mb = (ispec.effective_microbatches(pp, shape, dp)
          if shape.kind == "train" else 1)
    param_rules = (shd.tp_only_rules(plan)
                   if (opt and pp.fsdp and shape.kind == "train") else None)
    t0 = time.time()
    G = cfg.group_size
    depth = 2 if cfg.num_groups >= 3 else 1
    listing = [] if save_hlo else None
    at, after = (trace(dataclasses.replace(cfg, num_layers=n * G), shape,
                       pp, plan, mesh, device_type, mb, param_rules,
                       listing if n == depth else None)
                 for n in (depth, depth + 1))
    ana = op_analysis.weighted(at, after, cfg.num_groups, depth)
    t_trace = time.time() - t0
    rec = {
        "arch": arch,
        "variant": "opt" if opt else "baseline",
        "config_name": cfg.name,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
        "plan": {"tp_kv": plan.tp_kv, "tp_g": plan.tp_g, "tp_r": plan.tp_r,
                 "fsdp": pp.fsdp, "fsdp_pod": pp.fsdp_pod,
                 "microbatches": mb},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        # loop-weighted, per device (op_analysis.py)
        "flops": float(ana["dot_flops"]),
        "bytes_accessed_upper": float(ana["hbm_bytes_upper"]),
        "bytes_accessed_flashproj": float(ana["hbm_bytes_flashproj"]),
        "score_bytes": float(ana["score_bytes"]),
        "transcendentals": float(ana["transcendentals"]),
        "collectives": ana["collectives"],
        "group_trips": cfg.num_groups,
        "memory": {"peak_bytes": ana["peak_bytes"],
                   "peak_bytes_flashproj": ana["peak_bytes_flashproj"]},
        "uneven_params": shd.uneven(cfg, plan, pp),
        "trace_s": round(t_trace, 2),
        "ops_traced": ana["ops_traced"],
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{rec['mesh'].replace('x', '_')}"
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
    if save_hlo:
        head = (f"# {arch} {shape_name} mesh={rec['mesh']} depth={depth} "
                f"of {cfg.num_groups} groups: ops={at['ops_traced']} "
                f"dot_flops={at['dot_flops']}")
        (out_dir / f"{name}.ops.txt").write_text(
            "\n".join([head] + listing) + "\n")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--save-hlo", action="store_true",
                    help="write rank 0's traced op listing beside each "
                         "record (<cell>.ops.txt)")
    ap.add_argument("--opt", action="store_true",
                    help="the reference's optimized variant (tuned "
                         "microbatches, per-layer FSDP gathers)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out if not args.opt or args.out != OUT
                   else OUT + "_opt")
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shape_names = ([args.shape] if args.shape else
                       [s.name for s in shapes_for(cfg)])
        for shape_name in shape_names:
            for mp in meshes:
                tag = f"{arch} × {shape_name} × {'2x16x16' if mp else '16x16'}"
                try:
                    rec = dryrun_cell(arch, shape_name, mp, out_dir,
                                      opt=args.opt, save_hlo=args.save_hlo)
                    print(f"[OK] {tag}: flops={rec['flops']:.3e} "
                          f"coll={rec['collectives']['total_bytes']:.3e}B "
                          f"trace={rec['trace_s']}s", flush=True)
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: "
                         + "; ".join(t for t, _ in failures))
    print("all dry-run cells traced")


if __name__ == "__main__":
    main()
