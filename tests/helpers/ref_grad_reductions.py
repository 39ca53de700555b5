"""The type in which the reference sums each weight's data-parallel
gradient: its TINY train step (one layer group, two microbatches of 8
sequences of 64 tokens) lowered on a data-only CPU mesh of 8 and
partitioned by XLA's SPMD partitioner; every all-reduce of the backward
pass is printed with its operand type, shape and the reference's op that
made it.

    python tests/helpers/ref_grad_reductions.py CELL [CELL ...]

where a CELL is an architecture id, ``:opt`` after it for
``opt_bf16_grads``, ``:fsdp`` for an FSDP plan (``llama32_3b:opt``),
prints one JSON object: each cell → a list of ``{"dtype", "shape",
"op"}``, in the program's order. The program is read
right after the partitioner (an HLO dump of that pass): XLA's later
passes may widen a bf16 reduction whose result is converted to f32 next
(the gradient accumulator), which on the CPU backend they do. Runs in a
process of its own: the reference's XLA device count is set before JAX
loads.
"""
import os
import sys
import tempfile

DUMP = tempfile.mkdtemp(prefix="ref-grad-reductions-")
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           f"--xla_dump_to={DUMP} "
                           "--xla_dump_hlo_pass_re=spmd-partitioning")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch import sharding as shd, steps  # noqa: E402
from repro.launch.mesh import arch_mesh, plan_for  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models.sharding_hints import use_hints  # noqa: E402
from repro.optim import AdamWConfig  # noqa: E402
from repro.optim.adamw import AdamWState  # noqa: E402

_LINE = re.compile(r"= (\w+)\[([\d,]*)\]\S* all-reduce\("
                   r".*op_name=\"([^\"]*)\"")


def reductions(arch: str, opt: bool, fsdp: bool) -> list:
    cfg = get_config(arch, tiny=True)
    cfg = dataclasses.replace(cfg, num_layers=cfg.group_size,
                              opt_bf16_grads=opt)
    plan = plan_for(cfg, model_axis=1)
    mesh = arch_mesh(jax.make_mesh((8, 1), ("data", "model")), plan)
    pp = shd.ParallelPlan(fsdp=fsdp, microbatches=2)
    with mesh, use_hints(mesh, shd.logical_rules(plan, pp), None):
        p_sh = shd.param_shardings(mesh, cfg, plan, pp)
        rep = NamedSharding(mesh, P())
        tok = jax.ShapeDtypeStruct((2, 8, 64), jnp.int32)
        b_sh = NamedSharding(mesh, P(None, "data", None))
        opt_cfg = AdamWConfig(m_dtype="float32")
        jax.jit(steps.make_train_step(cfg, opt_cfg),
                in_shardings=(p_sh, AdamWState(m=p_sh, v=p_sh, count=rep),
                              {"tokens": b_sh, "labels": b_sh}),
                out_shardings=(p_sh, AdamWState(m=p_sh, v=p_sh, count=rep),
                               {"loss": rep, "grad_norm": rep, "lr": rep})
                ).lower(M.abstract_params(cfg),
                        steps.abstract_opt_state(cfg, opt_cfg),
                        {"tokens": tok, "labels": tok}).compile()
    text = max(Path(DUMP).glob("*train_step*after_spmd-partitioning*"),
               key=lambda f: f.stat().st_mtime_ns)   # this cell's
    out = []
    for dt, shape, op in _LINE.findall(text.read_text()):
        if "transpose(" in op:                    # the backward's
            dims = [int(d) for d in shape.split(",") if d]
            out.append({"dtype": dt, "shape": dims,
                        "op": "/".join(op.split("/")[-2:])})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+")
    args = ap.parse_args()
    try:
        out = {}
        for cell in args.cells:
            arch, *flags = cell.split(":")
            out[cell] = reductions(arch, "opt" in flags, "fsdp" in flags)
        print(json.dumps(out))
    finally:
        shutil.rmtree(DUMP, ignore_errors=True)


if __name__ == "__main__":
    main()
