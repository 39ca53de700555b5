"""The port's products in bf16 against the reference's f32 accumulation,
unsharded and sharded, and ``opt_bf16_grads``.

The reference gives each product a result type
(``preferred_element_type``): the FFN's gate / up / in and the logits
keep an f32 result; ``wo``, ``w_down`` and the SSM's ``w_out`` sum in
f32 and cast after, which GSPMD does for a row-parallel product by
all-reducing the f32 partial sums; ``opt_bf16_grads`` takes those three
in bf16 (``gqa_full``'s ``wo`` only: the decode, packed, chunk and MLA
modes keep f32).

* TINY models in their own type (bf16), the reference's weights carried
  over by ``convert.params_from_numpy``, one seeded batch: logits within
  1e-2 of the reference's ``forward_train``, norm-wise, and the greedy
  argmax equal at every position (granite: wherever the reference's two
  top logits are further apart than the port's logit error at that
  position; a closer pair is a tie at this precision);
* ``layers.matmul_rows`` on a simulated 2×4 mesh in bf16: bit for bit
  the f32 product rounded once;
* ``opt_bf16_grads`` in bf16: the loss within 1e-4 and each gradient
  within 5e-2 (norm-wise) of ``jax.grad`` of the reference's
  ``loss_fn``;
* the op counter's collective bytes by type on a fake 2×4 mesh: the
  row-parallel all-reduces are f32, and bf16 for the three products
  under the flag;
* each weight's data-parallel gradient summed in the reference's type
  (``PERF.md`` §3; the types read from the reference's own partitioned
  train steps): a product weight's and a norm scale's bit for bit
  the f32 sum rounded once on the simulated 2×4 mesh, a ``pet``
  product's under the flag the bf16 sum; on a data-only mesh of 2 the
  backward's reductions come to exactly 4 bytes an element of the
  weights summed in f32 and 2 of those summed in bf16, for the
  all-reduce of a replicated plan and the reduce-scatter of an FSDP one;
* building a ``Model`` clears cuBLAS's reduced-precision bf16 split-K
  reductions.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._local_tensor import LocalTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, input_specs, mesh as mesh_mod
from repro_torch.launch import op_analysis, sharding as shd, steps
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding_hints
from repro_torch.models.config import ShapeConfig

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
B, S = 2, 64
LOGITS_RTOL = 1e-2


@pytest.fixture(scope="module")
def world():
    dryrun.quiet()
    dryrun.ensure_world(8)
    yield
    dryrun.leave_world()


def _pair(arch, **kw):
    """The reference's TINY params (bf16) and the port's model on them."""
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), **kw)
    cfg = dataclasses.replace(get_config(arch, tiny=True), **kw)
    assert cfg.dtype == "bfloat16"
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _tokens(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch,strict", [("llama32_3b", True),
                                         ("starcoder2_7b", True),
                                         ("granite_moe_1b", False),
                                         ("mamba2_2p7b", True)])
def test_bf16_greedy_argmax_matches_reference(arch, strict):
    rcfg, params, cfg, model = _pair(arch)
    toks = _tokens(cfg, 0)
    lj = np.asarray(RM.forward_train(params, rcfg,
                                     {"tokens": jnp.asarray(toks)})[0],
                    np.float32)
    with torch.no_grad():
        lt = model.forward_train({"tokens": torch.from_numpy(toks)})[0]
    assert lt.dtype == torch.float32
    lt = lt.numpy()
    keep = np.abs(lj) < 1e29
    assert np.array_equal(keep, np.abs(lt) < 1e29)
    gap = np.linalg.norm((lt - lj)[keep]) / np.linalg.norm(lj[keep])
    assert gap <= LOGITS_RTOL, gap
    differ = lt.argmax(-1) != lj.argmax(-1)
    if not strict:
        top2 = np.sort(lj, -1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        err = np.where(keep, np.abs(lt - lj), 0).max(-1)
        differ &= margin > err
    assert not differ.any(), np.argwhere(differ).tolist()


@pytest.mark.parametrize("layout", ["2d", "3d"])
def test_row_parallel_sums_partials_in_f32(world, layout):
    """A bf16 product whose contracted dim is split 4 ways over ``model``:
    the partials are summed in f32 and rounded once, bit for bit the
    unsharded f32 product rounded; under ``reduce_f32=False`` (the
    reference's ``preferred_element_type=None``) they are summed in
    bf16, which differs."""
    rng = np.random.default_rng(1)
    if layout == "2d":
        x = rng.standard_normal((16, 256))
        w = rng.standard_normal((256, 64)) / 16
        xd, wd = 1, 0
    else:                                   # wo: bshk,hkd->bsd
        x = rng.standard_normal((2, 8, 8, 32))
        w = rng.standard_normal((8, 32, 64)) / 16
        xd, wd = 2, 0
    x = torch.from_numpy(x).to(torch.bfloat16)
    w = torch.from_numpy(w).to(torch.bfloat16)
    k = w.ndim - 1
    want = torch.matmul(x.reshape(*x.shape[:x.ndim - k], -1).float(),
                        w.reshape(-1, w.shape[-1]).float()).bfloat16()
    with LocalTensorMode(8):
        mesh = mesh_mod.small_mesh((2, 4), ("data", "model"), "cpu")
        xs = shd.distribute_tree(x, mesh, (Replicate(), Shard(xd)))
        ws = shd.distribute_tree(w, mesh, (Replicate(), Shard(wd)))
        got = L.matmul_rows(xs, ws).full_tensor().reconcile()
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want), int((got != want).sum())
        bf16_sum = L.matmul_rows(xs, ws, reduce_f32=False)
        bf16_sum = bf16_sum.full_tensor().reconcile()
    assert int((bf16_sum != want).sum()) > 0


@pytest.mark.parametrize("arch", ["llama32_3b", "granite_moe_1b",
                                  "mamba2_2p7b"])
def test_opt_bf16_grads_loss_and_grads_match_reference(arch):
    rcfg, params, cfg, model = _pair(arch, opt_bf16_grads=True)
    model.requires_grad_(True)
    rng = np.random.default_rng(5)
    toks = _tokens(cfg, 5)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    (loss_j, _), gj = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        params, rcfg, {"tokens": jnp.asarray(toks),
                       "labels": jnp.asarray(labels)})
    loss_t, _ = model.loss_fn({"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss_t, [p for _, p in
                                         model.named_parameters()])
    ref = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, gj))
    for n, g, p in zip(names, grads, model.parameters()):
        assert g.dtype == p.dtype, n
        a, r = g.double(), ref[n].double()
        rel = float((a - r).norm() / r.norm().clamp(min=1e-30))
        assert rel <= 5e-2, (n, rel)


def _cell(arch, kind, opt, model_axis=4):
    """TINY bf16 ``arch`` (a train step with one layer group), its plan
    and its mesh of 2 data ranks × ``model_axis``."""
    cfg = get_config(arch, tiny=True)
    cfg = dataclasses.replace(cfg, opt_bf16_grads=opt, num_layers=(
        cfg.group_size if kind == "train" else cfg.num_layers))
    plan = mesh_mod.plan_for(cfg, model_axis=model_axis)
    mesh = mesh_mod.arch_mesh(mesh_mod.small_mesh(
        (2, model_axis), ("data", "model"), "cpu"), plan)
    return cfg, plan, mesh


def _rows(arch, kind, opt):
    """All-reduce bytes by type of one step of ``arch`` (TINY bf16; a
    train step with one layer) over fake local shards of a 2×4 mesh."""
    cfg, plan, mesh = _cell(arch, kind, opt)
    shape = ShapeConfig("tiny_" + kind, 64, 8, kind)
    pp = shd.ParallelPlan(microbatches=2)
    with FakeTensorMode(allow_non_fake_inputs=False), steps.sharded(
            mesh, shd.logical_rules(plan, pp)):
        parts = dryrun.programs(cfg, shape, pp, plan, mesh,
                                lambda s, dt: torch.empty(s, dtype=dt), 2)
        # a train step's forward and backward (the update is elementwise)
        fn, initial = parts["fb" if kind == "train" else "step"]
        rec = op_analysis.count(fn, shape.seq_len, initial)
    # a (batch, seq, d) activation's local size, as the model's hints
    # place it
    act = (8, 1 if kind == "decode" else 64, cfg.d_model)
    pl = sharding_hints.fitting(act, mesh, sharding_hints.placements_for(
        mesh, shd.logical_rules(plan, pp), ("batch", None, None)))
    ways = math.prod(mesh.size(i) for i, p in enumerate(pl)
                     if p == Shard(0))
    # DTensor sums a partial over its mesh dims one dim at a time: a
    # reduction over every model dim of the mesh moves the activation
    # once a dim
    dims = len(mesh.mesh_dim_names) - 1
    return (cfg, math.prod(act) // ways * dims,
            rec["collectives"]["all-reduce"]["by_dtype"])


@pytest.mark.parametrize("arch,kind,switched", [
    ("llama32_3b", "prefill", 2),     # gqa_full's wo, FFN w_down
    ("llama32_3b", "decode", 1),      # FFN w_down; the decode wo stays f32
    ("minicpm3_4b", "prefill", 1),    # FFN w_down; the MLA wo stays f32
    ("mamba2_2p7b", "prefill", 1),    # the SSM's w_out
    ("llama32_3b", "train", None)])
def test_op_counter_shows_the_row_reductions_by_dtype(world, arch, kind,
                                                      switched):
    """The flag turns ``switched`` row-parallel reductions a layer, each
    of the (local batch, seq, d) activation over every model dim of the
    mesh, from f32 to bf16 and changes no other; in a train step it also
    takes the backward's reductions of those mixers' inputs in bf16."""
    cfg, act, base = _rows(arch, kind, False)
    _, _, opt = _rows(arch, kind, True)
    f32 = base.get("float32", 0) - opt.get("float32", 0)
    bf16 = opt.get("bfloat16", 0) - base.get("bfloat16", 0)
    if switched is None:
        assert f32 > 0 and bf16 > 0 and base.get("float32", 0) > 0
        return
    n = switched * cfg.num_layers
    assert f32 == n * act * 4, (base, opt)
    assert bf16 == n * act * 2, (base, opt)


def _sharded_grad(fn, x, w, xp, wp, c):
    """The gradient of ``sum(fn(x, w) · c)`` by w, x and w placed at
    ``xp`` / ``wp`` on the simulated 2×4 mesh, as one whole tensor."""
    with LocalTensorMode(8):
        mesh = mesh_mod.small_mesh((2, 4), ("data", "model"), "cpu")
        xs = shd.distribute_tree(x, mesh, xp)
        ws = shd.distribute_tree(w, mesh, wp).requires_grad_(True)
        y = fn(xs, ws)
        cs = shd.distribute_tree(c, mesh, tuple(y.placements))
        (g,) = torch.autograd.grad((y.float() * cs).sum(), [ws])
        assert g.dtype == w.dtype
        return g.full_tensor().reconcile()


@pytest.mark.parametrize("layout", ["2d", "3d"])
def test_weight_grad_sums_partials_in_f32(world, layout):
    """A bf16 product weight, whole over ``data`` where x is split: its
    gradient is each data rank's f32 product ``x.float().t() @
    g.float()`` over its rows, the two summed in f32 and rounded once,
    bit for bit (the reference's transpose of an f32-result einsum, whose
    partials GSPMD sums before the cast; the whole product summed in
    another order can differ by one f32 rounding, which moves a lane
    that lies on a bf16 rounding boundary); a ``pet`` product under
    ``opt_bf16_grads`` (``reduce_f32=False``) sums the ranks' bf16
    partials, which differs. 2-D: x's rows split over ``data``, w's
    columns over ``model`` (column-parallel); 3-D: ``wo``, the heads
    split over ``model`` (row-parallel)."""
    rng = np.random.default_rng(7)
    if layout == "2d":
        x = rng.standard_normal((32, 64))
        w = rng.standard_normal((64, 48)) / 8
        xp, wp = (Shard(0), Replicate()), (Replicate(), Shard(1))
        f32 = L.matmul_f32
    else:                                   # wo: bshk,hkd->bsd
        x = rng.standard_normal((4, 8, 8, 16))
        w = rng.standard_normal((8, 16, 64)) / 8
        xp, wp = (Shard(0), Shard(2)), (Replicate(), Shard(0))
        f32 = L.matmul_rows
    x = torch.from_numpy(x).to(torch.bfloat16)
    w = torch.from_numpy(w).to(torch.bfloat16)
    rows = x.reshape(-1, math.prod(w.shape[:-1]) if layout == "3d"
                     else w.shape[0])
    # a cotangent of bf16 values: the backward rounds it to w's type
    c = torch.from_numpy(rng.standard_normal(
        (*x.shape[:x.ndim - (w.ndim - 1)], w.shape[-1]) if layout == "3d"
        else (x.shape[0], w.shape[1]))).to(torch.bfloat16).float()
    halves = zip(rows.float().chunk(2), c.reshape(rows.shape[0], -1)
                 .chunk(2))
    want = sum(a.t() @ b for a, b in halves).bfloat16().reshape(w.shape)
    got = _sharded_grad(f32, x, w, xp, wp, c)
    assert torch.equal(got, want), int((got != want).sum())
    pet = _sharded_grad(lambda a, b: L.matmul_rows(a, b, reduce_f32=False),
                        x, w, xp, wp, c)
    assert int((pet != want).sum()) > 0


def test_norm_scale_grad_sums_partials_in_f32(world):
    """A norm scale (the reference widens it, ``layers.py:57``), whole
    on the simulated 2×4 mesh over a batch split over ``data``: its
    gradient is the f32 sum over the whole batch (each data rank's f32
    sum, the two added in f32) rounded once."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((8, 16, 64))).bfloat16()
    scale = torch.from_numpy(1 + rng.standard_normal(64) / 4).bfloat16()
    c = torch.from_numpy(rng.standard_normal((8, 16, 64))).bfloat16().float()
    s32 = scale.float().requires_grad_(True)
    want = sum(torch.autograd.grad((L.rmsnorm(s32, a, 1e-5).float() * b)
                                   .sum(), [s32])[0]
               for a, b in zip(x.chunk(2), c.chunk(2)))
    got = _sharded_grad(lambda a, b: L.rmsnorm(b, a, 1e-5), x, scale,
                        (Shard(0), Replicate()), (Replicate(), Replicate()),
                        c)
    assert torch.equal(got, want.bfloat16()), int((got != want).sum())


def _summed_in(cfg, params):
    """The elements of each weight's gradient by the type the reference
    sums its data-parallel partials in (``PERF.md`` §3): the weight's own
    type for its bf16 products (the MoE experts, the ``pet`` products
    under ``opt_bf16_grads``), the embedding's gather and the SSM's conv;
    f32 for the rest. A tied table counts in both (its gather and its
    logits product are summed apart)."""
    pet = (("mixer.wo",) if cfg.attn_type != "mla" else ()) + (
        "ffn.w_down", "mixer.w_out")
    out = {"float32": 0, "bfloat16": 0}
    for n, p in params.items():
        own = p.dtype == torch.bfloat16 and (
            (".ffn.w_" in n and p.ndim == 3) or n == "embed.tokens"
            or n.endswith(("conv_w", "conv_b"))
            or (cfg.opt_bf16_grads and n.endswith(pet)
                and not (n.endswith("ffn.w_down") and p.ndim == 3)))
        out["bfloat16" if own else "float32"] += p.numel()
    if cfg.tie_embeddings:
        out["float32"] += params["embed.tokens"].numel()
    return out


def test_weight_grad_types_are_the_reference_programs(tmp_path):
    """The types :func:`_summed_in` gives each weight's gradient sum are
    the reference's own: its TINY train steps (llama32 with and without
    ``opt_bf16_grads``, granite's MoE, mamba2's SSM), lowered on a
    data-only CPU mesh of 8 in a process of its own and read right after
    XLA's SPMD partitioner (``tests/helpers/ref_grad_reductions.py``),
    all-reduce exactly as many elements in f32 and in bf16 in their
    backward (the forward's expert counts, recomputed there, left out)."""
    cells = ["llama32_3b", "llama32_3b:opt", "granite_moe_1b",
             "mamba2_2p7b"]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "tests/helpers/ref_grad_reductions.py"),
         *cells], capture_output=True, text=True, env=env, timeout=600,
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.splitlines()[-1])
    for cell in cells:
        arch, *flags = cell.split(":")
        cfg = get_config(arch, tiny=True)
        cfg = dataclasses.replace(cfg, num_layers=cfg.group_size,
                                  opt_bf16_grads="opt" in flags)
        params = dict(M.Model(cfg, device="meta").named_parameters())
        got = {"float32": 0, "bfloat16": 0}
        for r in ref[cell]:
            if "rematted" not in r["op"]:
                dt = {"f32": "float32", "bf16": "bfloat16"}[r["dtype"]]
                got[dt] += math.prod(r["shape"])
        assert got == _summed_in(cfg, params), (cell, ref[cell])


@pytest.mark.parametrize("arch,opt,fsdp", [
    ("llama32_3b", False, False), ("llama32_3b", True, False),
    ("granite_moe_1b", False, False), ("phi35_moe_42b", False, True),
    ("phi35_moe_42b", True, True)])
def test_op_counter_sums_weight_grads_in_the_reference_type(world, arch,
                                                            opt, fsdp):
    """On a data-only mesh of 2 every reduction of a train step's
    backward is a weight gradient's: over 2 microbatches of a batch split
    over ``data`` (fake local shards, one layer group), the backward and
    the accumulation (``steps.add_grads``) reduce exactly 4 bytes an
    element of the weights the reference sums in f32 and 2 of those it
    sums in bf16, a microbatch; as all-reduces in a replicated plan, as
    reduce-scatters onto the shards of an FSDP one, also where ``--opt``
    re-gathers each group's weights (the dry-run's ``param_rules``)."""
    cfg, plan, mesh = _cell(arch, "train", opt, model_axis=1)
    shape = ShapeConfig("tiny_train", 64, 32, "train")
    pp = shd.ParallelPlan(fsdp=fsdp, microbatches=2)
    kind = "reduce-scatter" if fsdp else "all-reduce"
    counter = op_analysis.OpCounter()
    with FakeTensorMode(allow_non_fake_inputs=False), steps.sharded(
            mesh, shd.logical_rules(plan, pp),
            shd.tp_only_rules(plan) if opt and fsdp else None):
        def make(s, dt):
            return torch.empty(s, dtype=dt)
        model = shd.local_model(cfg, mesh, shd.param_shardings(
            mesh, cfg, plan, pp), make)
        model.requires_grad_(True)
        batch = shd.local_tree(input_specs.train_specs(cfg, shape, 2), mesh,
                               shd.batch_shardings(mesh, cfg, plan, shape),
                               make)
        params = dict(model.named_parameters())
        gsum = {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}
        for i in range(2):
            loss, _ = model.loss_fn({k: v[i] for k, v in batch.items()},
                                    remat=False)
            with counter:
                steps.add_grads(gsum, params, loss)
    got = counter.summary()["collectives"]
    elems = _summed_in(cfg, params)
    want = {"float32": 4 * elems["float32"] * 2,
            "bfloat16": 2 * elems["bfloat16"] * 2}
    assert got[kind]["by_dtype"] == want, (got, want)
    other = "all-reduce" if fsdp else "reduce-scatter"
    assert got[other]["count"] == 0, got


def test_model_clears_reduced_precision_bf16_reductions():
    """A bf16 product rounds its f32 sum once: building a model clears
    cuBLAS's split-K reductions in bf16 for the whole process."""
    flag = torch.backends.cuda.matmul
    was = flag.allow_bf16_reduced_precision_reduction
    try:
        flag.allow_bf16_reduced_precision_reduction = True
        M.Model(get_config("llama32_3b", tiny=True), device="cpu")
        assert flag.allow_bf16_reduced_precision_reduction is False
    finally:
        flag.allow_bf16_reduced_precision_reduction = was


def test_model_clears_reduced_precision_fp16_reductions():
    """An f16 product rounds its f32 sum once, as a bf16 one does:
    building a model (of any type) clears cuBLAS's split-K reductions in
    f16 too."""
    flag = torch.backends.cuda.matmul
    was = flag.allow_fp16_reduced_precision_reduction
    try:
        flag.allow_fp16_reduced_precision_reduction = True
        M.Model(dataclasses.replace(get_config("llama32_3b", tiny=True),
                                    dtype="float16"), device="cpu")
        assert flag.allow_fp16_reduced_precision_reduction is False
    finally:
        flag.allow_fp16_reduced_precision_reduction = was
