"""The sharded steps on a simulated 2×4 mesh, held against the unsharded
port and the reference.

The reference's ``tests/helpers/dist_train_main.py::run_arch`` at TINY
f32: the arch mesh of a (data=2, model=4) mesh, ``plan_for(model_axis=4)``,
parameters placed by ``param_shardings`` (FSDP for phi3.5-moe), batches by
``batch_shardings``, two train steps of two microbatches, then a decode
step on caches placed by ``cache_shardings`` (batch 8 < 16: the KV
sequence dim is split over ``data``). Eight ranks are simulated in one
process (``LocalTensorMode(8)`` over a fake process group of 8): every
collective really combines the ranks' values, so each result is checked
whole, on every rank.

Losses, grad norms, updated parameters and decode logits equal the
unsharded port's within 1e-5 relative, norm-wise (a sharded contraction
sums in another order; AdamW's eps is 1e-6 on both sides, see ``OPT``),
and the reference's ``loss_fn`` on the same weights within 1e-4."""
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed._local_tensor import LocalTensorMode
from torch.distributed.tensor import DTensor

from repro.configs import get_config as ref_get_config
from repro.models import model as RM
from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod, sharding as shd, steps
from repro_torch.launch.dryrun import ensure_world, leave_world, quiet
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import Model, init_caches
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init, global_norm
from repro_torch.runtime.elastic import remesh_shardings

torch.set_num_threads(2)
SH = ShapeConfig("tiny_train", seq_len=64, global_batch=8, kind="train")
SHD = ShapeConfig("tiny_dec", seq_len=64, global_batch=8, kind="decode")
HYPER = steps.TrainHyper(peak_lr=1e-3, warmup_steps=1, total_steps=100)
RTOL = 1e-5
#: AdamW with eps 1e-6 on both sides: an element whose gradient g is near
#: eps moves by lr·g/(|g| + eps), which multiplies a change of g by up to
#: lr/eps; at the default 1e-8 that turns the 1e-7 relative summation-order
#: noise of a sharded gradient into a 3% change of one embedding element
#: of phi3.5-moe after two steps (1.2e-5 norm-wise); at 1e-6 the factor
#: is 100 times smaller
OPT = AdamWConfig(eps=1e-6)


@pytest.fixture(scope="module")
def world():
    quiet()
    logging.getLogger("torch.distributed._local_tensor").setLevel(
        logging.ERROR)
    ensure_world(8)
    yield
    leave_world()


def _cfg(arch):
    return dataclasses.replace(get_config(arch, tiny=True), dtype="float32")


def _batch(cfg):
    rng = np.random.default_rng(0)
    t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 4, SH.seq_len)),
                        dtype=torch.int32)
    return {"tokens": t, "labels": t.clone()}


def _whole(t):
    """A DTensor's full value, the same on every simulated rank."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return (t.reconcile() if hasattr(t, "reconcile") else t).detach()


def _rel(a, b):
    """‖a − b‖ / ‖b‖ over the lanes that are not padding (-1e30 in both)."""
    a, b = _whole(a).double(), _whole(b).double()
    keep = b.abs() < 1e29
    assert torch.equal(keep, a.abs() < 1e29)
    return float((a - b)[keep].norm() / b[keep].norm().clamp(min=1e-30))


def _mesh(cfg, shape=(2, 4)):
    plan = mesh_mod.plan_for(cfg, model_axis=4)
    base = mesh_mod.small_mesh(shape, ("data", "model"), "cpu")
    return mesh_mod.arch_mesh(base, plan), plan


def _run(cfg, model, sharded=None):
    """Two train steps, then a decode step on fresh caches → (metrics of
    each step, the parameters after them, decode logits)."""
    opt_cfg = OPT
    step = steps.make_train_step(cfg, opt_cfg, HYPER)
    batch = _batch(cfg)
    caches = init_caches(cfg, SHD.global_batch, SHD.seq_len, torch.float32,
                         device="cpu")
    toks = torch.arange(SHD.global_batch, dtype=torch.int32)[:, None]
    if sharded is not None:
        mesh, plan, pp = sharded
        batch = shd.distribute_tree(
            batch, mesh, shd.batch_shardings(mesh, cfg, plan, SH))
        caches = shd.distribute_tree(
            caches, mesh, shd.cache_shardings(mesh, cfg, plan, pp, SHD))
        toks = shd.distribute_tree(
            toks, mesh, shd.placements_from_spec(mesh, ("data", None)))
    opt = adamw_init(opt_cfg, dict(model.named_parameters()))
    _, opt, m1 = step(model, opt, batch)
    _, opt, m2 = step(model, opt, batch)
    logits, _, _ = steps.make_decode_step(cfg)(model, caches, toks, 3)
    return (m1, m2), dict(model.named_parameters()), logits


def _ref_loss(arch, cfg, weights):
    """The reference's loss, averaged over the two microbatches, on the
    port's initial weights."""
    rcfg = dataclasses.replace(ref_get_config(arch, tiny=True),
                               dtype="float32")
    import jax
    params = jax.tree.map(jnp.asarray,
                          convert.params_to_numpy(cfg, weights))
    batch = _batch(cfg)
    losses = [float(RM.loss_fn(params, rcfg, {
        "tokens": jnp.asarray(batch["tokens"][i].numpy()),
        "labels": jnp.asarray(batch["labels"][i].numpy())})[0])
        for i in range(2)]
    return sum(losses) / 2


@pytest.mark.parametrize("arch", ["llama32_3b", "granite_moe_1b",
                                  "phi35_moe_42b", "minicpm3_4b",
                                  "mamba2_2p7b"])
def test_sharded_steps_match_the_unsharded_port_and_the_reference(world,
                                                                  arch):
    cfg = _cfg(arch)
    weights = {k: v.clone() for k, v in
               Model(cfg, device="cpu", seed=0).state_dict().items()}
    plain = Model(cfg, device="cpu")
    plain.load_state_dict(weights)
    plain.requires_grad_(True)
    (p1, p2), p_params, p_logits = _run(cfg, plain)
    model = Model(cfg, device="cpu")
    model.load_state_dict(weights)
    model.requires_grad_(True)
    with LocalTensorMode(8):
        mesh, plan = _mesh(cfg)
        pp = shd.ParallelPlan(fsdp=arch == "phi35_moe_42b", microbatches=2)
        shd.distribute_model(model, mesh,
                             shd.param_shardings(mesh, cfg, plan, pp))
        with steps.sharded(mesh, shd.logical_rules(plan, pp)):
            (s1, s2), s_params, s_logits = _run(cfg, model, (mesh, plan, pp))
        for a, b in ((s1, p1), (s2, p2)):
            for key in ("loss", "grad_norm", "lr"):
                assert _rel(a[key], b[key]) <= RTOL, (key, a[key], b[key])
        for name, p in s_params.items():
            assert isinstance(p, DTensor)
            assert _rel(p, p_params[name]) <= RTOL, name
        assert isinstance(s_logits, DTensor)
        assert _rel(s_logits, p_logits) <= RTOL
        sharded_loss = float(_whole(s1["loss"]))
    assert p2["loss"] < p1["loss"] + (0.5 if "moe" in arch else 0.0)
    ref = _ref_loss(arch, cfg, weights)
    assert abs(sharded_loss - ref) <= 1e-4 * abs(ref)


def test_sharded_prefill_attends_on_local_heads(world):
    """The prefill's flash attention runs on each rank's heads
    (``local_map``; the kernel's plain version on the CPU)."""
    cfg = _cfg("llama32_3b")
    plain = Model(cfg, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)), dtype=torch.int32)
    want, want_caches = steps.make_prefill_step(cfg)(plain,
                                                     {"tokens": toks})
    model = Model(cfg, device="cpu")
    model.load_state_dict(plain.state_dict())
    with LocalTensorMode(8):
        mesh, plan = _mesh(cfg)
        pp = shd.ParallelPlan()
        shd.distribute_model(model, mesh,
                             shd.param_shardings(mesh, cfg, plan, pp))
        t = shd.distribute_tree(toks, mesh,
                                shd.placements_from_spec(mesh, ("data", None)))
        with steps.sharded(mesh, shd.logical_rules(plan, pp)):
            got, caches = steps.make_prefill_step(cfg)(model, {"tokens": t})
        assert _rel(got, want) <= RTOL
        assert _rel(caches[0].k, want_caches[0].k) <= RTOL


def test_global_norm_of_sharded_grads(world):
    torch.manual_seed(0)
    tree = {"a": torch.randn(8, 12), "b": torch.randn(4, 4, 6)}
    cfg = _cfg("llama32_3b")
    with LocalTensorMode(8):
        mesh, _ = _mesh(cfg)
        placed = {"a": shd.distribute_tree(tree["a"], mesh,
                                           shd.placements_from_spec(
                                               mesh, ("data", "tp_kv"))),
                  "b": shd.distribute_tree(tree["b"], mesh,
                                           shd.placements_from_spec(
                                               mesh, (None, None, "tp_g")))}
        with steps.sharded(mesh, {}):
            got = global_norm(placed)
        assert _rel(got, global_norm(tree)) <= 1e-6


def test_elastic_reshard_onto_a_sub_mesh(world, tmp_path):
    """Save on 2×4, restore onto a 1×4 sub-mesh with ``placements=``: the
    same values, on the new placements."""
    cfg = _cfg("llama32_3b")
    pp = shd.ParallelPlan()
    model = Model(cfg, device="cpu", seed=1)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    with LocalTensorMode(8):
        mesh, plan = _mesh(cfg)
        old = shd.param_shardings(mesh, cfg, plan, pp)
        shd.distribute_model(model, mesh, old)
        save_checkpoint(tmp_path, 3, model.state_dict())
    with LocalTensorMode(4):         # the survivors: ranks 0..3
        small, plan2 = _mesh(cfg, (1, 4))
        new = remesh_shardings(old, mesh, small)
        assert new == shd.param_shardings(small, cfg, plan2, pp)
        target = {k: torch.empty_like(v) for k, v in want.items()}
        got, meta = restore_checkpoint(
            tmp_path, target, placements={k: (small, p)
                                          for k, p in new.items()})
        assert meta["step"] == 3
        for k, v in got.items():
            assert isinstance(v, DTensor) and v.device_mesh is small
            assert tuple(v.placements) == new[k]
            assert torch.equal(_whole(v), want[k]), k
