"""The port's mesh layer against the reference's: ``plan_for`` for every
architecture, ``PLANS``, ``effective_microbatches``, ``plan_mesh_shape``,
and the production meshes (and each parameter's local shard on them)
over a fake process group of 512 ranks on the CPU."""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.launch import input_specs as ref_ispec
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.models.config import SHAPES as REF_SHAPES
from repro.runtime.elastic import plan_mesh_shape as ref_plan_mesh_shape
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, input_specs as ispec
from repro_torch.launch import mesh as mesh_mod, sharding as shd, steps
from repro_torch.models.config import SHAPES
from repro_torch.runtime.elastic import plan_mesh_shape

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    dryrun.quiet()
    dryrun.ensure_world(512)
    yield
    dryrun.leave_world()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_for_matches_the_reference(arch):
    for model_axis in (4, 16):
        for multi_pod in (False, True):
            mine = mesh_mod.plan_for(get_config(arch), multi_pod=multi_pod,
                                     model_axis=model_axis)
            ref = ref_mesh.plan_for(ref_get_config(arch),
                                    multi_pod=multi_pod,
                                    model_axis=model_axis)
            assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
            for prop in ("batch_axes", "tp_axes", "heads_axes", "attn_tp"):
                assert getattr(mine, prop) == getattr(ref, prop)


def test_plans_and_microbatches_match_the_reference():
    assert set(steps.PLANS) == set(ref_steps.PLANS)
    for arch in ARCH_IDS + ["unknown"]:
        mine, ref = steps.plan_of(arch), ref_steps.plan_of(arch)
        assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
        for name, shape in SHAPES.items():
            for dp in (1, 2, 16, 32):
                assert ispec.effective_microbatches(mine, shape, dp) == \
                    ref_ispec.effective_microbatches(ref, REF_SHAPES[name],
                                                     dp)


def test_plan_mesh_shape_matches_the_reference():
    assert plan_mesh_shape(256, 16, 256) == (16, 16)
    d, m = plan_mesh_shape(240, 16, 256)
    assert d * m <= 240 and 256 % d == 0
    with pytest.raises(ValueError):
        plan_mesh_shape(8, 16, 256)
    for avail in (16, 17, 100, 240, 255, 256, 512):
        for batch in (1, 7, 128, 256):
            assert plan_mesh_shape(avail, 16, batch) == \
                ref_plan_mesh_shape(avail, 16, batch)


def test_production_and_arch_meshes(world):
    base = mesh_mod.make_production_mesh(device_type="cpu")
    assert base.mesh_dim_names == ("data", "model")
    assert tuple(base.mesh.shape) == (16, 16)
    pods = mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
    assert pods.mesh_dim_names == ("pod", "data", "model")
    for arch in ARCH_IDS:
        plan = mesh_mod.plan_for(get_config(arch))
        mesh = mesh_mod.arch_mesh(base, plan)
        full = base.mesh.reshape(16, plan.tp_kv, plan.tp_g, plan.tp_r)
        kept = [n for n, k in zip(("tp_kv", "tp_g", "tp_r"),
                                  (plan.tp_kv, plan.tp_g, plan.tp_r)) if k > 1]
        # the same ranks in the same order; size-1 sub-dims left out
        assert mesh.mesh_dim_names == ("data", *kept)
        assert torch.equal(mesh.mesh.flatten(), full.flatten())
        assert mesh.size() == 256


def test_spec_axes_must_follow_the_mesh_order(world):
    mesh = mesh_mod.arch_mesh(mesh_mod.make_production_mesh(
        device_type="cpu"), mesh_mod.plan_for(get_config("granite_moe_1b")))
    assert shd.placements_from_spec(mesh, (None, ("tp_kv", "tp_g"))) == \
        (Replicate(), Shard(1), Shard(1))
    # tp_r has size 1 in granite's plan: it splits nothing
    assert shd.placements_from_spec(mesh, ("data", ("tp_kv", "tp_r"))) == \
        (Shard(0), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements_from_spec(mesh, (("tp_g", "tp_kv"),))
    with pytest.raises(ValueError, match="not a dim"):
        shd.placements_from_spec(mesh, ("model",))


@pytest.mark.parametrize("arch", ["llama32_3b", "granite_moe_1b",
                                  "minicpm3_4b", "nemotron4_340b",
                                  "mamba2_2p7b"])
def test_local_shards_on_the_production_mesh(world, arch):
    """Every parameter's local shard on rank 0 of 16×16: the spec's
    division wherever its mesh dims divide the dim (DTensor's ceil-sized
    chunk elsewhere, which ``uneven`` lists)."""
    cfg = get_config(arch)
    plan = mesh_mod.plan_for(cfg)
    pp = steps.plan_of(arch)
    mesh = mesh_mod.arch_mesh(mesh_mod.make_production_mesh(
        device_type="cpu"), plan)
    sizes = {"data": 16, "tp_kv": plan.tp_kv, "tp_g": plan.tp_g,
             "tp_r": plan.tp_r}
    specs = shd.param_specs(cfg, plan, pp)
    uneven = {(u["param"], u["dim"]) for u in shd.uneven(cfg, plan, pp)}
    with FakeTensorMode():
        model = shd.local_model(
            cfg, mesh, shd.param_shardings(mesh, cfg, plan, pp),
            lambda s, dt: torch.empty(s, dtype=dt))
        for name, p in model.named_parameters():
            local = tuple(p.to_local().shape)
            assert local == shd.local_shape(p.shape, specs[name], sizes)
            for d, entry in enumerate(specs[name]):
                if entry is None:
                    assert local[d] == p.shape[d]
                    continue
                ways = 1
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    ways *= sizes[a]
                if (name, d) not in uneven:
                    assert local[d] * ways == p.shape[d], (name, d)
