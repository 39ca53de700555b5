"""The port's sharding rules against the reference's, at full width:
every parameter's spec for each ``PLANS`` entry on both production
meshes, the cache and batch specs of every shape, the input stand-ins and
the AdamW state's shapes and dtypes; ``uneven``; ``remesh_shardings``.

The reference's trees line up with the port's names through
``convert.params_from_numpy``: each reference leaf is replaced by an
array holding its index (stacked over the groups), and the converted
state_dict maps every port name to its reference leaf."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.launch import input_specs as ref_ispec
from repro.launch import mesh as ref_mesh
from repro.launch import sharding as ref_shd
from repro.launch import steps as ref_steps
from repro.models import model as RM
from repro.models.config import shapes_for as ref_shapes_for
from repro.optim import AdamWConfig as RefAdamWConfig
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import mesh as mesh_mod, sharding as shd, steps
from repro_torch.models import model as M
from repro_torch.models.config import shapes_for
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.elastic import remesh_shardings

torch.set_num_threads(1)


def _norm(spec) -> tuple:
    """A reference PartitionSpec as the port writes it: one entry a dim,
    a single mesh dim by its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _by_port_name(cfg, ref_tree, is_leaf):
    """Reference leaves (a tree shaped like its params) keyed by the
    port's state_dict names, the group stack's leading entry dropped."""
    leaves, treedef = jax.tree.flatten(ref_tree, is_leaf=is_leaf)
    ids = jax.tree.unflatten(treedef, list(range(len(leaves))))
    ids = {"embed": jax.tree.map(np.int64, ids["embed"]),
           "final_norm": jax.tree.map(np.int64, ids["final_norm"]),
           "groups": [jax.tree.map(lambda i: np.full((cfg.num_groups,), i),
                                   g) for g in ids["groups"]]}
    sd = convert.params_from_numpy(cfg, ids)
    return {k: leaves[int(v.reshape(-1)[0])] for k, v in sd.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    pp = steps.plan_of(arch)
    rpp = ref_steps.plan_of(arch)
    shapes = M.abstract_params(cfg)
    for multi_pod in (False, True):
        plan = mesh_mod.plan_for(cfg, multi_pod=multi_pod)
        rplan = ref_mesh.plan_for(rcfg, multi_pod=multi_pod)
        for fsdp_off in (False, True):
            rules = (shd.tp_only_rules(plan) if fsdp_off
                     else shd.logical_rules(plan, pp))
            rrules = (ref_shd.tp_only_rules(rplan) if fsdp_off
                      else ref_shd.logical_rules(rplan, rpp))
            assert rules == rrules
            ref_specs = ref_shd.tree_specs(RM.param_axes(rcfg), rrules)
            ref = _by_port_name(
                cfg, ref_specs,
                lambda s: isinstance(s, jax.sharding.PartitionSpec))
            mine = shd.tree_specs(M.param_axes(cfg), rules)
            assert set(mine) == set(ref)
            for name, spec in mine.items():
                want = _norm(ref[name])
                want = want[1:] if name.startswith("layers.") else want
                assert spec == want, (name, spec, want)
                assert len(spec) == shapes[name].ndim


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    pp, rpp = steps.plan_of(arch), ref_steps.plan_of(arch)
    for multi_pod in (False, True):
        plan = mesh_mod.plan_for(cfg, multi_pod=multi_pod)
        rplan = ref_mesh.plan_for(rcfg, multi_pod=multi_pod)
        for shape, rshape in zip(shapes_for(cfg), ref_shapes_for(rcfg)):
            assert shape == type(shape)(**rshape.__dict__)
            rc = ref_shd.tree_specs(
                RM.cache_axes(rcfg),
                _cache_rules(ref_shd, rplan, rpp, rshape))
            mine = shd.cache_specs(cfg, plan, pp, shape)
            assert len(mine) == len(rc)
            for m, r in zip(mine, rc):
                assert type(m)._fields == type(r)._fields
                assert tuple(m) == tuple(_norm(s) for s in r)
            rb = _batch_specs(ref_shd, rcfg, rplan, rshape)
            assert shd.batch_specs(cfg, plan, shape) == rb


def _cache_rules(ref_shd, rplan, rpp, rshape):
    """The rules the reference's ``cache_shardings`` applies."""
    rules = dict(ref_shd.logical_rules(rplan, rpp))
    rules["embed"] = None
    dp = (2 if rplan.multi_pod else 1) * 16
    if rshape.kind == "decode" and rshape.global_batch < dp:
        rules["batch"] = None
        if rpp.seq_shard_decode:
            rules["seq"] = ("data",)
    return rules


def _batch_specs(ref_shd, rcfg, rplan, rshape):
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:1]).reshape((1,) * (
            3 if rplan.multi_pod else 2)),
        ("pod", "data", "model") if rplan.multi_pod else ("data", "model"))
    out = ref_shd.batch_shardings(mesh, rcfg, rplan, rshape)
    return {k: _norm(v.spec) for k, v in out.items()}


def _meta_of(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _struct_of(x):
    return tuple(x.shape), str(jnp.dtype(x.dtype))


@pytest.mark.parametrize("arch", ["llama32_3b", "minicpm3_4b",
                                  "mamba2_2p7b", "jamba15_large_398b",
                                  "llava_next_mistral_7b",
                                  "granite_moe_1b"])
def test_input_specs_and_opt_state_match_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    pp = steps.plan_of(arch)
    for shape, rshape in zip(shapes_for(cfg), ref_shapes_for(rcfg)):
        mb = ispec.effective_microbatches(pp, shape, 16)
        mine = ispec.input_specs(cfg, shape, mb)
        ref = ref_ispec.input_specs(rcfg, rshape, mb)
        assert set(mine) == set(ref)
        for k in mine:
            if k == "caches":
                for m, r in zip(mine[k], ref[k]):
                    assert [_meta_of(t) for t in m] == \
                        [_struct_of(t) for t in r]
            else:
                assert _meta_of(mine[k]) == _struct_of(ref[k])
                assert mine[k].device.type == "meta"
    for m_dtype in ("float32", "bfloat16"):
        opt = steps.abstract_opt_state(cfg, AdamWConfig(m_dtype=m_dtype))
        ref = ref_steps.abstract_opt_state(rcfg,
                                           RefAdamWConfig(m_dtype=m_dtype))
        assert _meta_of(opt.count) == _struct_of(ref.count)
        for field in ("m", "v"):
            rleaves = _by_port_name(cfg, getattr(ref, field),
                                       lambda x: hasattr(x, "shape"))
            for name, t in getattr(opt, field).items():
                shape, dtype = _struct_of(rleaves[name])
                if name.startswith("layers."):
                    shape = shape[1:]
                assert _meta_of(t) == (shape, dtype), name


def test_uneven_dims_are_listed():
    """Every parameter whose split dim its mesh dims do not divide, at
    full width, on 16×16 and 2×16×16: there is none."""
    found = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for multi_pod in (False, True):
            plan = mesh_mod.plan_for(cfg, multi_pod=multi_pod)
            got = shd.uneven(cfg, plan, steps.plan_of(arch))
            for u in got:
                assert u["size"] % u["ways"] != 0
                found.setdefault(arch, set()).add(
                    (u["param"].split(".", 2)[-1], u["dim"], u["size"],
                     u["ways"]))
    # every split dim divides at production size (vocabularies are padded
    # to 256, head counts factor through plan_for): DTensor's chunks are
    # GSPMD's shards everywhere
    assert found == {}


def test_remesh_keeps_the_specs_by_dim_name():
    from torch.distributed.device_mesh import DeviceMesh  # noqa: F401

    class _Mesh:
        def __init__(self, names):
            self.mesh_dim_names = names

    old = _Mesh(("data", "tp_kv", "tp_g"))
    new = _Mesh(("tp_kv", "tp_g"))
    tree = {"a": (Shard(0), Shard(1), Replicate()),
            "b": [(Replicate(), Replicate(), Shard(2))]}
    got = remesh_shardings(tree, old, new)
    assert got == {"a": (Shard(1), Replicate()),
                   "b": [(Replicate(), Shard(2))]}
