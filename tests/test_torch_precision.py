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
  under the flag.
"""
import dataclasses
import math

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
from repro_torch.launch import dryrun, mesh as mesh_mod, op_analysis
from repro_torch.launch import sharding as shd, steps
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding_hints
from repro_torch.models.config import ShapeConfig

torch.set_num_threads(1)
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


def _rows(arch, kind, opt):
    """All-reduce bytes by type of one step of ``arch`` (TINY bf16; a
    train step with one layer) over fake local shards of a 2×4 mesh."""
    cfg = get_config(arch, tiny=True)
    cfg = dataclasses.replace(cfg, opt_bf16_grads=opt, num_layers=(
        cfg.group_size if kind == "train" else cfg.num_layers))
    plan = mesh_mod.plan_for(cfg, model_axis=4)
    mesh = mesh_mod.arch_mesh(mesh_mod.small_mesh((2, 4), ("data", "model"),
                                                  "cpu"), plan)
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
