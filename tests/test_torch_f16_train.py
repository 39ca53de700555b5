"""Float16 training state in the port against the reference, on the CPU.

* ``loss_fn`` and every parameter's gradient of TINY llama32, minicpm3,
  granite-moe, mamba2 and starcoder2 (window 8) in f16, the port carrying
  the reference's weights, against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` on one seeded batch with masked labels: the
  loss within 1e-3 relative, each gradient in its parameter's type and
  within ``GRAD_TOL`` of the reference's, norm-wise (both sides round
  each f16 product once from its f32 sum; the gaps of
  ``tests/test_torch_f16.py`` feed the backward too; ``SSM_GRAD_TOL``
  for the SSM stack);
* ``adamw_update`` with f16 first and second moments on f16 parameters
  against the reference's (``jnp.dtype("float16")`` moments), three
  steps: within one f16 rounding (2**-11 relative);
* f16 parameters and moments through ``convert`` and the checkpoint
  layer, both ways between the packages: bit for bit (f16 is native to
  numpy: it is stored as it is, under its own name)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import save_checkpoint as rsave
from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro.optim.adamw import AdamWConfig as RAdamWConfig
from repro.optim.adamw import adamw_init as radamw_init
from repro.optim.adamw import adamw_update as radamw_update
from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

torch.set_num_threads(1)
F16 = "float16"
B, S = 2, 32
#: largest |g_port - g_ref| / |g_ref| (Frobenius norms) of a parameter;
#: measured up to 1.7e-3 (``tests/helpers/f16_gaps.py``). The SSM stack
#: 3e-2: there the reference's own jitted gradients differ from its eager
#: ones by 2.0e-2 (its fused scan rounds otherwise), the port's from the
#: jitted ones by 1.8e-2
GRAD_TOL = 1e-2
SSM_GRAD_TOL = 3e-2
ARCHS = {"llama32_3b": {}, "minicpm3_4b": {}, "granite_moe_1b": {},
         "mamba2_2p7b": {}, "starcoder2_7b": {"sliding_window": 8}}


def _pair(arch, **kw):
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype=F16, **kw)
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype=F16, **kw)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_reference(arch):
    rcfg, params, cfg, model = _pair(arch, **ARCHS[arch])
    model.requires_grad_(True)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    (loss_j, _), gj = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        params, rcfg, {"tokens": jnp.asarray(toks),
                       "labels": jnp.asarray(labels)})
    loss_t, _ = model.loss_fn({"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    assert loss_t.dtype == torch.float32
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-3)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss_t, [p for _, p in
                                         model.named_parameters()])
    ref = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, gj))
    assert set(ref) == set(names)
    tol = SSM_GRAD_TOL if "ssm" in cfg.layer_pattern else GRAD_TOL
    for n, g, p in zip(names, grads, model.parameters()):
        assert g.dtype == p.dtype == ref[n].dtype, n
        assert torch.isfinite(g).all(), n
        a, r = g.double(), ref[n].double()
        rel = float((a - r).norm() / r.norm().clamp(min=1e-30))
        assert rel <= tol, (n, rel)


def test_adamw_float16_moments_match_reference():
    rcfg = RAdamWConfig(m_dtype=F16, v_dtype=F16)
    cfg = AdamWConfig(m_dtype=F16, v_dtype=F16)
    rng = np.random.default_rng(4)
    p32 = rng.standard_normal((4, 4)).astype(np.float32)
    rp = {"w": jnp.asarray(p32, jnp.float16)}
    tp = {"w": torch.from_numpy(p32).half()}
    rst, tst = radamw_init(rcfg, rp), adamw_init(cfg, tp)
    assert tst.m["w"].dtype == tst.v["w"].dtype == torch.float16
    for _ in range(3):
        g = rng.standard_normal((4, 4)).astype(np.float32)
        rp, rst, rn = radamw_update(rcfg, {"w": jnp.asarray(g, jnp.float16)},
                                    rst, rp, 1e-2)
        tp, tst, tn = adamw_update(cfg, {"w": torch.from_numpy(g).half()},
                                   tst, tp, 1e-2)
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    assert tp["w"].dtype == torch.float16
    for got, want in ((tp["w"], rp["w"]), (tst.m["w"], rst.m["w"]),
                      (tst.v["w"], rst.v["w"])):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -11, atol=1e-7)


def test_f16_state_round_trips_bit_for_bit(tmp_path):
    """The reference's f16 parameters into the port (``convert``) and
    back, and through each package's checkpoint into the other's."""
    rcfg, params, cfg, model = _pair("llama32_3b")
    host = jax.tree.map(np.asarray, params)
    back = convert.params_to_numpy(cfg, model.state_dict())
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(host),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert ka == kb and a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    opt = adamw_init(AdamWConfig(m_dtype=F16, v_dtype=F16), state)
    opt.m["embed.tokens"].normal_(generator=torch.Generator().manual_seed(1))
    tree = {"params": state, "m": opt.m}
    save_checkpoint(tmp_path / "port", 3, tree)
    got, _ = restore_checkpoint(tmp_path / "port", tree)
    want, got = flatten(tree), flatten(got)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float16
        assert torch.equal(got[k].view(torch.int16), v.view(torch.int16)), k
    # the reference's checkpoint of its f16 parameters, read by the port;
    # the port's (of the same parameters), read by the reference
    rsave(tmp_path / "ref", 1, host)
    flat, _ = restore_checkpoint(tmp_path / "ref")
    for k, a in flatten(host).items():
        assert flat[k].dtype == np.float16
        np.testing.assert_array_equal(flat[k].view(np.uint16),
                                      a.view(np.uint16))
    save_checkpoint(tmp_path / "port_params", 2, back)
    rgot, _ = rrestore(tmp_path / "port_params", host)
    for a, b in zip(jax.tree.leaves(rgot), jax.tree.leaves(host),
                    strict=True):
        assert np.asarray(a).dtype == np.float16
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      b.view(np.uint16))
