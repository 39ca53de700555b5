"""Every architecture of the reference, on the port, against the reference.

For each id of ``ARCH_IDS`` the ``TINY`` model in f32, carried from the
reference's weights by ``convert.params_from_numpy``, gives the reference's
prefill and 4 greedy decode steps: identical ids, logits and every cache
tensor within 1e-4 (2e-4 for the SSM and hybrid stacks, the reference's
own chunked-versus-recurrent tolerance). The stubs' frontend embeddings
are numpy draws handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model as M

torch.set_num_threads(1)


def _tol(cfg):
    return 2e-4 if "ssm" in cfg.layer_pattern else 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch, dtype="float32"):
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype=dtype)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    """A 32-token prompt (a whole chunk of the SSM stacks), prefill then 4
    greedy decode steps in both packages."""
    rcfg, params, cfg, model = _pair(arch)
    tol = _tol(cfg)
    s, steps = 32, 4
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (1, s))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    embeds = None
    if cfg.frontend != "none":
        pe = rng.standard_normal((1, cfg.num_patches, cfg.d_model))
        pe = pe.astype(np.float32)
        batch["frontend_embeds"] = jnp.asarray(pe)
        embeds = torch.from_numpy(pe)
    lj, cj = RM.prefill(params, rcfg, batch)
    with torch.inference_mode():
        lt, ct = model.prefill(torch.from_numpy(toks), embeds)
    assert len(ct) == len(cj) == cfg.group_size
    for c_ref, c_port in zip(cj, ct):
        assert type(c_port).__name__ == type(c_ref).__name__
        for a, b in zip(c_ref, c_port):
            assert tuple(b.shape) == a.shape
            np.testing.assert_allclose(_np(b), _np(a), rtol=tol, atol=tol)
    cj = RM.pad_caches(rcfg, cj, s + steps)
    ct = M.pad_caches(cfg, ct, s + steps)
    for i in range(steps + 1):
        assert lt.shape == lj.shape
        np.testing.assert_allclose(_np(lt), _np(lj), rtol=tol, atol=tol)
        tj = int(jnp.argmax(lj[0, -1, :rcfg.vocab_size]))
        tt = int(torch.argmax(lt[0, -1, :cfg.vocab_size]))
        assert tt == tj, f"step {i}"
        if i == steps:
            break
        lj, cj = RM.decode_step(params, rcfg, jnp.asarray([[tj]], jnp.int32),
                                cj, jnp.int32(s + i))
        with torch.inference_mode():
            lt, ct = model.decode_step(torch.tensor([[tt]]), ct, s + i)


def test_frontend_stub_needs_its_embeddings():
    cfg = dataclasses.replace(get_config("llava_next_mistral_7b", tiny=True),
                              dtype="float32")
    model = M.Model(cfg, device="cpu")
    toks = torch.zeros((1, 20), dtype=torch.int64)
    with pytest.raises(ValueError, match="frontend_embeds"):
        model.prefill(toks)
    with torch.inference_mode():
        a, _ = model.prefill(toks, torch.zeros((1, 16, cfg.d_model)))
        b, _ = model.prefill(toks, torch.ones((1, 16, cfg.d_model)))
    assert not torch.equal(a, b)
