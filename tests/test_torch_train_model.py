"""The port's training forward (``Model.forward_train`` / ``loss_fn``)
against the reference's, family by family.

Every family's TINY model in f32 (llama: dense GQA; granite: MoE;
minicpm3: MLA; mamba2: SSM; jamba: hybrid SSM + MoE; llava: the vision
stub), its weights carried from the reference's by
``convert.params_from_numpy``, on one seeded batch with masked labels:
logits within 1e-4 (2e-4 for the SSM stacks, the reference's own
chunked-versus-recurrent tolerance), aux loss within 1e-6, MoE expert
counts bit for bit, the loss within 1e-5, and every parameter's gradient
against ``jax.grad(loss_fn)`` within 1e-4 · max(1, max|g_ref|). Remat and
the chunked attention change nothing: ``remat=True`` equals
``remat=False`` and ``attn_impl="chunked"`` equals ``"dense"`` (1e-5).
The forward-only flash-attention kernel refuses inputs that need a
gradient instead of returning a constant. The serving steps of
``launch/steps.py`` give the model's prefill and greedy decode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M

torch.set_num_threads(1)
ARCHS = ["llama32_3b", "granite_moe_1b", "minicpm3_4b", "mamba2_2p7b",
         "jamba15_large_398b", "llava_next_mistral_7b"]
B, S = 2, 64


def _tol(cfg):
    return 2e-4 if "ssm" in cfg.layer_pattern else 1e-4


def _pair(arch, **kw):
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype="float32",
                               **kw)
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32",
                              **kw)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    model.requires_grad_(True)
    return rcfg, params, cfg, model


def _batch(cfg, seed=5):
    """tokens (B, S), labels with -1 (masked) positions [+ embeds]."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    arrs = {"tokens": toks, "labels": labels}
    if cfg.frontend != "none":
        arrs["frontend_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    rcfg, params, cfg, model = _pair(arch)
    jb, tb = _batch(cfg)
    tol = _tol(cfg)
    lj, auxj, cj = RM.forward_train(params, rcfg, jb)
    (loss_j, mj), gj = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        params, rcfg, jb)
    lt, auxt, ct = model.forward_train(tb)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(auxt.detach()), float(auxj), rtol=0,
                               atol=1e-6)
    if cfg.num_experts:
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    else:
        assert ct is None and cj is None
    loss_t, mt = model.loss_fn(tb)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["ce"].detach()), float(mj["ce"]),
                               rtol=1e-5)
    assert float(mt["tokens"]) == float(mj["tokens"])
    if cfg.num_experts:
        np.testing.assert_array_equal(mt["expert_counts"].numpy(),
                                      np.asarray(mj["expert_counts"]))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss_t, [p for _, p in
                                         model.named_parameters()])
    ref = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, gj))
    assert set(ref) == set(names)
    for n, g in zip(names, grads):
        gr = ref[n].numpy()
        bound = 1e-4 * max(1.0, float(np.abs(gr).max()))
        np.testing.assert_allclose(_np(g), gr, rtol=0, atol=bound,
                                   err_msg=n)


@pytest.mark.parametrize("arch", ["granite_moe_1b", "mamba2_2p7b"])
def test_remat_changes_nothing(arch):
    """Recomputing each group in the backward pass gives the same loss
    and gradients as keeping its activations."""
    _, _, cfg, model = _pair(arch)
    _, tb = _batch(cfg, seed=9)
    params = [p for _, p in model.named_parameters()]
    out = []
    for remat in (True, False):
        loss, _ = model.loss_fn(tb, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, params)))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["llama32_3b", "minicpm3_4b"])
def test_chunked_attention_matches_dense_and_reference(arch):
    """``attn_impl="chunked"`` (query tiles of 16, key tiles of 8, so the
    skip of key tiles past a query tile is exercised) equals the dense
    attention and the reference's chunked function."""
    kw = dict(attn_impl="chunked", attn_q_chunk=16, attn_kv_chunk=8)
    rcfg, params, cfg, model = _pair(arch, **kw)
    jb, tb = _batch(cfg, seed=3)
    dense = M.Model(dataclasses.replace(cfg, attn_impl="dense"),
                    device="cpu")
    dense.load_state_dict(model.state_dict())
    dense.requires_grad_(True)
    lt, _, _ = model.forward_train(tb)
    ld, _, _ = dense.forward_train(tb)
    np.testing.assert_allclose(_np(lt), _np(ld), rtol=1e-5, atol=1e-5)
    lj, _, _ = RM.forward_train(params, rcfg, jb)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-4, atol=1e-4)
    gt = torch.autograd.grad(model.loss_fn(tb)[0],
                             [p for _, p in model.named_parameters()])
    gd = torch.autograd.grad(dense.loss_fn(tb)[0],
                             [p for _, p in dense.named_parameters()])
    for a, b in zip(gt, gd):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)


def test_flash_attention_refuses_inputs_that_need_a_gradient():
    """The forward-only kernel's wrapper raises (on the CPU too, before
    its plain version) rather than return an output autograd would treat
    as a constant; without grad mode it runs as before."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*training path"):
        fa_ops.flash_attention(q, k, v)
    with torch.no_grad():
        o = fa_ops.flash_attention(q, k, v)
    assert o.shape == (1, 8, 4, 16) and o.grad_fn is None
    # a model whose weights need gradients refuses to prefill outside
    # no-grad / inference mode, and trains through its own attention
    _, _, cfg, model = _pair("llama32_3b")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no backward"):
        model.prefill(toks)
    with torch.inference_mode():
        model.prefill(toks)
    loss, _ = model.loss_fn({"tokens": toks, "labels": toks})
    g = torch.autograd.grad(loss, model.layers[0].mixer.wq)[0]
    assert float(g.abs().max()) > 0


def test_prefill_and_decode_steps():
    """``make_prefill_step`` is the model's prefill; ``make_decode_step``
    one decode step and its greedy next token (int32)."""
    _, _, cfg, model = _pair("llama32_3b")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)))
    logits, caches = steps_mod.make_prefill_step(cfg)(model, {"tokens": toks})
    with torch.inference_mode():
        want, _ = model.prefill(toks)
    assert torch.equal(logits, want)
    caches = M.pad_caches(cfg, caches, 13)
    nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    out, _, tok = steps_mod.make_decode_step(cfg)(model, caches, nxt, 12)
    assert tok.dtype == torch.int32 and out.shape == (2, 1, cfg.padded_vocab)
    assert torch.equal(tok, torch.argmax(out[:, -1, :], dim=-1).int())
