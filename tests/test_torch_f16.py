"""Float16 models in the port against the reference, on the CPU.

The reference takes ``ModelConfig.dtype="float16"`` (its model reads
``jnp.dtype(cfg.dtype)``, its Pallas kernel works in v's type); so does
the port. The same inputs, numpy draws from a seed, go through both:

* the flash-attention kernel's plain version against the reference's
  Pallas kernel (interpret mode) at the reference's own GQA case and at
  widths that are no multiple of 8 or wider than 256, against its dense
  oracle at a ragged length, and with a window against its model's
  windowed ``_sdpa``: within ``check.TOLERANCE[float16]`` (4e-3);
* TINY llama32, minicpm3 (MLA), granite-moe (MoE), mamba2 (SSM) and
  starcoder2 with a window of 8, the port carrying the reference's f16
  weights (``convert.params_from_numpy``): a prefill and 4 greedy decode
  steps with the same ids and logits within ``LOGIT_TOL`` (the windowed
  stack against the reference's greedy re-prefill, since its decode
  ignores the window); their serving in ``tests/test_torch_f16_serving.py``.

``LOGIT_TOL``: the port's f16 logits differ from the reference's where an
f32 elementary function (exp, sin, cos, rsqrt) lands one f32 ulp apart on
the two backends and an f16 rounding after it then goes the other way
(one f16 ulp, 2**-11 of the value), which later layers carry on; and the
jitted reference's fused SSM scan rounds otherwise than its own eager run
(``tests/helpers/f16_gaps.py`` prints both; ``PERF.md`` §6, PR 30). Its
largest prefill gap is 1.1e-3 at a largest logit of 3.9 (minicpm3);
1e-2, about five f16 ulps there, leaves the decode steps room to carry
such a gap on."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.flash_attn import ops as jops
from repro.kernels.flash_attn import ref as jref
from repro.models import attention as rattn
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import check as FC
from repro_torch.kernels.flash_attn import kernel as FK
from repro_torch.kernels.flash_attn import ops
from repro_torch.kernels.flash_attn.ref import sdpa_ref
from repro_torch.models import model as M
from repro_torch.models.layers import torch_dtype

torch.set_num_threads(1)
F16 = "float16"
ATTN_TOL = FC.TOLERANCE[torch.float16]
LOGIT_TOL = 1e-2
#: the families and the config fields each is served with
FAMILIES = {"llama32_3b": {}, "minicpm3_4b": {}, "granite_moe_1b": {},
            "mamba2_2p7b": {}, "starcoder2_7b": {"sliding_window": 8}}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(arch, **kw):
    """(reference cfg, reference params, port cfg, port model): ``arch``'s
    TINY in f16, the port carrying the reference's weights."""
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype=F16, **kw)
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype=F16, **kw)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    weights = convert.params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                          params))
    # every parameter in the reference's type (f16, but an f32 router)
    assert {n: p.dtype for n, p in model.named_parameters()} == {
        n: t.dtype for n, t in weights.items()}
    model.load_state_dict(weights)
    return rcfg, params, cfg, model


def test_dtype_strings():
    assert torch_dtype("float16") == torch.float16
    assert torch_dtype("bfloat16") == torch.bfloat16
    assert torch_dtype("float32") == torch.float32
    with pytest.raises(ValueError, match="unsupported dtype"):
        torch_dtype("int8")


# ---------------------------------------------------------------------------
# the flash-attention kernel's plain version
# ---------------------------------------------------------------------------
def _qkv(seed, b, s, h, kvh, d, dv):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, dv))]
    return ([jnp.asarray(a, jnp.float16) for a in arrs],
            [torch.from_numpy(a).half() for a in arrs])


@pytest.mark.parametrize("b,s,h,kvh,d,dv,bq,bk", [
    (1, 256, 8, 2, 64, 64, 64, 64),       # the reference's GQA 4:1
    (1, 128, 4, 2, 6, 6, 64, 64),         # rows that are not 16 bytes
    (1, 128, 6, 2, 10, 5, 64, 32),        # odd dv
    (1, 64, 4, 2, 320, 320, 64, 64),      # the wide instance
    (1, 64, 4, 1, 288, 256, 64, 32),      # minicpm3's latent attention
])
def test_flash_attention_matches_reference_kernel(b, s, h, kvh, d, dv, bq,
                                                  bk):
    (jq, jk, jv), (q, k, v) = _qkv(0, b, s, h, kvh, d, dv)
    want = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    got = ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
    assert got.dtype == torch.float16 and got.shape == (b, s, h, dv)
    _close(got, want, ATTN_TOL)
    assert FK.kernel_for(torch.float16, d, dv) == FK.WGMMA_F16


def test_ragged_and_windowed_match_reference():
    """A ragged, wide, odd head against the reference's dense oracle, and
    a window of 17 against its model's ``_sdpa`` under the windowed
    causal mask; the wrapper's CPU path is the plain version."""
    (jq, jk, jv), (q, k, v) = _qkv(3, 1, 70, 4, 2, 333, 301)
    _close(ops.flash_attention(q, k, v), jref.sdpa_ref(jq, jk, jv), ATTN_TOL)
    (jq, jk, jv), (q, k, v) = _qkv(4, 2, 64, 6, 2, 16, 16)
    want = rattn._sdpa(jq, jk, jv, rattn._causal_mask(64, 64, 0, 17))
    got = sdpa_ref(q, k, v, window=17)
    _close(got, want, ATTN_TOL)
    before = dict(FK.LAUNCHES)
    assert torch.equal(FK.flash_attention_fwd(q, k, v, window=17), got)
    assert FK.LAUNCHES == before


# ---------------------------------------------------------------------------
# every family: prefill and greedy decode
# ---------------------------------------------------------------------------
def _oracle(rcfg, params, seq):
    """The reference's greedy re-prefill logits of ``seq``: one
    ``forward_train``, whose row t is its prefill over tokens 0..t."""
    logits, _, _ = RM.forward_train(params, rcfg, {
        "tokens": jnp.asarray([seq], jnp.int32)})
    return _np(logits)[0]


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_prefill_and_decode_match_reference(arch):
    """A 32-token prompt (a whole chunk of the SSM stack), prefill then 4
    greedy decode steps: the same ids, logits within ``LOGIT_TOL``, and
    the caches the prefill keeps in the reference's types and within
    ``LOGIT_TOL`` of its values."""
    rcfg, params, cfg, model = _pair(arch, **FAMILIES[arch])
    v = cfg.vocab_size
    s, steps = 32, 4
    toks = np.random.default_rng(11).integers(0, v, (1, s))
    with torch.inference_mode():
        lt, ct = model.prefill(torch.from_numpy(toks))
        lj, cj = RM.prefill(params, rcfg, {"tokens": jnp.asarray(toks)})
        for c_ref, c_port in zip(cj, ct, strict=True):
            for a, b in zip(c_ref, c_port, strict=True):
                assert str(b.dtype).split(".")[-1] == a.dtype.name
                _close(b, a, LOGIT_TOL)
        ct = M.pad_caches(cfg, ct, s + steps)
        got, ids = [lt[0, -1]], []
        for i in range(steps):
            ids.append(int(torch.argmax(got[-1][:v])))
            lt, ct = model.decode_step(torch.tensor([[ids[-1]]]), ct, s + i)
            got.append(lt[0, -1])
    assert lt.dtype == torch.float32
    if cfg.sliding_window:
        want = _oracle(rcfg, params, list(toks[0]) + ids)[s - 1:]
    else:
        cj = RM.pad_caches(rcfg, cj, s + steps)
        want = [_np(lj)[0, -1]]
        for i in range(steps):
            lj, cj = RM.decode_step(params, rcfg, jnp.asarray([[ids[i]]]),
                                    cj, jnp.int32(s + i))
            want.append(_np(lj)[0, -1])
        want = np.stack(want)
    assert [int(np.argmax(r[:v])) for r in want[:-1]] == ids
    _close(torch.stack(got)[:, :v], want[:, :v], LOGIT_TOL)
