"""The port's flash attention (its plain version on the CPU) against the
reference's Pallas kernel (interpret mode) and dense oracle.

The reference's sweep of ``tests/test_flash_attn.py`` (four shapes, f32
and bf16, non-causal, causality), the same tolerances (2e-5 in f32, 2e-2
in bf16), inputs from numpy seeds handed to both packages. Ragged ``s``,
which the reference kernel refuses, is held against the reference's
dense oracle ``sdpa_ref``. The split between the two CUDA kernels, which
only the card runs, is pinned here by dtype and head widths."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ops as jops
from repro.kernels.flash_attn import ref as jref
from repro_torch.kernels.flash_attn import kernel as K
from repro_torch.kernels.flash_attn import ops, ref

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, s, h, kvh, d, dv, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, dv))]
    jdt, tdt, tol = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs], tol)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,h,kvh,d,bq,bk", [
    (2, 128, 4, 4, 32, 32, 32),     # MHA
    (1, 256, 8, 2, 64, 64, 64),     # GQA 4:1
    (2, 128, 6, 2, 16, 64, 32),     # GQA 3:1, odd dims
    (1, 128, 4, 1, 32, 128, 128),   # MQA, single tile
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_reference_kernel(b, s, h, kvh, d, bq, bk, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(0, b, s, h, kvh, d, d, dtype)
    want = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    got = ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
    assert got.dtype == q.dtype and got.shape == (b, s, h, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_non_causal():
    (jq, jk, jv), (q, k, v), tol = _inputs(1, 1, 64, 2, 2, 16, 16, "float32")
    want = jops.flash_attention(jq, jk, jv, causal=False, block_q=32,
                                block_k=32)
    got = ops.flash_attention(q, k, v, causal=False, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_causality_enforced():
    """Changing future tokens must not change earlier outputs."""
    _, (q, k, v), _ = _inputs(2, 1, 64, 2, 2, 16, 16, "float32")
    o1 = ops.flash_attention(q, k, v, block_q=32, block_k=32)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 123.0
    v2[:, 40:] = -7.0
    o2 = ops.flash_attention(q, k2, v2, block_q=32, block_k=32)
    np.testing.assert_array_equal(o1[:, :40].numpy(), o2[:, :40].numpy())


@pytest.mark.parametrize("s,h,kvh,d,dv,causal", [
    (1, 4, 2, 16, 16, True),        # a single position
    (37, 6, 2, 16, 16, True),       # GQA 3:1, below one tile
    (100, 8, 8, 32, 32, True),      # ragged over several tiles
    (100, 4, 1, 32, 16, False),     # dv != d, non-causal
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_lengths_match_reference_oracle(s, h, kvh, d, dv, causal,
                                               dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(3, 1, s, h, kvh, d, dv, dtype)
    want = jref.sdpa_ref(jq, jk, jv, causal=causal)
    got = ops.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    _, (q, k, v), _ = _inputs(4, 1, 48, 6, 2, 16, 16, "bfloat16")
    before = dict(K.LAUNCHES)
    got = K.flash_attention_fwd(q, k, v)
    assert K.LAUNCHES == before
    assert torch.equal(got, ref.sdpa_ref(q, k, v))


@pytest.mark.parametrize("mutate,err", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),
    (lambda q, k, v: (q, k.to(torch.bfloat16), v), TypeError),
    (lambda q, k, v: (q.transpose(1, 2), k, v), ValueError),
    (lambda q, k, v: (q, k[:, :10], v), ValueError),
    (lambda q, k, v: (q[..., :14].contiguous(), k[..., :14].contiguous(),
                      v), ValueError),
    (lambda q, k, v: (q[:, :, :5].contiguous(), k, v), ValueError),
    (lambda q, k, v: (q, k, v[0]), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    _, (q, k, v), _ = _inputs(5, 1, 16, 6, 2, 16, 16, "float32")
    with pytest.raises(err):
        K.flash_attention_fwd(*mutate(q, k, v))


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 128, 128, K.WGMMA),   # llama3.2-3b: the serve prefill
    (torch.bfloat16, 16, 16, K.WGMMA),     # narrow heads, padded to a box
    (torch.bfloat16, 64, 256, K.WGMMA),    # d != dv
    (torch.bfloat16, 256, 8, K.WGMMA),     # the widest and narrowest
    (torch.bfloat16, 12, 16, K.SIMT),      # d: no 16-byte TMA stride
    (torch.bfloat16, 16, 20, K.SIMT),      # dv: the same
    (torch.float32, 128, 128, K.SIMT),     # f32: 2e-5 rules out TF32
    (torch.float32, 16, 16, K.SIMT),
])
def test_kernel_split_is_fixed_by_dtype_and_widths(dtype, d, dv, want):
    assert K.kernel_for(dtype, d, dv) == want
    assert set(K.LAUNCHES) == {K.WGMMA, K.SIMT}


@pytest.mark.parametrize("causal", [True, False])
def test_scores_scaled_x8_match_reference_kernel(causal):
    """q and k scaled x8 (scores x64: a peaked softmax whose running max
    jumps between tiles and meets the -1e30 mask), v as drawn: the port
    holds the reference kernel's bf16 tolerance."""
    (jq, jk, jv), (q, k, v), tol = _inputs(6, 1, 256, 4, 2, 64, 64,
                                           "bfloat16")
    jq, jk = jq * 8, jk * 8
    q, k = q * 8, k * 8
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got = ops.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
