"""The port's flash attention (its plain version on the CPU) against the
reference's Pallas kernel (interpret mode) and dense oracle.

The reference's sweep of ``tests/test_flash_attn.py`` (four shapes, f32
and bf16, non-causal, causality), the same tolerances (2e-5 in f32, 2e-2
in bf16), inputs from numpy seeds handed to both packages. Ragged ``s``,
which the reference kernel refuses, is held against the reference's
dense oracle ``sdpa_ref``. Both take head widths that are no multiple of
4 or 8, as the reference does (d = 6, (10, 5), (3, 7)), and heads wider
than 256 ((320, 320), (288, 256), (576, 512), (257, 1), (1, 257), 1,024).
The split between the CUDA kernels (the wgmma kernel's bf16 and f16
instances, the f32 one), which only the card runs, is pinned here by
dtype, and the f32 kernel's arithmetic (three TF32 passes
in a tiled online softmax, heads zero-padded to the kernel's box; past
256 columns S summed over chunks of d and o in slices) is modelled in
torch and held against the reference's Pallas kernel."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ops as jops
from repro.kernels.flash_attn import ref as jref
from repro.models import attention as rattn
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
    # widths no multiple of 4 or 8 (d, dv): rows that are not 16 bytes
    (1, 128, 4, 2, (6, 6), 64, 64),
    (1, 128, 6, 2, (10, 5), 64, 32),
    (2, 64, 4, 4, (3, 7), 32, 32),
    # heads wider than 256: the wide instances (d in chunks, o in slices)
    (1, 64, 4, 2, (320, 320), 64, 64),
    (1, 64, 4, 1, (288, 256), 64, 32),    # minicpm3's latent attention
    (1, 64, 4, 1, (576, 512), 32, 64),    # DeepSeek-V3's absorbed MLA
    (1, 64, 2, 2, (257, 1), 64, 64),
    (1, 64, 2, 1, (1, 257), 64, 64),
    (1, 64, 2, 1, (1024, 1024), 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_reference_kernel(b, s, h, kvh, d, bq, bk, dtype):
    d, dv = d if isinstance(d, tuple) else (d, d)
    (jq, jk, jv), (q, k, v), tol = _inputs(0, b, s, h, kvh, d, dv, dtype)
    want = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    got = ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
    assert got.dtype == q.dtype and got.shape == (b, s, h, dv)
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
    (100, 4, 2, 6, 6, True),        # widths no multiple of 4
    (77, 6, 2, 10, 5, True),        # odd dv, ragged
    (50, 4, 1, 3, 7, False),        # odd d and dv, non-causal
    (70, 4, 2, 333, 301, True),     # wider than 256, odd, ragged
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
    (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError),
    (lambda q, k, v: (q, k.to(torch.bfloat16), v), TypeError),
    (lambda q, k, v: (q.transpose(1, 2), k, v), ValueError),
    (lambda q, k, v: (q, k[:, :10], v), ValueError),
    (lambda q, k, v: (q[..., :0].contiguous(), k[..., :0].contiguous(), v),
     ValueError),                  # d = 0: no head
    (lambda q, k, v: (q[:, :, :5].contiguous(), k, v), ValueError),
    (lambda q, k, v: (q, k, v[0]), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    _, (q, k, v), _ = _inputs(5, 1, 16, 6, 2, 16, 16, "float32")
    with pytest.raises(err):
        K.flash_attention_fwd(*mutate(q, k, v))


@pytest.mark.parametrize("b,s,h,kvh,d,dv", [
    (65537, 16, 1, 1, 8, 8),        # b * h past 65,535 (the grid's x)
    (1, 16, 65537, 1, 8, 8),
    (1, 4194305, 1, 1, 8, 8),       # 65,537 query tiles of 64 rows
    (1, 2097153, 1, 1, 520, 520),   # 32,769 tiles x 2 slices of o
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wrapper_takes_grids_past_65535(b, s, h, kvh, d, dv, dtype):
    """``b * h`` and query tiles past 65,535, which the card's grid takes
    (x to 2**31 - 1; tiles and o's slices folded over y and z), pass the
    wrapper's checks: shapes only, on meta tensors."""
    q = torch.empty((b, s, h, d), dtype=dtype, device="meta")
    k = torch.empty((b, s, kvh, d), dtype=dtype, device="meta")
    v = torch.empty((b, s, kvh, dv), dtype=dtype, device="meta")
    K._check(q, k, v)
    assert K.fits_grid(b, s, h, dv)


def test_grid_refuses_only_what_it_cannot_hold():
    """Past 2**31 - 1 CTAs along x, or past 65,535**2 (query tile, o
    slice) pairs: no grid holds it."""
    assert K.fits_grid(1, 65535 * 64, 2 ** 31 - 1, 256)
    assert not K.fits_grid(2, 64, 2 ** 30, 8)
    assert K.fits_grid(1, 65535 * 65535 * 64, 1, 256)
    assert not K.fits_grid(1, 65535 * 65535 * 64 + 1, 1, 256)
    assert not K.fits_grid(1, 65535 * 64, 1, 65536 * 512)
    q = torch.empty((2, 1, 2 ** 30, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="grid"):
        K._check(q, q, q)


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 128, 128, K.WGMMA),   # llama3.2-3b: the serve prefill
    (torch.bfloat16, 16, 16, K.WGMMA),     # narrow heads, padded to a box
    (torch.bfloat16, 64, 256, K.WGMMA),    # d != dv
    (torch.bfloat16, 256, 8, K.WGMMA),     # the widest and narrowest
    (torch.bfloat16, 12, 16, K.WGMMA),     # d: no 16-byte row, loaded
    (torch.bfloat16, 16, 20, K.WGMMA),     # dv: the same   without TMA
    (torch.float32, 128, 128, K.TF32X3),   # f32: 2e-5 rules out one
    (torch.float32, 16, 16, K.TF32X3),     # TF32 pass, not three
    (torch.float32, 12, 12, K.TF32X3),     # any multiple of 4: 16 bytes
    (torch.float32, 256, 8, K.TF32X3),     # the widest and narrowest
    (torch.bfloat16, 5, 16, K.WGMMA),      # odd d: rows on 2-byte bounds
    (torch.bfloat16, 16, 3, K.WGMMA),      # odd dv
    (torch.float32, 5, 16, K.TF32X3),      # odd d: no 16-byte row
    (torch.float32, 16, 3, K.TF32X3),      # odd dv
    (torch.bfloat16, 320, 320, K.WGMMA),   # wider than 256: the wide
    (torch.float32, 320, 320, K.TF32X3),   # instances, TMA
    (torch.bfloat16, 576, 512, K.WGMMA),   # DeepSeek-V3's absorbed MLA
    (torch.float32, 288, 256, K.TF32X3),   # minicpm3's latent width
    (torch.bfloat16, 333, 301, K.WGMMA),   # wide, odd: producer warp
    (torch.float32, 1030, 517, K.TF32X3),  # wide, no 16-byte row
    (torch.bfloat16, 257, 1, K.WGMMA),     # one side wide, one narrow
    (torch.float32, 1, 257, K.TF32X3),
    (torch.float16, 128, 128, K.WGMMA_F16),  # f16: the same kernel's f16
    (torch.float16, 12, 12, K.WGMMA_F16),    # instance, on either load
    (torch.float16, 320, 320, K.WGMMA_F16),  # route and the wide one
    (torch.float16, 333, 301, K.WGMMA_F16),
])
def test_kernel_split_is_fixed_by_dtype_and_widths(dtype, d, dv, want):
    assert K.kernel_for(dtype, d, dv) == want
    assert set(K.LAUNCHES) == {K.WGMMA, K.WGMMA_F16, K.TF32X3}
    item = 4 if dtype == torch.float32 else 2
    assert K.tma_loads(dtype, d, dv) == (d * item % 16 == dv * item % 16
                                         == 0)


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


# ---------------------------------------------------------------------------
# the f32 kernel's arithmetic (flash_attn_tf32x3_kernel), modelled in torch
# ---------------------------------------------------------------------------
def _tf32(x, rounded=True):
    """x as tf32: rounded as ``cvt.rna.tf32.f32`` rounds (10 mantissa
    bits, to nearest, ties away from zero: the bit pattern plus half of
    the 13 dropped bits, then cut), or cut as the tensor cores of an H100
    read an f32 operand (the low 13 bits dropped)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000 * rounded) & ~0x1FFF).view(torch.float32)


def _product(a, b, passes):
    """a @ b as the kernel has the tensor cores take it: each operand as it
    lies (hi, read cut) and its lo part (x - hi, rounded); three TF32
    passes, the small terms first (hi lo + lo hi, then hi hi), or one (hi
    hi)."""
    ah, bh = _tf32(a, rounded=False), _tf32(b, rounded=False)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _boxed(x):
    """x with its last dim zero-padded to the kernel's boxes of 32 f32
    columns, as TMA or the producer warp fills them."""
    return torch.nn.functional.pad(x, (0, -x.shape[-1] % 32))


#: the f32 kernel's wide instance (d or dv over 256): d's chunks, o's slices
D_CHUNK = 64


def _scores(qt, kt, passes, chunk):
    """S = Q K^T as the kernel sums it: in one product, or (``chunk``: the
    wide instance) by two warpgroups, each over its half of every chunk of
    d (32 columns) into an f32 accumulator of its own, each chunk's three
    passes in turn (hi lo, lo hi, hi hi), then the two sums added."""
    if chunk is None:
        return _product(qt, kt, passes)
    sums = []
    for w in range(2):
        sc = torch.zeros(qt.shape[:-1] + kt.shape[-1:], dtype=torch.float32)
        for c in range(w * chunk // 2, qt.shape[-1], chunk):
            a, b = qt[..., c:c + chunk // 2], kt[..., c:c + chunk // 2, :]
            ah, bh = _tf32(a, rounded=False), _tf32(b, rounded=False)
            if passes == 1:
                sc = sc + ah @ bh
                continue
            al, bl = _tf32(a - ah), _tf32(b - bh)
            sc = sc + ah @ bl
            sc = sc + al @ bh
            sc = sc + ah @ bh
        sums.append(sc)
    return sums[0] + sums[1]


def _kernel_model(q, k, v, causal=True, window=0, passes=3):
    """The kernel's f32 arithmetic: heads zero-padded to its 32-column
    boxes, 64-row query tiles, key tiles of 64 (32 where the widest head is
    over 128 and at most 256), from the tile that holds the lowest row's
    window edge up to the causal limit; unscaled scores, the -1e30 mask,
    exp2 with the scale of the true d folded in, no shift for a row whose
    max is still -1e30, l from the unrounded p, acc / max(l, 1e-30), the
    columns below dv. Where d or dv is over 256 (the wide instance: its
    operands' hi and lo parts from its pre-pass, the same values) S is
    summed over d's chunks of 64 columns by two warpgroups, 32 columns of
    each chunk a warpgroup, then added, and o is computed in the
    kernel's slices (``kernel.slice_cols``: 512 columns, or 256), each
    with its own pass over the key tiles."""
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    f32 = torch.float32
    bk = 32 if 128 < max(d, dv) <= 256 else 64
    chunk = D_CHUNK if max(d, dv) > 256 else None
    scale_log2 = float(np.float32(1.0 / d ** 0.5) * np.float32(math.log2(math.e)))
    q, k, v = _boxed(q), _boxed(k), _boxed(v)
    wide = v.shape[3]
    o_slice = K.slice_cols(b, s, h, dv) if chunk else wide
    qg = q.reshape(b, s, kvh, h // kvh, -1).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]       # (b, kvh, 1, d, s)
    vt = v.permute(0, 2, 1, 3)[:, :, None]       # (b, kvh, 1, s, dv)
    out = torch.empty(b, kvh, h // kvh, s, wide, dtype=f32)
    for v0 in range(0, wide, o_slice):
        vs = vt[..., v0:v0 + o_slice]
        for q0 in range(0, s, 64):
            rows = torch.arange(q0, min(q0 + 64, s))
            n_tiles = -(-s // bk)
            if causal:
                n_tiles = min(n_tiles, (q0 + 64 + bk - 1) // bk)
            lo = q0 - window + 1
            t0 = lo // bk if window and lo > 0 else 0
            m = torch.full(qg.shape[:3] + (len(rows), 1), ref.NEG, dtype=f32)
            l = torch.zeros_like(m)
            acc = torch.zeros(qg.shape[:3] + (len(rows), vs.shape[-1]),
                              dtype=f32)
            for t in range(t0, n_tiles):
                cols = torch.arange(t * bk, min(t * bk + bk, s))
                sc = _scores(qg[..., rows, :], kt[..., cols], passes, chunk)
                keep = torch.ones(len(rows), len(cols), dtype=torch.bool)
                if causal:
                    keep &= cols[None, :] <= rows[:, None]
                if window:
                    keep &= cols[None, :] > rows[:, None] - window
                sc = torch.where(keep, sc, torch.tensor(ref.NEG, dtype=f32))
                mx = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha = torch.exp2((m - mx) * scale_log2)
                shift = torch.where(mx == ref.NEG, torch.zeros_like(mx),
                                    mx * scale_log2)
                p = torch.exp2(sc * scale_log2 - shift)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + _product(p, vs[..., cols, :], passes)
                m = mx
            out[..., rows, v0:v0 + o_slice] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, wide)[..., :dv]


@pytest.mark.parametrize("b,s,h,kvh,d,causal,bq,bk", [
    (2, 128, 4, 4, 32, True, 32, 32),     # the reference sweep: MHA
    (1, 256, 8, 2, 64, True, 64, 64),     # GQA 4:1
    (2, 128, 6, 2, 16, True, 64, 32),     # GQA 3:1, odd dims
    (1, 128, 4, 1, 32, True, 128, 128),   # MQA, single tile
    (1, 64, 2, 2, 16, False, 32, 32),     # non-causal
    (1, 128, 4, 2, 6, True, 64, 64),      # widths padded to a box: 6,
    (1, 128, 6, 2, 10, True, 64, 32),     # 10, and (d, dv) = (3, 7)
    (1, 64, 4, 4, (3, 7), False, 32, 32),
    # the wide instance: S over d's chunks of 64, o in the kernel's slices
    (1, 64, 4, 2, 320, True, 64, 32),
    (1, 64, 4, 1, (576, 512), True, 64, 64),
    (1, 64, 2, 1, 1024, False, 32, 32),
    (1, 128, 2, 1, (257, 513), True, 64, 64),
])
def test_tf32x3_model_matches_reference_kernel(b, s, h, kvh, d, causal, bq,
                                               bk):
    """The model of the f32 kernel holds the reference kernel's f32
    tolerance (2e-5) on the f32 sweep, interpret mode, at widths the
    kernel zero-pads to its box (the padding adds exactly nothing in each
    of the three passes), and at heads wider than 256, where the wide
    instance sums S over d's chunks and computes o in slices."""
    d, dv = d if isinstance(d, tuple) else (d, d)
    (jq, jk, jv), (q, k, v), tol = _inputs(0 if causal else 1, b, s, h, kvh,
                                           d, dv, "float32")
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                block_k=bk)
    got = _kernel_model(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,h,kvh,d,dv,w", [
    (200, 4, 2, 16, 16, 8),      # rows whose first tile is all masked
    (200, 6, 2, 32, 32, 77),     # an edge across two tiles
    (130, 4, 1, 16, 16, 1),      # one key
    (100, 4, 2, 256, 8, 17),     # 32-key tiles (heads wider than 128)
])
def test_tf32x3_model_window_matches_reference(s, h, kvh, d, dv, w):
    """The model with a sliding window (the window's first tile, the -1e30
    rule) against the reference's ``_sdpa`` under ``_causal_mask(s, s, 0,
    w)``, and ragged ``s``, within 2e-5."""
    (jq, jk, jv), (q, k, v), tol = _inputs(s + w, 1, s, h, kvh, d, dv,
                                           "float32")
    want = rattn._sdpa(jq, jk, jv, rattn._causal_mask(s, s, 0, w))
    got = _kernel_model(q, k, v, window=w)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_one_tf32_pass_exceeds_the_tolerance():
    """Why three passes: the same model with one TF32 pass (hi hi only)
    misses the reference kernel's 2e-5 by far on the sweep's GQA case."""
    (jq, jk, jv), (q, k, v), tol = _inputs(0, 1, 256, 8, 2, 64, 64,
                                           "float32")
    want = _np(jops.flash_attention(jq, jk, jv, block_q=64, block_k=64))
    one = np.abs(_np(_kernel_model(q, k, v, passes=1)) - want).max()
    three = np.abs(_np(_kernel_model(q, k, v)) - want).max()
    assert one > 5 * tol > 5 * three, (one, three)


def _plan(sw, ctas, wgs, chunks, chunk, resident, loads):
    return {"wide": True, "loads": loads, "slice_cols": sw,
            "ctas_per_query_tile": ctas, "warpgroups_with_columns": wgs,
            "d_chunks": chunks, "d_chunk": chunk, "q_resident": resident}


BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,b,s,h,d,dv,want", [
    (BF, 1, 512, 8, 256, 256, {"wide": False, "loads": "tma"}),
    (F32, 1, 512, 4, 255, 7, {"wide": False, "loads": "warp"}),
    # 64 query tiles: 2 x 64 CTAs of 256 columns fill one wave
    (BF, 1, 512, 8, 320, 320, _plan(256, 2, 2, 2, 256, True, "tma")),
    (F32, 1, 512, 8, 320, 320, _plan(256, 2, 2, 5, 64, False, "split")),
    # dv <= 256: one CTA, each warpgroup half of the columns
    (F16, 1, 1024, 40, 288, 256, _plan(256, 1, 2, 2, 256, True, "tma")),
    (F32, 1, 64, 2, 257, 1, _plan(256, 1, 1, 5, 64, False, "split")),
    # enough CTAs: the scores once for 512 columns
    (BF, 1, 1024, 128, 576, 512, _plan(512, 1, 2, 3, 256, True, "tma")),
    (F16, 2, 512, 40, 512, 512, _plan(512, 1, 2, 2, 256, True, "tma")),
    (BF, 1, 4096, 16, 1030, 513, _plan(512, 2, 2, 9, 128, False, "warp")),
    (BF, 1, 1000, 6, 333, 301, _plan(512, 1, 2, 2, 256, True, "warp")),
    (F32, 1, 300, 6, 1030, 517, _plan(256, 3, 2, 17, 64, False, "split")),
    # one wave's edge: 2 x 66 CTAs of 256 columns fit, 2 x 67 do not
    (BF, 1, 64, 66, 320, 320, _plan(256, 2, 2, 2, 256, True, "tma")),
    (BF, 1, 64, 67, 320, 320, _plan(512, 1, 2, 2, 256, True, "tma")),
])
def test_wide_plan_is_fixed_by_the_shape(dtype, b, s, h, d, dv, want):
    """How the wide instances take a call (o's columns a CTA, the CTAs a
    query tile takes, warpgroups with columns of o, d's chunks, a resident
    Q, the load route) follows from the dtype and the shape alone: the
    scores once for up to 512 columns of o, slices of 256 where those CTAs
    still fit in one wave of the card's 132 SMs."""
    assert K.wide_plan(dtype, b, s, h, d, dv) == want
    if want["wide"]:
        assert K.slice_cols(b, s, h, dv) == want["slice_cols"]


@pytest.mark.parametrize("b,s,h,kvh,d,dv", [
    (1, 37, 4, 2, 300, 257),     # ragged s, widths no multiple of 32
    (2, 64, 2, 1, 1030, 517),    # no multiple of 4: the pre-pass reads rows
    (1, 5, 3, 3, 1, 1),          # narrower than a box
])
def test_tf32_split_is_the_models_split(b, s, h, kvh, d, dv):
    """The plain version of the f32 wide instance's pre-pass
    (``ref.tf32_split``, which the card holds the kernel to bit for bit) is
    the model's split: hi the operand cut as the tensor cores read it, lo
    ``_tf32(x - hi)``, zeros past d and s, V^T with keys along a row in
    the order 0 2 4 6 1 3 5 7 within each 8."""
    _, (q, k, v), _ = _inputs(b + s, b, s, h, kvh, d, dv, "float32")
    got = ref.tf32_split(q, k, v)
    assert got.numel() == K.split_floats(b, s, h, kvh, d, dv)
    dp, s8 = -(-d // 32) * 32, -(-s // 8) * 8

    def parts(x):
        x = _boxed(x)
        hi = _tf32(x, rounded=False)
        return hi, _tf32(x - hi)

    n_q, n_k = b * s * h * 2 * dp, b * s * kvh * 2 * dp
    for x, flat in ((q, got[:n_q]), (k, got[n_q:n_q + n_k])):
        rows = flat.view(b, s, x.shape[2], 2 * dp)
        hi, lo = parts(x)
        assert torch.equal(rows[..., :dp], hi) and torch.equal(
            rows[..., dp:], lo)
    vt = got[n_q + n_k:].view(b, kvh, 2, dv, s8)
    order = [8 * (p // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[p % 8] for p in range(s8)]
    assert ref.split_key(torch.arange(s8)).tolist() == order
    keys = torch.nn.functional.pad(v.permute(0, 2, 3, 1), (0, s8 - s))
    want_hi = _tf32(keys, rounded=False)[..., order]
    want_lo = _tf32(keys[..., order] - want_hi)
    assert torch.equal(vt[:, :, 0], want_hi)
    assert torch.equal(vt[:, :, 1], want_lo)
    assert not vt[..., [p for p in range(s8) if order[p] >= s]].any()
