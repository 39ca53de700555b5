"""Where the port's float16 models part from the reference's, on the CPU.

    PYTHONPATH=src python tests/helpers/f16_gaps.py [ARCH ...]
    PYTHONPATH=src python tests/helpers/f16_gaps.py --scheduler

For each TINY family in f16 (the port carrying the reference's weights),
one line each of:

* ``prefill``: the largest |logit| gap of a 32-token prefill, the port
  against the reference jitted (as its tests run it) and eager
  (``jax.disable_jit``), and the reference's two runs against each other;
  the lanes that differ; the largest logit;
* ``grads``: the largest norm-wise relative gradient gap of ``loss_fn``
  over the parameters, the same three pairs.

Then ``elementary``: the share of 2**20 f32 inputs on which XLA's exp,
sin, cos and rsqrt (jitted and eager) and PyTorch's differ (by an f32
ulp). A value that lands near an f16 rounding boundary then rounds the
other way: one f16 ulp, which later layers carry on. Tolerances in
``tests/test_torch_f16*.py`` are set from these lines.

``--scheduler`` instead runs mamba2's continuous schedulers on the
reference scheduler test's prompts (``tests/test_torch_f16.py``): the
reference jitted and eager (``jax.disable_jit``, ~40 s) against the port,
printing whether each run's greedy ids equal the port's, and request
0's top two prefill logits in each."""
import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M

ARCHS = {"llama32_3b": {}, "minicpm3_4b": {}, "granite_moe_1b": {},
         "mamba2_2p7b": {}, "starcoder2_7b": {"sliding_window": 8}}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _gap(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()), int((a != b).sum())


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def family(arch: str) -> None:
    kw = ARCHS.get(arch, {})
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype="float16",
                               **kw)
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float16",
                              **kw)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    v = cfg.vocab_size
    toks = np.random.default_rng(11).integers(0, v, (1, 32))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    ref = {}
    for mode, ctx in (("jit", contextlib.nullcontext()),
                      ("eager", jax.disable_jit())):
        with ctx:
            ref[mode] = RM.prefill(params, rcfg, batch)[0][..., :v]
    with torch.inference_mode():
        port = model.prefill(torch.from_numpy(toks))[0][..., :v]
    print(f"prefill {arch}: port-jit {_gap(port, ref['jit'])} port-eager "
          f"{_gap(port, ref['eager'])} jit-eager "
          f"{_gap(ref['jit'], ref['eager'])} largest logit "
          f"{float(np.abs(_np(ref['jit'])).max()):.4g}", flush=True)

    rng = np.random.default_rng(5)
    tb = rng.integers(0, v, (2, 32)).astype(np.int32)
    labels = rng.integers(0, v, (2, 32)).astype(np.int32)
    labels[rng.random((2, 32)) < 0.2] = -1
    jb = {"tokens": jnp.asarray(tb), "labels": jnp.asarray(labels)}
    grads = {}
    for mode, ctx in (("jit", contextlib.nullcontext()),
                      ("eager", jax.disable_jit())):
        with ctx:
            g = jax.grad(lambda p: RM.loss_fn(p, rcfg, jb)[0])(params)
        grads[mode] = convert.params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                                  g))
    model.requires_grad_(True)
    loss, _ = model.loss_fn({"tokens": torch.from_numpy(tb),
                             "labels": torch.from_numpy(labels)})
    names = [n for n, _ in model.named_parameters()]
    port = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    worst = lambda a, b: max((_rel(a[n], b[n]), n) for n in names)
    print(f"grads {arch}: port-jit {worst(port, grads['jit'])} port-eager "
          f"{worst(port, grads['eager'])} jit-eager "
          f"{worst(grads['eager'], grads['jit'])}", flush=True)


def elementary() -> None:
    x = (np.random.default_rng(0).standard_normal(1 << 20) * 4).astype(
        np.float32)
    fns = {"exp": (jnp.exp, torch.exp), "sin": (jnp.sin, torch.sin),
           "cos": (jnp.cos, torch.cos),
           "rsqrt": (lambda a: jax.lax.rsqrt(jnp.abs(a) + 1e-3),
                     lambda a: torch.rsqrt(a.abs() + 1e-3))}
    out = {}
    for name, (jf, tf) in fns.items():
        want = tf(torch.from_numpy(x)).numpy()
        out[name] = {mode: float((np.asarray(f(jnp.asarray(x))) != want
                                  ).mean())
                     for mode, f in (("eager", jf), ("jit", jax.jit(jf)))}
    print(f"elementary: share of f32 inputs where XLA and PyTorch differ "
          f"{out}", flush=True)


def ssm_scheduler() -> None:
    from repro.serving import ContinuousBatchingScheduler as RefScheduler
    from repro.serving import PrefixKVCache as RefPrefixKVCache
    from repro.serving import SchedRequest as RefSchedRequest
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     PrefixKVCache, SchedRequest)
    arch = "mamba2_2p7b"
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype="float16")
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float16")
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(2)
    shared = rng.integers(1, cfg.vocab_size, 16).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 9, 0, 16)]
    kw = dict(q_log2=10, r_log2=6, block_tokens=16, capacity_blocks=32)
    ids = lambda done: [r.output for r in sorted(
        done, key=lambda r: r.request_id)]
    port = ids(ContinuousBatchingScheduler(
        cfg, model, prefix_cache=PrefixKVCache(device="cpu", **kw),
        max_slots=2, max_context=64).run(
            [SchedRequest(prompt=p, max_new_tokens=5, request_id=i)
             for i, p in enumerate(prompts)]))
    v = cfg.vocab_size
    with torch.inference_mode():
        top = np.sort(_np(model.prefill(torch.tensor([prompts[0]]))[0])[
            0, -1, :v])[-2:]
    print(f"scheduler {arch}: port's request 0 top two logits {top}",
          flush=True)
    for mode, ctx in (("jit", contextlib.nullcontext()),
                      ("eager", jax.disable_jit())):
        with ctx:
            ref = ids(RefScheduler(
                rcfg, params, prefix_cache=RefPrefixKVCache(
                    backend="device", **kw),
                max_slots=2, max_context=64).run(
                    [RefSchedRequest(prompt=p, max_new_tokens=5,
                                     request_id=i)
                     for i, p in enumerate(prompts)]))
            first = {"tokens": jnp.asarray([prompts[0]], jnp.int32)}
            top = np.sort(_np(RM.prefill(params, rcfg, first)[0])[
                0, -1, :v])[-2:]
        print(f"scheduler {arch} reference {mode}: ids equal the port's "
              f"{ref == port}; request 0 top two logits {top}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1:] == ["--scheduler"]:
        ssm_scheduler()
    else:
        for a in sys.argv[1:] or list(ARCHS):
            family(a)
        elementary()
