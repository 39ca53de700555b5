"""Float16 serving in the port against the reference, on the CPU.

TINY llama32, minicpm3 (MLA), granite-moe (MoE), mamba2 (SSM) and
starcoder2 with a window of 8 in f16, the port carrying the reference's
weights (``convert.params_from_numpy``): ``ServeEngine`` with a device
``PrefixKVCache`` against the reference's engine (identical outputs,
cached prefixes and cache stats) and the continuous scheduler against the
reference's (the windowed stack against the port's serial engine). Their
prefill and decode logits are held to the reference's in
``tests/test_torch_f16.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import PrefixKVCache as RefPrefixKVCache
from repro.serving import Request as RefRequest
from repro.serving import SchedRequest as RefSchedRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serving import (ContinuousBatchingScheduler, PrefixKVCache,
                                 Request, SchedRequest, ServeEngine)

torch.set_num_threads(1)
GEOM = dict(q_log2=10, r_log2=6)
#: the families and the config fields each is served with
FAMILIES = {"llama32_3b": {}, "minicpm3_4b": {}, "granite_moe_1b": {},
            "mamba2_2p7b": {}, "starcoder2_7b": {"sliding_window": 8}}


def _pair(arch, **kw):
    """(reference cfg, reference params, port cfg, port model): ``arch``'s
    TINY in f16, the port carrying the reference's weights."""
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype="float16",
                               **kw)
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float16",
                              **kw)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _prompts(vocab, prompt_len, shared):
    """Request 0 of its own, 1-3 sharing its first ``shared`` tokens, 4-7
    fresh (the smoke's order, scaled down)."""
    rng = np.random.default_rng(0)
    fresh = lambda n: rng.integers(0, vocab, n).tolist()
    p0 = fresh(prompt_len)
    return ([p0] + [p0[:shared] + fresh(prompt_len - shared)
                    for _ in range(3)]
            + [fresh(prompt_len) for _ in range(4)])


@pytest.mark.parametrize("arch", [a for a, kw in FAMILIES.items()
                                  if not kw])
def test_engine_matches_reference(arch):
    """``ServeEngine`` over a device ``PrefixKVCache`` on both packages:
    identical greedy outputs, cached prefixes and stats. (The windowed
    stack's reference engine decodes without the window: its serve is
    held to the re-prefill above.)"""
    rcfg, params, cfg, model = _pair(arch)
    ssm = "ssm" in cfg.layer_pattern
    prompts = _prompts(cfg.vocab_size, 32 if ssm else 40, 16)
    kw = dict(GEOM, block_tokens=8, capacity_blocks=5)
    rc = RefPrefixKVCache(backend="device", **kw)
    pc = PrefixKVCache(device="cpu", **kw)
    ref = RefServeEngine(rcfg, params, prefix_cache=rc)
    port = ServeEngine(cfg, model, prefix_cache=pc)
    a = [ref.generate(RefRequest(prompt=list(p), max_new_tokens=4))
         for p in prompts]
    b = [port.generate(Request(prompt=list(p), max_new_tokens=4))
         for p in prompts]
    assert [r.output for r in a] == [r.output for r in b]
    assert [r.cached_tokens for r in a] == [r.cached_tokens for r in b]
    assert rc.stats() == pc.stats()
    assert [r.cached_tokens for r in b] == ([0] * 8 if ssm else
                                            [0, 16, 16, 16, 0, 0, 0, 0])
    pc.close()


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_scheduler_matches_reference(arch):
    """The reference scheduler test's prompts through both continuous
    schedulers (device cache; llama32 with 3 slots, the others with 2, as
    ``tests/test_torch_family_scheduler.py``): the same outputs, cached
    prefixes, chunk calls, decode steps and cache stats; the port's
    serial engine's outputs but on the paged MoE stack, whose chunks route
    with their own expert capacity (in the reference too). The windowed
    stack, whose reference scheduler decodes without the window, is held
    to the port's serial engine (held to the reference's re-prefill
    above). So is the SSM stack's greedy ids: the jitted reference's fused
    scan rounds otherwise than its own eager run, and on these prompts
    two top logits lie closer than that, so its jitted ids differ from
    its eager run's, which the port's equal (``tests/helpers/f16_gaps.py
    --scheduler``); its chunk and decode counts, prefixes and stats are
    still the reference scheduler's."""
    rcfg, params, cfg, model = _pair(arch, **FAMILIES[arch])
    rng = np.random.default_rng(2)
    shared = rng.integers(1, cfg.vocab_size, 16).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 9, 0, 16)]
    slots = 3 if arch == "llama32_3b" else 2
    kw = dict(GEOM, block_tokens=16, capacity_blocks=32)
    pc = PrefixKVCache(backend="device", device="cpu", **kw)
    port = ContinuousBatchingScheduler(cfg, model, prefix_cache=pc,
                                       max_slots=slots, max_context=64)
    b = port.run([SchedRequest(prompt=list(p), max_new_tokens=5,
                               request_id=i) for i, p in enumerate(prompts)])
    by_id = lambda done: [(r.output, r.cached_tokens) for r in
                          sorted(done, key=lambda r: r.request_id)]
    whole_prompt = "ssm" in cfg.layer_pattern
    assert [c for _, c in by_id(b)] == (
        [0] * 4 if whole_prompt else
        [0, 0, 0, 16] if slots == 3 else [0, 0, 16, 16])
    if not cfg.sliding_window:
        rc = RefPrefixKVCache(backend="device", **kw)
        ref = RefScheduler(rcfg, params, prefix_cache=rc, max_slots=slots,
                           max_context=64)
        a = ref.run([RefSchedRequest(prompt=list(p), max_new_tokens=5,
                                     request_id=i)
                     for i, p in enumerate(prompts)])
        assert [c for _, c in by_id(a)] == [c for _, c in by_id(b)]
        if not whole_prompt:
            assert by_id(a) == by_id(b)
        assert ((ref.chunk_calls, ref.decode_steps)
                == (port.chunk_calls, port.decode_steps))
        assert rc.stats() == pc.stats()
    serial = [r.output for r in ServeEngine(cfg, model).serve(
        [Request(prompt=list(p), max_new_tokens=5) for p in prompts])]
    assert ([o for o, _ in by_id(b)] == serial) == (
        whole_prompt or cfg.num_experts == 0)
    pc.close()
