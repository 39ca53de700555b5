"""The continuous-batching scheduler on every new model family against the
reference's scheduler, on the CPU.

MLA (minicpm3) and MoE (granite) stacks run the paged path: chunked
prefill into the block pool, MLA paging its latent and roped-key blocks.
SSM (mamba2) and hybrid (jamba) stacks take the whole-prompt fallback:
no chunk call, no cached prefix, packed decode over the recurrent state.
On ``TINY`` in f32 with the reference's weights, with the refcounts in
the sim and on the device backend (``device="cpu"``), the port gives the
reference scheduler's outputs, cached prefixes, chunk and decode counts
and cache stats. Outputs equal the serial engine's except on the paged
MoE stack, where a chunk of 16 tokens routes with its own expert capacity
(the reference scheduler differs from its serial engine the same way);
jamba's MoE layers see whole prompts, as in the serial engine."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro.serving import ContinuousBatchingScheduler as RefScheduler
from repro.serving import PrefixKVCache as RefPrefixKVCache
from repro.serving import SchedRequest as RefSchedRequest
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serving import (ContinuousBatchingScheduler, PrefixKVCache,
                                 Request, SchedRequest, ServeEngine)

torch.set_num_threads(1)
GEOM = dict(q_log2=10, r_log2=6)


def _pair(arch):
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = M.Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _prompts(vocab, shared_tokens=16, suffixes=(5, 9, 0, 16), seed=2):
    """The reference scheduler test's prompts (``tests/test_serving.py``):
    a shared 16-token block, one prompt exactly that block."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, vocab, size=shared_tokens)]
    return [shared + [int(t) for t in rng.integers(1, vocab, size=n)]
            for n in suffixes]


def _by_id(done):
    done = sorted(done, key=lambda r: r.request_id)
    return [r.output for r in done], [r.cached_tokens for r in done]


@pytest.mark.parametrize("backend", ["sim", "device"])
@pytest.mark.parametrize("arch", ["minicpm3_4b", "granite_moe_1b",
                                  "mamba2_2p7b", "jamba15_large_398b"])
def test_scheduler_matches_reference(arch, backend):
    rcfg, params, cfg, model = _pair(arch)
    prompts = _prompts(cfg.vocab_size)
    kw = dict(block_tokens=16, capacity_blocks=32,
              **(GEOM if backend == "device" else {}))
    rc = RefPrefixKVCache(backend=backend, **kw)
    pc = PrefixKVCache(backend=backend, device="cpu", **kw)
    ref = RefScheduler(rcfg, params, prefix_cache=rc, max_slots=2,
                       max_context=64)
    port = ContinuousBatchingScheduler(cfg, model, prefix_cache=pc,
                                       max_slots=2, max_context=64)
    a = ref.run([RefSchedRequest(prompt=list(p), max_new_tokens=5,
                                 request_id=i)
                 for i, p in enumerate(prompts)])
    b = port.run([SchedRequest(prompt=list(p), max_new_tokens=5,
                               request_id=i) for i, p in enumerate(prompts)])
    assert _by_id(a) == _by_id(b)
    outputs, cached = _by_id(b)
    assert ((ref.chunk_calls, ref.decode_steps)
            == (port.chunk_calls, port.decode_steps))
    assert rc.stats() == pc.stats()
    serial = [r.output for r in ServeEngine(cfg, model).serve(
        [Request(prompt=list(p), max_new_tokens=5) for p in prompts])]
    whole_prompt = "ssm" in cfg.layer_pattern
    if whole_prompt:
        assert port.chunk_calls == 0 and cached == [0] * 4
        assert not pc.store
    else:
        assert port.chunk_calls > 0 and cached == [0, 0, 16, 16]
    # chunked MoE routes each chunk with its own expert capacity
    assert (outputs == serial) == (whole_prompt or cfg.num_experts == 0)
    pc._refs.flush()
    assert pc._count(list(pc.store)).tolist() == [0] * len(pc.store)
    pc.close()


def test_mla_pages_latent_blocks_that_survive_their_slot():
    """One slot, three MLA requests: the pool holds (latent, roped key)
    segments of one block each; reusing the slot leaves them bit-equal,
    and serving the first prompt again from them reproduces its output."""
    _, _, cfg, model = _pair("minicpm3_4b")
    rng = np.random.default_rng(6)
    p0 = rng.integers(1, cfg.vocab_size, 40).tolist()
    p1 = p0[:16] + rng.integers(1, cfg.vocab_size, 30).tolist()
    p2 = rng.integers(1, cfg.vocab_size, 40).tolist()
    cache = PrefixKVCache(backend="sim", block_tokens=16, capacity_blocks=32)
    sched = ContinuousBatchingScheduler(cfg, model, prefix_cache=cache,
                                        max_slots=1, max_context=64)
    first = sched.run([SchedRequest(prompt=p0, max_new_tokens=6)])[0]
    seg = cache._value(next(iter(cache.store)))
    assert [tuple(x.shape) for x in seg[0]] == [
        (cfg.num_groups, 1, 16, cfg.kv_lora_rank),
        (cfg.num_groups, 1, 16, cfg.qk_rope_dim)]
    stored = {k: [x.clone() for c in cache._value(k) for x in c]
              for k in cache.store}
    sched.run([SchedRequest(prompt=p, max_new_tokens=6) for p in (p1, p2)])
    for k, before in stored.items():
        after = [x for c in cache._value(k) for x in c]
        assert all(torch.equal(x, y) for x, y in zip(before, after))
    again = sched.run([SchedRequest(prompt=p0, max_new_tokens=6)])[-1]
    assert again.cached_tokens == 32 and again.output == first.output


def test_ssm_fallback_takes_prompts_the_paged_path_would_refuse():
    """The whole-prompt fallback pads nothing: a 17-token prompt with 7 new
    tokens fits 24 rows of context (the paged path would pad it to 32)."""
    rcfg, params, cfg, model = _pair("mamba2_2p7b")
    prompt = _prompts(cfg.vocab_size, shared_tokens=17, suffixes=(0,))[0]
    ref = RefScheduler(rcfg, params, max_slots=1, max_context=24)
    port = ContinuousBatchingScheduler(cfg, model, max_slots=1,
                                       max_context=24)
    a = ref.run([RefSchedRequest(prompt=prompt, max_new_tokens=7)])
    b = port.run([SchedRequest(prompt=prompt, max_new_tokens=7)])
    assert a[0].output == b[0].output and len(b[0].output) == 7
