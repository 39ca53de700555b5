"""The serial serving path of every model family against the reference's,
on the CPU.

``ServeEngine`` with a device ``PrefixKVCache`` (the reference's Pallas
kernels in interpret mode, the port's plain versions), on ``TINY`` in f32
with the reference's weights (``convert.params_from_numpy``): identical
greedy outputs, cached prefixes and cache stats, for MLA, MoE, SSM,
hybrid and a frontend stub. The attention stacks take the smoke's request
order scaled down (40-token prompts, three sharing the first 16 tokens of
the first); the SSM and hybrid stacks take 32-token prompts (their
``TINY`` chunk) and never reuse a partial prefix, since a recurrent state
is not cut by position (no slicer). The serve CLI's request lines for
``--arch minicpm3-4b --tiny --continuous`` and ``--arch
jamba-1.5-large-398b --tiny`` equal the reference CLI's."""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro.serving import PrefixKVCache as RefPrefixKVCache
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import Model
from repro_torch.serving import PrefixKVCache, Request, ServeEngine

torch.set_num_threads(1)
GEOM = dict(q_log2=10, r_log2=6)


def _models(arch):
    rcfg = dataclasses.replace(ref_config(arch, tiny=True), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, tiny=True), dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _prompts(vocab, prompt_len, shared):
    """Request 0 of its own, 1-3 sharing its first ``shared`` tokens, 4-7
    fresh (the smoke's order)."""
    rng = np.random.default_rng(0)
    fresh = lambda n: rng.integers(0, vocab, n).tolist()
    p0 = fresh(prompt_len)
    return ([p0] + [p0[:shared] + fresh(prompt_len - shared)
                    for _ in range(3)]
            + [fresh(prompt_len) for _ in range(4)])


@pytest.mark.parametrize("arch", ["minicpm3_4b", "granite_moe_1b",
                                  "mamba2_2p7b", "jamba15_large_398b",
                                  "llava_next_mistral_7b"])
def test_engine_matches_reference(arch):
    rcfg, params, cfg, model = _models(arch)
    ssm = "ssm" in cfg.layer_pattern
    prompts = _prompts(cfg.vocab_size, 32 if ssm else 40, 16)
    kw = dict(GEOM, block_tokens=8, capacity_blocks=5)
    rc = RefPrefixKVCache(backend="device", **kw)
    pc = PrefixKVCache(device="cpu", **kw)
    ref = RefServeEngine(rcfg, params, prefix_cache=rc)
    port = ServeEngine(cfg, model, prefix_cache=pc)
    assert (port._slicer() is None) == ssm
    a = [ref.generate(RefRequest(prompt=list(p), max_new_tokens=4))
         for p in prompts]
    b = [port.generate(Request(prompt=list(p), max_new_tokens=4))
         for p in prompts]
    assert [r.output for r in a] == [r.output for r in b]
    cached = [r.cached_tokens for r in b]
    assert [r.cached_tokens for r in a] == cached
    assert rc.stats() == pc.stats()
    s = pc.stats()
    if ssm:
        # only each prompt's whole-block prefix is registered, so a
        # shared first block is never resident on its own
        assert cached == [0] * 8 and (s["hits"], s["misses"]) == (0, 8)
        assert all(len(b.tokens) == 32 for b in pc.store.values())
    else:
        assert cached == [0, 16, 16, 16, 0, 0, 0, 0]
        assert (s["hits"], s["misses"]) == (3, 5) and s["evictions"] > 0
    assert pc._count(list(pc.store)).tolist() == [0] * len(pc.store)
    pc.close()


def test_ssm_exact_prompt_hit_reuses_the_whole_state():
    """A one-block mamba2 prompt served twice: the second hits its only
    block and decodes from the stored recurrent state, leaving the pool's
    value untouched, as the reference does."""
    rcfg, params, cfg, model = _models("mamba2_2p7b")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               8).tolist()
    kw = dict(block_tokens=8, capacity_blocks=4)
    rc = RefPrefixKVCache(backend="sim", **kw)
    pc = PrefixKVCache(backend="sim", **kw)
    ref = RefServeEngine(rcfg, params, prefix_cache=rc)
    port = ServeEngine(cfg, model, prefix_cache=pc)
    a = [ref.generate(RefRequest(prompt=list(prompt), max_new_tokens=4))
         for _ in range(2)]
    b = [port.generate(Request(prompt=list(prompt), max_new_tokens=4))]
    stored = [x.clone() for c in pc._value(next(iter(pc.store)))
              for x in c]
    b.append(port.generate(Request(prompt=list(prompt), max_new_tokens=4)))
    assert [r.output for r in a] == [r.output for r in b]
    assert [r.cached_tokens for r in b] == [0, 8]
    after = [x for c in pc._value(next(iter(pc.store))) for x in c]
    assert all(torch.equal(x, y) for x, y in zip(stored, after))
    assert rc.stats() == pc.stats()


def _cli_outputs(arch, argv, monkeypatch, capsys):
    """The port's and the reference's serve CLI on ``--arch arch`` +
    ``argv`` (``--tiny`` first), the port on the CPU with the reference's
    weights for the seed, f32 on both sides → (port stdout, reference
    stdout)."""
    import repro.launch.serve as ref_cli
    import repro_torch.configs
    import repro_torch.models.model as port_model
    rcfg, params, cfg, _ = _models(arch)
    weights = convert.params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                          params))

    class RefWeights(port_model.Model):
        def __init__(self, c, device="cuda", seed=0):
            super().__init__(c, device=device, seed=seed)
            self.load_state_dict(weights)

    asked = []

    def port_config(a, tiny=False):
        asked.append((a, tiny))
        return cfg

    monkeypatch.setattr(repro_torch.configs, "get_config", port_config)
    monkeypatch.setattr(port_model, "Model", RefWeights)
    assert serve_cli.main(["--arch", arch, *argv, "--device", "cpu"]) == 0
    assert asked == [(arch, True)]
    port_out = capsys.readouterr().out
    monkeypatch.setattr(ref_cli, "get_config", lambda a, tiny=False: rcfg)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, *argv])
    ref_cli.main()
    return port_out, capsys.readouterr().out


def _lines(out, prefix):
    return [x for x in out.splitlines() if x.startswith(prefix)]


@pytest.mark.parametrize("arch, argv, cached", [
    ("minicpm3-4b", ["--tiny", "--continuous"], "cached=16"),
    ("jamba-1.5-large-398b", ["--tiny"], "cached=0")])
def test_serve_cli_matches_reference(arch, argv, cached, monkeypatch,
                                     capsys):
    port_out, ref_out = _cli_outputs(arch, argv, monkeypatch, capsys)
    assert len(_lines(port_out, "req")) == 8
    assert _lines(port_out, "req") == _lines(ref_out, "req")
    assert cached in port_out and "on cpu" in port_out
