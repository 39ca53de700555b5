"""Serial serving engine: prefill + greedy decode with prefix-cache reuse.

Each request first consults the :class:`PrefixKVCache` (counting
flash-hash refcounts) and, on a hit, decodes only the prompt's remainder
from the cached block prefix instead of prefilling. Decoding is one
``decode_step`` per token. Everything runs eagerly under
``torch.inference_mode()`` on the model's device.

Cached values are never written: the pool holds views of a prefill's
caches (``_slicer``), and every cache the engine decodes into comes out
of ``pad_caches``, which always copies. SSM and hybrid stacks have no
slicer (a recurrent state is not cut by position), so only a prompt's
whole-block prefix is registered, as in the reference. Models with a
modality stub get zero frontend embeddings, as the reference's engine
gives them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..models import model as M
from ..models.config import ModelConfig
from .prefix_cache import PrefixKVCache


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    output: Optional[List[int]] = None
    cached_tokens: int = 0


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: M.Model,
                 prefix_cache: Optional[PrefixKVCache] = None):
        # a device table of refcounts must share the model's device; the
        # sim's refcounts live on the host beside any model
        if prefix_cache is not None and prefix_cache.refs is not None:
            refs_dev = prefix_cache.refs.keys.device
            if refs_dev != model.device:
                raise ValueError(f"the prefix cache's refcounts are on "
                                 f"{refs_dev}, the model on {model.device}")
        self.cfg = cfg
        self.model = model
        self.cache = prefix_cache
        self.device = model.device

    def _prefill_one(self, prompt: List[int]):
        """Prefill a single prompt, reusing a cached prefix if available.

        Returns ``(logits, caches, consumed, n_cached, pinned)`` where
        ``n_cached`` is the reused-prefix length in tokens (0 on miss).
        """
        pinned = []
        if self.cache is not None:
            n, value, pinned = self.cache.acquire(prompt)
            if n > 0 and value is not None:
                # cached block prefix: decode only the remainder from it
                caches = M.pad_caches(self.cfg, value, len(prompt))
                consumed = n
                logits = None
                for t in prompt[n:]:
                    logits, caches = self._decode_single(caches,
                                                         t, consumed)
                    consumed += 1
                if logits is None:  # exact full-prompt hit
                    logits, caches = self._decode_single(
                        caches, prompt[-1], consumed - 1)
                return logits, caches, consumed, n, pinned
        tokens = torch.tensor([prompt], dtype=torch.int64, device=self.device)
        logits, caches = self.model.prefill(
            tokens, M.zero_frontend_embeds(self.cfg, self.model))
        if self.cache is not None:
            pinned += self.cache.insert(prompt, caches,
                                        slicer=self._slicer())
        return logits, caches, len(prompt), 0, pinned

    def _slicer(self):
        """Seq-axis cache trimmer (views, not copies) — only for
        pure-attention stacks."""
        if M.has_ssm(self.cfg):
            return None

        def slicer(caches, n):
            return [type(c)(*(x[:, :, :n] for x in c)) for c in caches]
        return slicer

    def _decode_single(self, caches, token: int, index: int):
        tokens = torch.tensor([[token]], dtype=torch.int64,
                              device=self.device)
        return self.model.decode_step(tokens, caches, index)

    def generate(self, req: Request) -> Request:
        with torch.inference_mode():
            logits, caches, consumed, n_cached, pinned = \
                self._prefill_one(req.prompt)
            max_len = consumed + req.max_new_tokens
            caches = M.pad_caches(self.cfg, caches, max_len)
            out = []
            tok = int(torch.argmax(logits[0, -1, :self.cfg.vocab_size]))
            out.append(tok)
            for i in range(req.max_new_tokens - 1):
                logits, caches = self._decode_single(caches, tok,
                                                     consumed + i)
                tok = int(torch.argmax(logits[0, -1, :self.cfg.vocab_size]))
                out.append(tok)
        if self.cache is not None:
            self.cache.release(pinned)
        req.output = out
        req.cached_tokens = n_cached
        return req

    def serve(self, requests: Sequence[Request]) -> List[Request]:
        return [self.generate(r) for r in requests]
