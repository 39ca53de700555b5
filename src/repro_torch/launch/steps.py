"""Train / prefill / decode steps of the port.

``train_step(model, opt_state, batch)`` consumes a *pre-microbatched*
batch: tensors shaped ``(microbatches, global_batch / microbatches,
...)``. It accumulates gradients over the leading axis, one
``torch.autograd.grad`` per microbatch in the parameters' dtype, summed
into f32 accumulators and divided by the microbatch count, then takes
the LR from ``cosine_schedule(opt_state.count)`` and applies
``adamw_update``, which writes the parameters and moments in place.
Metrics: ``loss`` (the mean over microbatches), ``grad_norm`` (before
clipping) and ``lr``, as 0-d tensors (no host sync inside the step).

:class:`TrainState` is what the trainer carries and checkpoints: the
model and its AdamW state, saved in the reference's layout
(``params/...``, ``opt/m/...``, ``opt/count``, layers stacked over the
groups) so a train checkpoint of either package resumes in the other.

The reference's per-architecture parallel plans (``PLANS``,
``ParallelPlan``) come with its ``launch/sharding.py`` (ROADMAP.md,
Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from .. import convert
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update, cosine_schedule
from ..optim.adamw import AdamWState

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000


class TrainState:
    """The model (its parameters are updated in place) and its
    ``AdamWState``; a checkpoint tree in the reference's layout
    (``checkpoint_tree`` / ``load_checkpoint_tree``)."""

    def __init__(self, model, opt: AdamWState):
        self.model = model
        self.opt = opt

    def checkpoint_tree(self) -> Dict:
        cfg = self.model.cfg
        return {"params": convert.params_to_host(cfg,
                                                 self.model.state_dict()),
                "opt": convert.opt_state_to_host(cfg, self.opt)}

    @torch.no_grad()
    def load_checkpoint_tree(self, tree: Dict) -> "TrainState":
        """Load a host tree of the saved layout into the model and the
        moments, in place (each tensor keeps its dtype and device)."""
        cfg = self.model.cfg
        self.model.load_state_dict(convert.params_from_numpy(
            cfg, tree["params"]))
        opt = tree["opt"]
        for name in ("m", "v"):
            got = convert.params_from_numpy(cfg, opt[name])
            mine = getattr(self.opt, name)
            if set(got) != set(mine):
                raise KeyError(f"opt/{name}: names differ from the model's "
                               f"({sorted(set(got) ^ set(mine))[:5]} ...)")
            for k, t in mine.items():
                if tuple(got[k].shape) != tuple(t.shape):
                    raise ValueError(f"opt/{name}/{k}: shape "
                                     f"{tuple(got[k].shape)} != "
                                     f"{tuple(t.shape)}")
                t.copy_(got[k])
        self.opt.count.copy_(torch.as_tensor(opt["count"]).reshape(()))
        return self


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    hyper: TrainHyper = TrainHyper()) -> Callable:
    """``(model, opt_state, batch) → (model, opt_state, metrics)``; the
    model's parameters and the moments change in place."""

    def train_step(model, opt_state: AdamWState, batch):
        params = dict(model.named_parameters())
        names = list(params)
        leaves = [params[n] for n in names]
        dev = leaves[0].device
        gsum = {n: torch.zeros(p.shape, dtype=F32, device=dev)
                for n, p in params.items()}
        loss_sum = torch.zeros((), dtype=F32, device=dev)
        n_mb = batch["tokens"].shape[0]
        for i in range(n_mb):
            loss, _ = model.loss_fn({k: v[i] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for n, g in zip(names, grads):
                if g is not None:
                    gsum[n].add_(g)
            loss_sum = loss_sum + loss.detach()
            del grads, loss
        grads = {n: g.div_(n_mb) for n, g in gsum.items()}
        lr = cosine_schedule(opt_state.count, peak_lr=hyper.peak_lr,
                             warmup_steps=hyper.warmup_steps,
                             total_steps=hyper.total_steps)
        _, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state,
                                           params, lr)
        metrics = {"loss": loss_sum / n_mb, "grad_norm": gnorm, "lr": lr}
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``(model, batch) → (last-position logits, caches)``."""
    def prefill_step(model, batch):
        with torch.inference_mode():
            return model.prefill(batch["tokens"],
                                 batch.get("frontend_embeds"))
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``(model, caches, tokens, index) → (logits, caches, next token)``:
    greedy (sampling lives in the serving loop)."""
    def decode_step(model, caches, tokens, index):
        with torch.inference_mode():
            logits, caches = model.decode_step(tokens, caches, index)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return logits, caches, next_tok
    return decode_step
