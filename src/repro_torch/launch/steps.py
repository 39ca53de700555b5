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

``PLANS`` / :func:`plan_of` are the reference's per-architecture
parallel plans (microbatches sized for ≤ ~1 GB of f32 scores a device at
train_4k; FSDP for the ≥ 40B architectures).

Sharded steps: the same three steps run on a model whose parameters are
DTensors (``sharding.distribute_model`` by ``param_shardings``), with
batches placed by ``batch_shardings`` and moments that take their
parameters' placements (``adamw_init`` allocates them ``zeros_like``).
Run them under :func:`sharded`: the hint rules, and
``implicit_replication`` for the plain tensors the modules build from
global shapes (positions, RoPE angles, causal masks, lane and expert
ranges, the step count and LR). Those constants hold the same value on
every rank, which is what ``Replicate()`` means; turning each into a
DTensor would change every module for no difference in value.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict

import torch
from torch.distributed.tensor.experimental import implicit_replication

from .. import convert
from ..models import model as M
from ..models.config import ModelConfig
from ..models.sharding_hints import hint, use_hints
from ..optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from ..optim.adamw import AdamWState
from .sharding import ParallelPlan

F32 = torch.float32

PLANS: Dict[str, ParallelPlan] = {
    "granite_moe_1b": ParallelPlan(microbatches=1),
    "phi35_moe_42b": ParallelPlan(fsdp=True, microbatches=4),
    "minicpm3_4b": ParallelPlan(microbatches=8),
    "starcoder2_7b": ParallelPlan(microbatches=8),
    "llama32_3b": ParallelPlan(microbatches=4),
    "nemotron4_340b": ParallelPlan(fsdp=True, fsdp_pod=True, microbatches=8),
    "llava_next_mistral_7b": ParallelPlan(microbatches=4),
    "mamba2_2p7b": ParallelPlan(microbatches=1),
    "musicgen_large": ParallelPlan(microbatches=2),
    "jamba15_large_398b": ParallelPlan(fsdp=True, fsdp_pod=True,
                                       microbatches=8),
}


def plan_of(arch: str) -> ParallelPlan:
    return PLANS.get(arch, ParallelPlan())


def abstract_opt_state(cfg: ModelConfig, opt_cfg: AdamWConfig) -> AdamWState:
    """The AdamW state's shapes and dtypes on the ``meta`` device."""
    return adamw_init(opt_cfg, M.abstract_params(cfg))


@contextlib.contextmanager
def sharded(mesh, rules, param_rules=None):
    """The context of a sharded step: :func:`use_hints` on ``mesh`` and
    ``implicit_replication`` (see the module docstring)."""
    with use_hints(mesh, rules, param_rules), implicit_replication():
        yield


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
        grads, loss_sum, n_mb = accumulate_grads(model, batch)
        return apply_grads(model, opt_state, grads, loss_sum, n_mb, opt_cfg,
                           hyper)

    return train_step


def accumulate_grads(model, batch):
    """Gradients summed over the batch's microbatches (leading axis) into
    f32 accumulators → ``(grads by name, summed loss, microbatches)``."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    gsum = {n: torch.zeros_like(p, dtype=F32) for n, p in params.items()}
    loss_sum = torch.zeros((), dtype=F32, device=dev)
    n_mb = batch["tokens"].shape[0]
    for i in range(n_mb):
        loss, _ = model.loss_fn({k: v[i] for k, v in batch.items()})
        add_grads(gsum, params, loss)
        loss_sum = loss_sum + loss.detach()
        del loss
    return gsum, loss_sum, n_mb


def add_grads(gsum, params, loss) -> None:
    """One microbatch's backward: the gradients of ``loss`` by the
    parameters (``name → tensor``), added into the f32 sums ``gsum``. In
    a sharded step every data-parallel reduction of a weight's gradient
    runs here: in f32 where the reference sums in f32 (inside the
    backward, ``sharding_hints.f32_grad_operand`` / ``weight_in_f32``),
    in the weight's type where it sums in that type (a gradient left
    ``Partial`` is reduced as it is added)."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    for n, g in zip(names, grads):
        if g is not None:
            gsum[n].add_(g)


def apply_grads(model, opt_state: AdamWState, gsum, loss_sum, n_mb: int,
                opt_cfg: AdamWConfig, hyper: TrainHyper):
    """The mean gradient, the LR of ``opt_state.count`` and one
    ``adamw_update`` → ``(model, opt_state, metrics)``."""
    params = dict(model.named_parameters())
    grads = {n: g.div_(n_mb) for n, g in gsum.items()}
    lr = cosine_schedule(opt_state.count, peak_lr=hyper.peak_lr,
                         warmup_steps=hyper.warmup_steps,
                         total_steps=hyper.total_steps)
    _, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state, params, lr)
    metrics = {"loss": loss_sum / n_mb, "grad_norm": gnorm, "lr": lr}
    return model, opt_state, metrics


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``(model, batch) → (last-position logits, caches)``, without
    autograd (``no_grad``: DTensor caches refuse inference-mode views)."""
    def prefill_step(model, batch):
        with torch.no_grad():
            return model.prefill(batch["tokens"],
                                 batch.get("frontend_embeds"))
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``(model, caches, tokens, index) → (logits, caches, next token)``:
    greedy (sampling lives in the serving loop)."""
    def decode_step(model, caches, tokens, index):
        with torch.no_grad():
            logits, caches = model.decode_step(tokens, caches, index)
        # a vocab-split argmax is data-dependent: gather the vocab first
        last = hint(logits[:, -1, :], "batch", None)
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        return logits, caches, next_tok
    return decode_step
