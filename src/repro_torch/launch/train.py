"""Training entry point: ``python -m repro_torch.launch.train --arch <id>
[--tiny] [--device cpu]``.

Wires the port's pieces together as the reference's does: config
registry → deterministic loader (with an optional flash-hash TF-IDF
document filter) → train step (remat, microbatch accumulation) → AdamW
→ resilient runtime (watchdog, NaN rollback, checkpoint / restart). It
runs on the card unless ``--device cpu`` is asked for; the weights are
drawn from ``--seed``. With ``--tfidf-filter`` the corpus statistics
live in a device flash-hash table (``CorpusStats``, 2**16 slots in
blocks of 512), whose ingest merges through the hand-written merge
kernel and whose filter queries run the Bloom probe and the lookup
kernel. Prints the reference's ``[stats]``, ``[resume]`` and ``[done]``
lines.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch


@dataclasses.dataclass
class TrainRun:
    """What :func:`run` built and did: the model, its state, the corpus
    statistics (None without ``--tfidf-filter``), the trainer and its
    report, each step's metrics, the wall time."""
    args: argparse.Namespace
    cfg: object
    lcfg: object
    state: object
    stats: object
    expert_stats: object
    trainer: object
    report: object = None
    history: List[dict] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    start: int = 0

    def close(self) -> None:
        for s in (self.stats, self.expert_stats):
            if s is not None:
                s.store.close()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_3b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--tfidf-filter", action="store_true",
                    help="filter documents by flash-hash TF-IDF score")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card by default, 'cpu' for the "
                         "plain versions of the kernels")
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        on_built: Optional[Callable[[TrainRun], None]] = None,
        inject_failure_at: Optional[int] = None, cfg=None) -> TrainRun:
    """Build everything ``args`` asks for, call ``on_built`` (a caller's
    check or change before the first step), train, and print the
    reference's lines. ``inject_failure_at`` makes the trainer fail once
    at that step (a restart from the latest checkpoint follows); ``cfg``
    replaces the ``--arch`` / ``--tiny`` configuration."""
    from ..checkpoint import CheckpointManager, latest_step, restore_checkpoint
    from ..configs import get_config
    from ..core.table_torch import resolve_device
    from ..data import CorpusStats, LoaderConfig, SyntheticCorpus, make_batch
    from ..models.layers import torch_dtype
    from ..models.model import Model
    from ..optim import AdamWConfig, adamw_init
    from ..runtime import NaNGuard, ResilientTrainer, StepWatchdog
    from . import steps as steps_mod

    dev = resolve_device(args.device)
    cfg = cfg or get_config(args.arch, tiny=args.tiny)
    corpus = SyntheticCorpus(num_docs=512, mean_doc_len=args.seq_len,
                             vocab_size=cfg.vocab_size, seed=args.seed)

    doc_filter = None
    stats = None
    if args.tfidf_filter:
        stats = CorpusStats.create(q_log2=16, r_log2=9, device=dev)
        for d in corpus:
            stats.ingest(d)
        stats.flush()
        doc_filter = stats.doc_filter(threshold=0.0)
        print(f"[stats] corpus: {stats.tokens_seen} tokens, "
              f"{stats.docs_seen} docs via flash-hash table", flush=True)

    lcfg = LoaderConfig(
        corpus=corpus, seq_len=args.seq_len, global_batch=args.global_batch,
        microbatches=args.microbatches, vocab_size=cfg.vocab_size,
        num_patches=cfg.num_patches if cfg.frontend != "none" else 0,
        d_model=cfg.d_model, doc_filter=doc_filter)

    opt_cfg = AdamWConfig()
    hyper = steps_mod.TrainHyper(peak_lr=args.peak_lr, warmup_steps=20,
                                 total_steps=args.steps)
    train_step = steps_mod.make_train_step(cfg, opt_cfg, hyper)

    model = Model(cfg, device=dev, seed=args.seed)
    model.requires_grad_(True)
    state = steps_mod.TrainState(
        model, adamw_init(opt_cfg, dict(model.named_parameters())))

    ckpt = CheckpointManager(args.ckpt_dir, every_steps=args.ckpt_every)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        state, meta = restore_checkpoint(args.ckpt_dir, state)
        start = int(meta["step"]) + 1
        print(f"[resume] from step {start}", flush=True)

    expert_stats = (CorpusStats.create(q_log2=12, r_log2=8, device=dev)
                    if cfg.num_experts else None)
    history: List[dict] = []
    dtype = torch_dtype(cfg.dtype)

    def step_fn(state, step):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in make_batch(lcfg, step).items()}
        if cfg.frontend != "none":
            batch["frontend_embeds"] = batch["frontend_embeds"].to(dtype)
        _, state.opt, metrics = train_step(state.model, state.opt, batch)
        history.append({"step": step, **{k: float(v)
                                         for k, v in metrics.items()}})
        return state, metrics

    trainer = ResilientTrainer(
        step_fn, ckpt, NaNGuard(), StepWatchdog(on_straggler=lambda s, t, m:
            print(f"[watchdog] step {s} straggled: {t:.2f}s vs median "
                  f"{m:.2f}s", flush=True)),
        inject_failure_at=inject_failure_at)
    out = TrainRun(args=args, cfg=cfg, lcfg=lcfg, state=state, stats=stats,
                   expert_stats=expert_stats, trainer=trainer,
                   history=history, start=start)
    if on_built is not None:
        on_built(out)

    t0 = time.time()
    # the trainer restores a TrainState in place: ``state`` stays the
    # object ``out`` holds
    _, report = trainer.run(state, num_steps=args.steps, start_step=start)
    dt = time.time() - t0
    out.report, out.wall_s = report, dt
    print(f"[done] steps={report.steps_done} loss={report.final_loss:.4f} "
          f"restarts={report.restarts} rollbacks={report.rollbacks} "
          f"wall={dt:.1f}s "
          f"tok/s={report.steps_done * args.global_batch * args.seq_len / max(dt, 1e-9):.0f}",
          flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parse_args(argv)).close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
