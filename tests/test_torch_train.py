"""The port's train CLI against the reference's, and train checkpoints
across the packages.

``python -m repro_torch.launch.train --tiny --device cpu --tfidf-filter``
and the reference's ``python -m repro.launch.train --tiny
--tfidf-filter`` (TINY llama32 in bf16, the CLIs' own defaults
otherwise) print the same ``[stats]`` line. The two draw their weights
from different generators, so the runs meet through a checkpoint: the
reference trains 2 steps checkpointing every step, and both CLIs
resume its checkpoint and train to step 5 (the port prints the same
``[resume]`` line and a ``[done]`` loss within 1e-4 of the reference's);
then the same the other way round, from a checkpoint the port wrote.
A test marked ``gpu`` holds one TINY train step on the card against the
CPU (skipped without a card)."""
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from repro.launch import train as rtrain
from repro_torch.launch import train

torch.set_num_threads(1)
FLAGS = ["--tiny", "--tfidf-filter", "--seed", "0"]


def _ref_cli(monkeypatch, capsys, *argv):
    monkeypatch.setattr(sys, "argv", ["train", *FLAGS, *argv])
    rtrain.main()
    return capsys.readouterr().out


def _port_cli(capsys, *argv):
    assert train.main([*FLAGS, "--device", "cpu", *argv]) == 0
    return capsys.readouterr().out


def _line(out, tag):
    lines = [ln for ln in out.splitlines() if ln.startswith(tag)]
    assert len(lines) == 1, out
    return lines[0]


def _loss(out):
    return float(re.search(r"loss=(\S+)", _line(out, "[done]")).group(1))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cli_matches_reference_through_a_checkpoint(tmp_path, monkeypatch,
                                                    capsys, writer):
    first = tmp_path / "first"
    second = tmp_path / "second"
    args = ["--steps", "2", "--ckpt-every", "1", "--ckpt-dir", str(first)]
    out = (_ref_cli(monkeypatch, capsys, *args) if writer == "ref"
           else _port_cli(capsys, *args))
    assert "restarts=0 rollbacks=0" in _line(out, "[done]")
    shutil.copytree(first, second)
    more = ["--steps", "5", "--ckpt-every", "100"]
    ref = _ref_cli(monkeypatch, capsys, *more, "--ckpt-dir", str(first))
    port = _port_cli(capsys, *more, "--ckpt-dir", str(second))
    assert _line(port, "[stats]") == _line(ref, "[stats]")
    assert _line(port, "[resume]") == _line(ref, "[resume]") == \
        "[resume] from step 2"
    assert "steps=3 " in _line(port, "[done]")
    assert abs(_loss(port) - _loss(ref)) <= 1e-4


def test_train_cli_runs_on_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--tiny", "--steps", "1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.gpu
def test_one_tiny_train_step_on_the_card_matches_the_cpu(tmp_path):
    """TINY llama32 in f32, the same weights on both devices: one step of
    ``make_train_step`` gives the same loss and grad norm (1e-4 relative)
    and the same parameters (1e-5); TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import LoaderConfig, SyntheticCorpus, make_batch
    from repro_torch.launch import steps as S
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_config("llama32_3b", tiny=True),
                                  dtype="float32")
        corpus = SyntheticCorpus(num_docs=64, mean_doc_len=48,
                                 vocab_size=cfg.vocab_size, seed=1)
        lcfg = LoaderConfig(corpus=corpus, seq_len=32, global_batch=4,
                            microbatches=2, vocab_size=cfg.vocab_size)
        batch = make_batch(lcfg, 0)
        step = S.make_train_step(cfg, AdamWConfig(), S.TrainHyper())
        cpu = Model(cfg, device="cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            model = Model(cfg, device=dev)
            model.load_state_dict(cpu.state_dict())
            model.requires_grad_(True)
            opt = adamw_init(AdamWConfig(), dict(model.named_parameters()))
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            model, opt, m = step(model, opt, b)
            out[dev] = (m, {k: v.detach().cpu()
                            for k, v in model.state_dict().items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(out["cuda"][0][k]),
                                       float(out["cpu"][0][k]), rtol=1e-4)
        for k, v in out["cpu"][1].items():
            np.testing.assert_allclose(out["cuda"][1][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
