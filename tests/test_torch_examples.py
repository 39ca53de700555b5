"""CPU smoke tests of the port's example twins (``examples/torch_*.py``):
each runs to its end with ``--device cpu`` and prints what its JAX twin
prints."""
import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"ex_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    _load("torch_quickstart").main(["--device", "cpu", "--tokens", "20000"])
    out = capsys.readouterr().out
    for backend in ("sim", "device", "sharded"):
        assert f"{backend:8s} 512 point queries correct: True" in out


def test_tfidf_pipeline(capsys):
    _load("torch_tfidf_pipeline").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "top keywords of doc 0:" in out
    assert "filtered batch ready: tokens (1, 4, 128)" in out


def test_serve_lm(capsys):
    assert _load("torch_serve_lm").main(
        ["--tiny", "--device", "cpu", "--requests", "3", "--prompt-len",
         "16", "--shared-prefix", "8", "--max-new", "4"]) == 0
    assert capsys.readouterr().out


def test_serve_quickstart(capsys):
    _load("torch_serve_quickstart").main(["--device", "cpu",
                                          "--requests", "4"])
    out = capsys.readouterr().out
    assert "blocks resident=" in out


def test_train_lm(tmp_path, capsys):
    assert _load("torch_train_lm").main(
        ["--tiny", "--steps", "3", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck"), "--ckpt-every", "2"]) == 0
    assert capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_lm",
                                  "torch_serve_quickstart",
                                  "torch_tfidf_pipeline", "torch_train_lm"])
def test_examples_default_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    assert "[--device cpu]" in (EXAMPLES / f"{name}.py").read_text()
    argv = {"torch_serve_lm": ["--tiny"],
            "torch_train_lm": ["--tiny", "--steps", "1", "--ckpt-dir",
                               str(tmp_path)]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)
