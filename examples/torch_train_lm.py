"""End-to-end training driver (PyTorch port): pretrain a reduced model
through the whole stack (deterministic loader, TF-IDF data filter, AdamW,
checkpoint / restart runtime); the twin of ``examples/train_lm.py``. Any
of the 10 architectures via ``--arch``; by default a TINY llama3.2.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
     [--arch mamba2_2p7b] (on the card by default; full-size
     architectures: drop --tiny)
"""
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--steps" not in argv:
        argv += ["--tiny", "--steps", "200"]
    if "--ckpt-dir" not in argv:
        argv += ["--ckpt-dir", tempfile.mkdtemp(prefix="repro_torch_ckpt_")]
    return train_main(argv)


if __name__ == "__main__":
    sys.exit(main())
