"""Serving example (PyTorch port): batched greedy decoding with the
flash-hash prefix KV cache (counting refcounts), through the port's
serve CLI; the twin of ``examples/serve_lm.py``.

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
(on the card by default; any ``launch/serve.py`` flag passes through)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv += ["--arch", "llama32_3b", "--tiny", "--requests", "8",
                 "--prompt-len", "32", "--shared-prefix", "24",
                 "--max-new", "8"]
    return serve_main(argv)


if __name__ == "__main__":
    sys.exit(main())
