"""The port's boundaries: it imports nothing of JAX or of the reference
package, and its entry points run on the card unless told otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import table_torch as tt
from repro_torch.core.store import FlashStore

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "chip_trace.py",
                                          REPO / "chip_serve_ab.py",
                                          REPO / "chip_tfidf_ab.py"]
    assert len(files) > 15
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_no_file_of_the_port_imports_jax_or_the_reference():
    bad = [f"{p.relative_to(REPO)}:{line}: {root}"
           for p in _port_files() for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.data\n"
        "import repro_torch.core.tfidf, repro_torch.core.table_torch\n"
        "import repro_torch.kernels.flash_hash.check\n"
        "import repro_torch.kernels.flash_hash.build\n"
        "import repro_torch.models, repro_torch.models.model\n"
        "import repro_torch.configs, repro_torch.serving\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.kernels.flash_attn.ops\n"
        "import repro_torch.kernels.flash_attn.build\n"
        "import repro_torch.kernels.flash_attn.check\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    cfg = tt.FlashTableConfig(q_log2=10, r_log2=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlashStore.open(q_log2=10, r_log2=6)
    from repro_torch.core.tfidf import TfIdfPipeline
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TfIdfPipeline(q_log2=10, r_log2=6)
    assert tt.init(cfg, device="cpu").keys.device.type == "cpu"


def test_serving_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model, init_caches
    from repro_torch.serving import PrefixKVCache, ServeEngine
    cfg = get_config("llama32_3b", tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_caches(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefixKVCache(q_log2=10, r_log2=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, Model(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--tiny"])
    model = Model(cfg, device="cpu")
    cache = PrefixKVCache(q_log2=10, r_log2=6, device="cpu")
    assert ServeEngine(cfg, model, cache).device.type == "cpu"
    cache.close()


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No card (or no checkout around it): non-zero exit, no result."""
    import shutil
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [subprocess.run([sys.executable, str(lone)], capture_output=True,
                           text=True, env=env, timeout=120, cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py")],
            capture_output=True, text=True, env=env, timeout=120,
            cwd=REPO))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
