"""The PyTorch port imports no JAX and nothing of the JAX package, and its
smoke script refuses to run without CUDA."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import torch

import krylov_robustness_torch

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        krylov_robustness_torch.__path__, "krylov_robustness_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "krylov_robustness_torch.ops.bsr_super" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m.startswith('krylov_robustness_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_never_name_jax():
    for path in (ROOT / "krylov_robustness_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "krylov_robustness_tpu import" not in text, path
        assert "from krylov_robustness_tpu" not in text, path


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        return  # on a card the script runs for real (README)
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
