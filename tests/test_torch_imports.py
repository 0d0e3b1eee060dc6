"""The PyTorch port and its smoke script import no JAX and nothing of the
JAX package, and the smoke script refuses to run without CUDA."""

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
    assert {"krylov_robustness_torch.bench",
            "krylov_robustness_torch.ops.bsr",
            "krylov_robustness_torch.ops.bsr_super",
            "krylov_robustness_torch.ops.banded_spmm",
            "krylov_robustness_torch.ops.cuda_build",
            "krylov_robustness_torch.ops.row_gather",
            "krylov_robustness_torch.experiments.__main__",
            "krylov_robustness_torch.experiments.unweighted",
            "krylov_robustness_torch.experiments.weighted",
            "krylov_robustness_torch.krylov.arnoldi",
            "krylov_robustness_torch.optimize.continuous",
            "krylov_robustness_torch.updates.entries",
            "krylov_robustness_torch.updates.frechet",
            "krylov_robustness_torch.updates.fun_update",
            "krylov_robustness_torch.baselines.miobi",
            "krylov_robustness_torch.baselines.eigenv",
            "krylov_robustness_torch.funm.expmv",
            "krylov_robustness_torch.funm.theta",
            "krylov_robustness_torch.funm.trace",
            "krylov_robustness_torch.graphs.io",
            "krylov_robustness_torch.updates.low_rank",
            "krylov_robustness_torch.utils.checkpoint",
            "krylov_robustness_torch.utils.config",
            "krylov_robustness_torch.utils.logging"} <= set(mods)
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
    for path in [ROOT / "chip_smoke.py",
                 *(ROOT / "krylov_robustness_torch").rglob("*.py")]:
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
