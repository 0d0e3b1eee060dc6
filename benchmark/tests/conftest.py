"""CPU tests of the benchmark harness, run from the repo root with
``python -m pytest benchmark/tests -q``. Tests marked ``cuda`` need a card
and skip without one; they run on the card with
``python -m pytest benchmark/tests -q -m cuda``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")
    return torch.device("cuda", 0)


def tiny(workload: str, fused: bool = False):
    """(configuration, mix) of ``workload`` cut to a size a CPU test runs in
    a few seconds: a 600-node road or 400-node hub graph, k = 5 edges from
    Q = 30 candidates on the per-step lane (with ``fused``, fused blocks of
    3 steps: the eager Sturm bisection is slow on the CPU), or 8 optimizer
    iterations."""
    from benchmark.harness import resolve

    _, cfg, mix, _, _ = resolve(workload)
    if cfg["generator"] == "road":
        cfg = dict(cfg, n=600, edges=660, max_chord=30)
    else:
        cfg = dict(cfg, n=400, draws=2400, max_degree=40)
    mix = dict(mix)
    if mix["driver"] == "greedy":
        mix.update(k=5, Q=min(mix["Q"], 30), check_steps=6)
        mix["fused_steps"] = 3 if fused else 0
    else:
        mix.update(maxiter=8)
    return cfg, mix
