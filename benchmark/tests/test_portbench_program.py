"""The per-layer readers of the program's own counters
(``benchmark/program.py``): each new metric file resolves and reads in a
traced run at a tiny size on the CPU, reads the counters' growth over the
window alone, and reads nothing from a program that keeps no counters."""

import io
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark.harness import HERE, load_file, resolve, run_cell
from benchmark.tests.conftest import tiny

NEW = ("krylov.useful_step_pct", "sweep.build_ms_per_edge")
SEED = 2**31 + 4321


def reader(name):
    return load_file(HERE / "metrics" / f"{name}.py",
                     "benchmark_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("workload,suffix", [("road.break_q250", ""),
                                             ("hub.break_q250_perstep",
                                              ".hub")])
def test_new_metrics_read_in_a_traced_run(workload, suffix):
    names = {f"{n}{suffix}" for n in NEW}
    assert names <= {m["name"] for m in resolve(workload)[4]}
    cfg, mix = tiny(workload)
    rc, line = run_cell(workload, SEED, 1.0, True, t_start=time.perf_counter(),
                        device="cpu", need_chips=False, config=cfg, mix=mix,
                        out=io.StringIO())
    assert rc == 0 and line["correct"]
    useful = line["metrics"][f"krylov.useful_step_pct{suffix}"]
    build = line["metrics"][f"sweep.build_ms_per_edge{suffix}"]
    assert (useful["unit"], build["unit"]) == ("%", "ms/edge")
    assert 0 < useful["value"] <= 100
    assert build["value"] > 0


@pytest.mark.parametrize("suffix", ["", ".hub"])
def test_readers_read_the_window_alone(suffix):
    from krylov_robustness_torch.utils import tracing

    tracing.count("krylov.steps_run", 7)  # before the window: not read
    useful = reader(f"krylov.useful_step_pct{suffix}")
    build = reader(f"sweep.build_ms_per_edge{suffix}")
    ctx = SimpleNamespace(readings={"unit": "edge", "units": 5})
    assert useful.read(ctx) is None and build.read(ctx) == 0.0
    tracing.count("krylov.steps_run", 10)
    tracing.count("krylov.steps_used", 4)
    tracing.count("sweep.build_s", 0.5)
    assert useful.read(ctx) == pytest.approx(40.0)
    assert build.read(ctx) == pytest.approx(100.0)
    assert build.read(SimpleNamespace(readings={})) is None


def test_a_program_without_counters_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "krylov_robustness_torch.utils.tracing",
                        None)
    ctx = SimpleNamespace(readings={"unit": "edge", "units": 5})
    for name in NEW:
        for suffix in ("", ".hub"):
            assert reader(name + suffix).read(ctx) is None
