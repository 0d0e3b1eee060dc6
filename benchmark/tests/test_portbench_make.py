"""The make cell (``hub.make_q250``, driver ``greedy_make``) at a tiny size
on the CPU: its result line traced and untraced, the faults its check must
see, and its new reader, ``sweep.candidates_ms_per_edge.hub``, which reads
the window alone and nothing from a program without its counter."""

import dataclasses
import io
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.drivers.greedy_make import make_numbers
from benchmark.harness import HERE, load_file, resolve, run_cell
from benchmark.reference import greedy as ref

CELL = "hub.make_q250"
READER = "sweep.candidates_ms_per_edge.hub"
SEED = 2**31 + 2718


def tiny():
    """The cell's configuration and mix cut to a 400-node hub graph, k = 5
    edges from Q = 30 missing-edge candidates, six sampled commits."""
    _, cfg, mix, _, _ = resolve(CELL)
    return dict(cfg, n=400, draws=2400, max_degree=40), \
        dict(mix, k=5, Q=30, check_steps=6)


def run(trace=False):
    cfg, mix = tiny()
    rc, line = run_cell(CELL, SEED, 1.0, trace, t_start=time.perf_counter(),
                        device="cpu", need_chips=False, config=cfg, mix=mix,
                        out=io.StringIO())
    assert rc == 0
    return line


def reader():
    return load_file(HERE / "metrics" / f"{READER}.py",
                     "benchmark_metric_" + READER.replace(".", "_"))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    line = run(trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert set(line["checks"]) == {"pick_regret", "delta_gap",
                                   "pick_outside"}
    _, _, _, e2e, layer = resolve(CELL)
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in e2e} == \
            {"setup_s", "s_per_edge.hub"}
        return
    names = {m["name"] for m in layer}
    assert READER in names and len(names) == 9
    assert set(line["metrics"]) <= names
    assert line["metrics"][READER]["unit"] == "ms/edge"
    assert line["metrics"][READER]["value"] > 0
    assert 0 < line["metrics"]["krylov.useful_step_pct.hub"]["value"] <= 100
    # a CPU run reports no number under a device metric's name
    for name in ("krylov.device_ms_per_edge.hub",
                 "spmm.roofline_pct.greedy.hub", "device.idle_pct.greedy.hub"):
        assert name not in line["metrics"]


def test_make_numbers_judge_against_the_argmax():
    cands = np.array([[3, 1], [5, 2], [7, 4]])
    d = np.array([2.0, 3.0, 1.0])
    nums = make_numbers(d, cands, (5, 2), 3.0003)
    assert nums["pick_regret"] == 0.0 and nums["pick_outside"] == 0
    assert nums["delta_gap"] == pytest.approx(1e-4)
    nums = make_numbers(d, cands, (7, 4), 3.0)  # the argmin, for make
    assert nums["pick_regret"] == pytest.approx(2 / 3)
    h, neg = ref.swapped_pick(-d)
    assert (h, -neg) == (2, 3.0)


def _pick_swapped(monkeypatch):
    """Scores right, the commit off by one from the argmax: the scorer
    hands the sweep its scores shifted by one place."""
    from krylov_robustness_torch.optimize import greedy

    real = greedy.trace_fun_update_edges

    def swapped(*a, **k):
        r = real(*a, **k)
        return dataclasses.replace(r, delta=torch.roll(r.delta, 1))

    monkeypatch.setattr(greedy, "trace_fun_update_edges", swapped)


class _ArgminNumpy:
    """NumPy, with ``argmax`` answering ``argmin``."""

    argmax = staticmethod(np.argmin)

    def __getattr__(self, name):
        return getattr(np, name)


def _argmin_committed(monkeypatch):
    """A make sweep that commits the least Δ, as a break sweep would."""
    from krylov_robustness_torch.optimize import greedy

    monkeypatch.setattr(greedy, "np", _ArgminNumpy())


@pytest.mark.parametrize("fault", [_pick_swapped, _argmin_committed])
def test_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    assert not run()["correct"]


def test_reader_reads_the_window_alone():
    from krylov_robustness_torch.utils import tracing

    tracing.count("sweep.candidates_s", 3.0)  # before the window: not read
    r = reader()
    ctx = SimpleNamespace(readings={"unit": "edge", "units": 4})
    assert r.read(ctx) == 0.0
    tracing.count("sweep.candidates_s", 0.002)
    assert r.read(ctx) == pytest.approx(0.5)
    assert r.read(SimpleNamespace(readings={})) is None


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    ctx = SimpleNamespace(readings={"unit": "edge", "units": 5})
    monkeypatch.setitem(sys.modules, "krylov_robustness_torch.utils.tracing",
                        None)
    assert reader().read(ctx) is None
    monkeypatch.undo()
    # a program that keeps counters, but not this one
    fake = SimpleNamespace(counters=lambda: {"sweep.build_s": 1.0})
    monkeypatch.setitem(sys.modules, "krylov_robustness_torch.utils.tracing",
                        fake)
    assert reader().read(ctx) is None
