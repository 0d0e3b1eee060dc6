"""The soc-Epinions1-scale configuration and the Q = 1000 budget cell: the
stand-in's generator at its structure seed lands within 10% of the
published graph's figures, the new files load through the harness as
they are, and a traced run of each new cell at a tiny size on the CPU
reads the operator's MiB a build, which a program without the counter
leaves unread."""

import io
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.generators import chung_lu_core, preprocess, protocol_inputs
from benchmark.harness import HERE, load_file, resolve, run_cell
from benchmark.tests.conftest import tiny

SEED = 2**31 + 777
# soc-Epinions1 after the paper's preprocessing: nodes, edges, largest
# degree, ‖A‖
TARGETS = (75877, 405739, 3044, 184.0)


def test_stand_in_lands_within_ten_percent_of_soc_epinions1():
    _, cfg, _, _, _ = resolve("epinions.break_q250_perstep")
    A = preprocess(chung_lu_core.make(cfg, cfg["structure_seed"]))
    lam, _ = protocol_inputs(A)
    got = (A.shape[0], A.nnz // 2, int(np.diff(A.indptr).max()), lam)
    for g, want in zip(got, TARGETS):
        assert abs(g - want) <= 0.1 * want, (got, TARGETS)


def test_new_files_load_through_the_harness():
    cell, cfg, mix, e2e, layer = resolve("epinions.break_q250_perstep")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "epinions_hub", "break_q250_perstep", 1)
    assert cfg["generator"] == "chung_lu_core" and mix["fused_steps"] == 0
    assert mix["control"] == "tf32" and mix["limits"]["pick_outside"] == 0
    assert {m["name"] for m in e2e} == {"setup_s", "s_per_edge.hub"}
    assert "spmm.operator_mib.hub" in {m["name"] for m in layer}
    cell, cfg, mix, e2e, layer = resolve("road.break_q1000")
    assert (cell["config"], cell["traffic"]) == ("vermont_road",
                                                 "budget_q1000")
    budget = resolve("road.budget_q50")[2]
    assert {k: v for k, v in mix.items() if k not in ("Q", "protocol",
                                                       "limits")} == \
        {k: v for k, v in budget.items() if k not in ("Q", "protocol",
                                                      "limits")}
    assert mix["Q"] == 1000 and mix["control"] == "tf32"
    assert {m["name"] for m in e2e} == {"setup_s", "s_per_edge"}
    assert "spmm.operator_mib" in {m["name"] for m in layer}


@pytest.mark.parametrize("workload,suffix", [
    ("epinions.break_q250_perstep", ".hub"), ("road.break_q1000", "")])
def test_operator_mib_reads_in_a_traced_run(workload, suffix):
    cfg, mix = tiny(workload)
    rc, line = run_cell(workload, SEED, 1.0, True,
                        t_start=time.perf_counter(), device="cpu",
                        need_chips=False, config=cfg, mix=mix,
                        out=io.StringIO())
    assert rc == 0 and line["correct"]
    mib = line["metrics"][f"spmm.operator_mib{suffix}"]
    assert mib["unit"] == "MiB" and 0 < mib["value"] < 1


def test_operator_mib_reads_the_window_alone(monkeypatch):
    from krylov_robustness_torch.utils import tracing

    tracing.count("spmm.operator_bytes", 3 * 2**20)  # before: not read
    reader = load_file(HERE / "metrics" / "spmm.operator_mib.hub.py",
                       "benchmark_metric_spmm_operator_mib_hub")
    ctx = SimpleNamespace(readings={})
    assert reader.read(ctx) is None  # no build in the window
    tracing.count("sweep.builds", 2)
    tracing.count("spmm.operator_bytes", 5 * 2**20)
    assert reader.read(ctx) == pytest.approx(2.5)
    monkeypatch.setitem(sys.modules, "krylov_robustness_torch.utils.tracing",
                        None)
    assert reader.read(ctx) is None
