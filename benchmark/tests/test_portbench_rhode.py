"""The RhodeIsland-scale make configuration and its cell
``rhode.make_q50``: the new files load through the harness as they are,
the stand-in at its structure seed has the published graph's node and edge
counts, a Q = 50 make sweep's candidate slots keep its band within the
banded kernel's windows, a traced run at a tiny size on the CPU is correct
and reads the new metric, and the metric reads the window alone and
nothing from a program that does not count its COO products."""

import io
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.generators import preprocess, protocol_inputs, road, \
    run_graph
from benchmark.harness import HERE, ROOT, load_file, resolve, run_cell

CELL = "rhode.make_q50"
READER = "spmm.coo_pct"
SEED = 2**31 + 4242
ROAD_LAYER = ("sweep.step_p90_ms", "scorer.lanczos_steps_per_edge",
              "krylov.device_ms_per_edge", "spectra.self_ms_per_edge",
              "spmm.roofline_pct.greedy", "device.idle_pct.greedy",
              "krylov.useful_step_pct", "sweep.build_ms_per_edge",
              "spmm.operator_mib")


def reader():
    return load_file(HERE / "metrics" / f"{READER}.py",
                     "benchmark_metric_" + READER.replace(".", "_"))


def test_spec_holds_the_cell_its_files_and_the_metric():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, mix, e2e, layer = resolve(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "rhodeisland_road_make", "make_q50", 1)
    (conf,) = [c for c in spec["configs"]
               if c["name"] == "rhodeisland_road_make"]
    assert conf["reduced"] == [] and conf["file"] == \
        "benchmark/configs/rhodeisland_road_make.json"
    assert cfg["generator"] == "road" and cfg["structure_seed"] == 0
    assert mix["driver"] == "greedy_make" and mix["mode"] == "make"
    assert (mix["k"], mix["Q"], mix["dtype"], mix["fused_steps"],
            mix["hub_shift"]) == (50, 50, "float32", 10, False)
    assert "host_threads" not in mix
    assert mix["control"] == "tf32" and mix["limits"]["pick_outside"] == 0
    assert {m["name"] for m in e2e} == {"setup_s", "s_per_edge"}
    names = {m["name"] for m in layer}
    assert set(ROAD_LAYER) | {READER} == names
    (coo,) = [m for m in spec["per_layer"] if m["name"] == READER]
    assert (coo["unit"], coo["better"], coo["source"], coo["layer"],
            coo["moves"], coo["workloads"]) == (
        "%", "lower", "program_counter", "SpMM", "s_per_edge", [CELL])
    assert (HERE / "metrics" / f"{READER}.py").is_file()


def test_stand_in_has_rhodeisland_counts():
    _, cfg, _, _, _ = resolve(CELL)
    A = preprocess(road.make(cfg, cfg["structure_seed"]))
    lam, _ = protocol_inputs(A)
    assert (A.shape[0], A.nnz // 2) == (51642, 66650)
    assert (cfg["n"], cfg["edges"]) == (
        cfg["published"]["n"], cfg["published"]["edges"])
    assert lam == pytest.approx(4.1014, abs=1e-4)
    assert int(np.diff(A.indptr).max()) == 10


def test_make_slots_fit_the_banded_kernel():
    """The cell's Q + k = 100 candidates, both triangles each, under A's
    own RCM order: the band widens and stays within the kernel's windows,
    and K grows from A's largest row."""
    from krylov_robustness_torch.graphs.top_edges import \
        find_top_missing_edges
    from krylov_robustness_torch.ops.banded_spmm import banded_fits, \
        rcm_bandwidth, rcm_permutation
    from krylov_robustness_torch.optimize.greedy import _with_zero_slots

    _, cfg, mix, _, _ = resolve(CELL)
    A = run_graph(cfg, road, SEED)
    _, cent = protocol_inputs(A)
    top = find_top_missing_edges(A, cent, mix["Q"] + mix["k"], "min")
    A_aug = _with_zero_slots(A, top)
    perm = rcm_permutation(A)
    assert A_aug.nnz == A.nnz + 200
    assert rcm_bandwidth(A_aug, perm) >= rcm_bandwidth(A, perm)
    assert banded_fits(A_aug, perm)
    assert int(np.diff(A_aug.indptr).max()) > int(np.diff(A.indptr).max())


def tiny():
    """The cell's configuration and mix cut to a 600-node road graph, k = 5
    edges from Q = 30 missing-edge candidates on the per-step lane (the
    eager Sturm bisection of fused blocks is slow on the CPU), six sampled
    commits."""
    _, cfg, mix, _, _ = resolve(CELL)
    return dict(cfg, n=600, edges=660, max_chord=30), \
        dict(mix, k=5, Q=30, check_steps=6, fused_steps=0)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(trace):
    cfg, mix = tiny()
    rc, line = run_cell(CELL, SEED, 1.0, trace, t_start=time.perf_counter(),
                        device="cpu", need_chips=False, config=cfg, mix=mix,
                        out=io.StringIO())
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    if not trace:
        assert set(line["metrics"]) == {"setup_s", "s_per_edge"}
        return
    # on the CPU 'auto' takes COO, so every product of the window is one
    assert line["metrics"][READER] == {"value": 100.0, "unit": "%"}
    for name in ("krylov.device_ms_per_edge", "spmm.roofline_pct.greedy",
                 "device.idle_pct.greedy"):
        assert name not in line["metrics"]


def test_coo_pct_reads_the_window_alone(monkeypatch):
    from krylov_robustness_torch.utils import tracing

    tracing.count("spmm.launches.coo", 7)  # before the window: not read
    r = reader()
    ctx = SimpleNamespace(readings={})
    assert r.read(ctx) is None  # no product in the window
    tracing.count("spmm.launches.K3", 30)
    assert r.read(ctx) == 0.0
    tracing.count("spmm.launches.coo", 10)
    assert r.read(ctx) == pytest.approx(25.0)
    monkeypatch.setitem(sys.modules, "krylov_robustness_torch.utils.tracing",
                        None)
    assert r.read(ctx) is None


def test_coo_pct_reads_nothing_without_the_counter(monkeypatch):
    """A program that counts its kernels' launches but not its COO
    products (the counter absent from its counters) reads nothing."""
    from krylov_robustness_torch.utils import tracing

    monkeypatch.setattr(tracing, "_counts", {"spmm.launches.K3": 4})
    r = reader()
    tracing.count("spmm.launches.K3", 30)
    assert r.read(SimpleNamespace(readings={})) is None
