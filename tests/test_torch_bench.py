"""The port's bench (krylov_robustness_torch/bench.py) on the CPU, at a small
size: its payload carries the root bench.py's keys, the COO lane is accurate
against scipy's f64 product, and the per-step scoring lane returns the JAX
package's Δ on the same candidates in f64 (rtol 1e-9, as
tests/test_torch_trace_update.py holds the host-eigh lane)."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from helpers import random_graph
from krylov_robustness_torch import bench
from krylov_robustness_torch.ops.sparse import CooMatrix
from krylov_robustness_tpu.graphs.top_edges import find_top_edges as jtop
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo
from krylov_robustness_tpu.updates.trace_update import (
    trace_fun_update_edges as jscore,
)
from test_pallas_spmm import banded_graph

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ROOT_BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "greedy_step_ms",
                   "greedy_step_shape", "greedy_scoring_ms")


def _scoring_graph():
    """A connected 200-node graph: a path plus random chords."""
    lil = random_graph(200, 0.04, seed=10).tolil()
    for i in range(199):
        lil[i, i + 1] = lil[i + 1, i] = 1.0
    return sp.csr_matrix(lil)


def test_payload_has_the_root_bench_keys():
    text = (ROOT / "bench.py").read_text()
    for key in ROOT_BENCH_KEYS:
        assert f'"{key}"' in text, key
    payload = bench.run(
        "cpu", spmm_graph=(banded_graph(n=400, weighted=False), "tiny-road"),
        scoring_graph=(_scoring_graph(), "tiny-hub"), b=8, iters=2, Q=12,
        reps=2, fused_k=3, fused_steps=2)
    assert set(payload) == set(ROOT_BENCH_KEYS) | {"card"}
    assert payload["metric"] == "spmm_throughput_tiny-road_b8"
    assert payload["unit"] == "Gnnzb/s" and payload["card"] == "cpu"
    assert payload["vs_baseline"] == 1.0  # the CPU runs the COO lane only
    assert payload["greedy_step_shape"] == "tiny-hub_b12_bs2_fusedR2"
    for key in ("value", "greedy_step_ms", "greedy_scoring_ms"):
        assert np.isfinite(payload[key]) and payload[key] > 0


@pytest.mark.parametrize("b", [1, 16])
def test_coo_lane_is_accurate(b):
    A = banded_graph(n=500, max_off=60, extra=120, weighted=False)
    (row,) = bench.spmm_lanes(A, b, 2, "cpu")
    assert row["lane"] == "coo" and row["unit"] == "ffma"
    assert row["acc"] < bench.ACC_GATE
    assert row["s"] > 0
    # bound: A as CSR (f32 value + int32 index a nonzero, 501 int32 row
    # pointers) + x read + y written, at the HBM rate
    nbytes = A.nnz * (4 + 4) + 501 * 4 + 2 * 500 * b * 4
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == nbytes / (bench.HBM_GBPS * 1e9) * 1e3
    # design: the stored tables (int64 rows and cols, f32 values) in place
    # of CSR, never under the bound
    assert row["design_bytes"] == A.nnz * (8 + 8 + 4) + 2 * 500 * b * 4
    assert row["design_ms"] == bench.speed_of_light_ms(
        row["design_bytes"], 2.0 * A.nnz * b, "ffma")[0]
    assert row["design_ms"] >= row["bound_ms"]


@pytest.mark.parametrize("kind", ["coo", "banded", "flat", "super_bf16x2",
                                  "super_f32", "super_f64"])
def test_bound_counts_the_product_not_the_storage(kind):
    """Every operator's bound counts A's nonzeros as CSR in its value type,
    whatever fill its stored tables carry; its design bytes count the
    tables, and are never fewer. The row gathers (K1–K4) read the CSR
    index plus each entry's value offset, so theirs are the bound's bytes
    plus 4·nnz."""
    from krylov_robustness_torch.ops.banded_spmm import BandedEllOperator
    from krylov_robustness_torch.ops.bsr import BsrOperator
    from krylov_robustness_torch.ops.bsr_super import SuperBsrOperator

    A = banded_graph(n=300, max_off=40, extra=60, weighted=False)
    n, b = A.shape[0], 16
    make = {
        "coo": lambda: CooMatrix.from_scipy(A, dtype=torch.float32,
                                            device="cpu"),
        "banded": lambda: BandedEllOperator(A, dtype=torch.float32,
                                            device="cpu"),
        "flat": lambda: BsrOperator(A, dtype=torch.float32, device="cpu"),
        "super_bf16x2": lambda: SuperBsrOperator(
            A, dtype=torch.float32, device="cpu", mode="bf16x2"),
        "super_f32": lambda: SuperBsrOperator(A, dtype=torch.float32,
                                              device="cpu", mode="f32"),
        "super_f64": lambda: SuperBsrOperator(A, dtype=torch.float64,
                                              device="cpu", mode="f32"),
    }[kind]
    op = make()
    x_size = 8 if kind == "super_f64" else 4
    value_size = {"super_bf16x2": 2, "super_f64": 8}.get(kind, 4)
    got = bench.bounds_ms(op, n, A.nnz, b, x_size, "ffma")
    nbytes = A.nnz * (value_size + 4) + (n + 1) * 4 + 2 * n * b * x_size
    assert bench.function_bytes(op, n, A.nnz, b, x_size) == nbytes
    assert got["bound_ms"] == nbytes / (bench.HBM_GBPS * 1e9) * 1e3
    assert got["design_bytes"] == bench.table_bytes(op) + 2 * n * b * x_size
    assert got["design_ms"] >= got["bound_ms"]
    if kind != "coo":
        assert got["design_bytes"] == nbytes + 4 * A.nnz


def test_scoring_lane_matches_jax_in_f64():
    A = _scoring_graph()
    cent, sigma, tol, top = bench.greedy_protocol(A, 12)
    np.testing.assert_array_equal(top, jtop(A, cent, 12, "min")[:12])
    M = CooMatrix.from_scipy(A, dtype=torch.float64, device="cpu")
    times, r = bench.scoring_lane(M, top, tol, sigma, reps=2)
    assert len(times) == 2 and min(times) > 0
    rj = jscore(JCoo.from_scipy(A), top, sign=-1.0, tol=tol, shift=sigma)
    np.testing.assert_allclose(r.delta.numpy(), np.asarray(rj.delta),
                               rtol=1e-9, atol=1e-12)


def test_graph_builders_fall_back_to_the_stand_ins(monkeypatch, tmp_path):
    """Without the datasets the bench takes the seeded stand-ins at the
    paper graphs' scales (Vermont and ca-AstroPh)."""
    from krylov_robustness_torch.graphs import io as tio

    monkeypatch.setattr(tio, "DEFAULT_DATA_ROOTS", (str(tmp_path),))
    A, name = bench.build_graph()
    assert name == "synthetic-road" and A.shape == (95672, 95672)
    assert A.nnz == 412448 and (A != A.T).nnz == 0
    H, name = bench.greedy_graph()
    assert name == "synthetic-hub" and H.shape == (18772, 18772)
    assert H.nnz == 395524 and (H != H.T).nnz == 0


def test_main_without_cpu_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


def _state(pid: int) -> str:
    return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]


def test_competing_queues_paused_stops_card_runs_of_the_cli(monkeypatch):
    """A process of the paper CLI on the card is stopped inside the context
    and resumed after it; a --cpu run is left alone."""
    monkeypatch.delenv("KRT_BENCH_NO_PAUSE", raising=False)
    sleep = "import time; time.sleep(60)"
    procs = [subprocess.Popen([sys.executable, "-c", sleep,
                               "krylov_robustness_torch.experiments", *extra])
             for extra in ((), ("--cpu",))]
    try:
        time.sleep(0.5)
        with bench.competing_queues_paused():
            assert _state(procs[0].pid) == "T"
            assert _state(procs[1].pid) != "T"
        assert _state(procs[0].pid) != "T"
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)

