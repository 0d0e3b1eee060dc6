"""The paper driver of the PyTorch port (experiments/, the CLI, the carried
loaders, logs and checkpoints) against the JAX package on the CPU, on the
small graph of tests/test_experiments.py.

Picks (GKB, MIOBI, EIGENV) and intersections are identical; CSV and JSONL
carry the same columns; tr_variation agrees to 1e-3 relative, because the
device normalizer trace(exp(A)) is a stochastic estimate (tolerance 1e-4)
whose probes come from torch.Generator in the port and jax.random in JAX."""

import csv
import json

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import krylov_robustness_torch.experiments.unweighted as tuw
import krylov_robustness_tpu.experiments.unweighted as juw
from helpers import random_graph
from krylov_robustness_torch.experiments.__main__ import NOT_PORTED, main
from krylov_robustness_torch.graphs import io as tio
from krylov_robustness_torch.graphs.centrality import compute_centrality
from krylov_robustness_torch.ops.sparse import CooMatrix
from krylov_robustness_torch.optimize.greedy import greedy_krylov
from krylov_robustness_torch.utils.checkpoint import GreedyCheckpoint
from krylov_robustness_torch.utils.config import UnweightedConfig
from krylov_robustness_torch.utils.logging import ResultLog
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo
from krylov_robustness_tpu.utils.config import UnweightedConfig as JConfig
from krylov_robustness_tpu.utils.logging import ResultLog as JResultLog
from test_experiments import small_graph

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

RTOL_TR = 1e-3


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _jsonl_rows(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _same_rows(log_t, log_j, key):
    """Same keys, same columns in CSV and JSONL, tr_variation to RTOL_TR."""
    ct, cj = _csv_rows(log_t.csv_path), _csv_rows(log_j.csv_path)
    assert list(ct[0]) == list(cj[0])
    jt, jj = _jsonl_rows(log_t.jsonl_path), _jsonl_rows(log_j.jsonl_path)
    assert [set(r) for r in jt] == [set(r) for r in jj]
    assert [[r[k] for k in key] for r in jt] == [[r[k] for k in key]
                                                  for r in jj]
    for a, b in zip(jt, jj):
        np.testing.assert_allclose(a["tr_variation"], b["tr_variation"],
                                   rtol=RTOL_TR)
        assert a["norm_lane"] == b["norm_lane"] == "device-float64"
    return jt


@pytest.mark.parametrize("mode", ["break", "make"])
def test_run_dataset_matches_jax(mode, tmp_path):
    A = small_graph()
    kw = dict(k=3, Q=15, mode=mode, miobi_eigs=8)
    lj = JResultLog(tmp_path / "jax", "t", key=("method", "dataset"))
    lt = ResultLog(tmp_path / "torch", "t", key=("method", "dataset"))
    oj = juw.run_dataset(A, "tiny", JConfig(**kw), lj, verbose=False)
    ot = tuw.run_dataset(A, "tiny", UnweightedConfig(**kw), lt,
                         verbose=False, device="cpu")
    np.testing.assert_array_equal(ot["greedy"].edges, oj["greedy"].edges)
    np.testing.assert_array_equal(ot["miobi"].edges, oj["miobi"].edges)
    np.testing.assert_array_equal(ot["eigenv_edges"], oj["eigenv_edges"])
    assert ot["intersections"] == oj["intersections"]
    np.testing.assert_allclose(ot["nrm"], oj["nrm"], rtol=1e-12)
    np.testing.assert_allclose(ot["trexp"], oj["trexp"], rtol=RTOL_TR)
    rows = _same_rows(lt, lj, ("method", "dataset", "searchspace_size",
                               "centrality_order", "budget_size"))
    assert {r["method"] for r in rows} == {
        f"GREEDY_KRYLOV_{mode.upper()}", "MIOBI", "EIGENV"}


def test_budget_sweep_matches_jax(tmp_path, monkeypatch):
    A = small_graph()
    monkeypatch.setattr(juw, "load_transport", lambda name: A)
    monkeypatch.setattr(tuw, "load_transport", lambda name: A)
    kw = dict(budgets=[2, 4], search_spaces=[6, 10], mode="break", tol=1e-6)
    oj, lj = juw.run_budget_sweep(["toy"], out_dir=tmp_path / "jax", **kw)
    ot, lt = tuw.run_budget_sweep(["toy"], out_dir=tmp_path / "torch",
                                  device="cpu", **kw)
    assert set(ot) == set(oj) == {("toy", 6), ("toy", 10)}
    for key in oj:
        np.testing.assert_array_equal(ot[key].edges, oj[key].edges)
    rows = _same_rows(lt, lj, ("method", "dataset", "searchspace_size",
                               "budget_size"))
    assert len(rows) == 4
    assert all(r["time"] > 0 and r["tr_variation"] < 0 for r in rows)


def _write_mat(root, collection, name, A):
    """A v5 .mat in the loader's layout: a Problem struct holding A."""
    path = root / "datasets_paper" / collection / f"{name}.mat"
    path.parent.mkdir(parents=True, exist_ok=True)
    scipy.io.savemat(str(path), {"Problem": {"A": sp.csc_matrix(A)}})
    return path


def test_cli_budget_reads_a_mat_root(tmp_path, monkeypatch):
    """The CLI's budget subcommand on a .mat data root: the loader reads the
    struct back, and the sweep writes one row per budget."""
    A = small_graph()
    _write_mat(tmp_path / "data", "Transport", "toy", A)
    monkeypatch.setattr(tio, "DEFAULT_DATA_ROOTS", (str(tmp_path / "data"),))
    assert (tio.load_transport("toy") != A).nnz == 0
    out = tmp_path / "out"
    assert main(["--cpu", "--out-dir", str(out), "budget", "--mode", "break",
                 "--datasets", "toy", "--search-spaces", "6",
                 "--budgets", "2", "4"]) == 0
    rows = _csv_rows(next(out.glob("results_unweighted_break_budget_*.csv")))
    assert [int(r["budget_size"]) for r in rows] == [2, 4]
    assert all(float(r["time"]) > 0 and float(r["tr_variation"]) < 0
               for r in rows)


def test_cli_unweighted_reads_a_misc_root(tmp_path, monkeypatch):
    """The unweighted subcommand routes a dataset found under Misc/ to the
    Misc loader and writes the three method rows and the intersections."""
    _write_mat(tmp_path / "data", "Misc", "hub", small_graph())
    monkeypatch.setattr(tio, "DEFAULT_DATA_ROOTS", (str(tmp_path / "data"),))
    out = tmp_path / "out"
    assert main(["--cpu", "--out-dir", str(out), "unweighted", "--mode",
                 "break", "--datasets", "hub", "--k", "2", "--Q", "10"]) == 0
    rows = _jsonl_rows(next(out.glob("results_unweighted_break_2*.jsonl")))
    assert [r["method"] for r in rows] == ["GREEDY_KRYLOV_BREAK", "MIOBI",
                                           "EIGENV"]
    assert all(r["tr_variation"] < 0 and r["norm_lane"] == "device-float64"
               for r in rows)
    inter = _csv_rows(next(out.glob(
        "results_unweighted_break_intersections_*.csv")))
    assert len(inter) == 1 and inter[0]["dataset"] == "hub"


def test_cli_runs_on_the_card_unless_given_cpu(tmp_path, monkeypatch):
    """Without --cpu the CLI asks for cuda:0: on a machine without CUDA it
    raises before it loads anything, and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _write_mat(tmp_path / "data", "Transport", "toy", small_graph())
    monkeypatch.setattr(tio, "DEFAULT_DATA_ROOTS", (str(tmp_path / "data"),))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--out-dir", str(out), "budget", "--mode", "break",
              "--datasets", "toy", "--search-spaces", "6", "--budgets", "2"])
    assert not out.exists()


@pytest.mark.parametrize("cmd", sorted(NOT_PORTED))
def test_not_ported_subcommands_raise(cmd):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main([cmd, "--any", "flags"])


def test_run_paper_suite_resume_and_force(tmp_path, monkeypatch):
    """A completed dataset is skipped on rerun; ``force`` regenerates it
    with a keyed replace (tests/test_experiments.py's JAX check)."""
    A = small_graph()
    calls = []
    monkeypatch.setattr(tuw, "load_transport",
                        lambda name: calls.append(name) or A)
    monkeypatch.setattr(tuw, "_misc_path_exists", lambda name: False)
    cfg = UnweightedConfig(k=2, Q=10, mode="break", miobi_eigs=8)
    for force in (False, False, True):
        tuw.run_paper_suite(cfg, out_dir=tmp_path, datasets=["mock"],
                            force=force, device="cpu")
    assert calls == ["mock", "mock"]
    log = ResultLog(tmp_path, "unweighted_break", key=("method", "dataset"))
    assert len(log) == 3


def test_checkpoint_resume(tmp_path):
    """A sweep killed after 2 steps resumes from the carried GreedyCheckpoint
    and equals the uninterrupted sweep; the file is cleared at the end."""
    A = small_graph()
    c = compute_centrality(CooMatrix.from_scipy(A, device="cpu"), "eig")
    kw = dict(order="min", tol=1e-8, mode="break", device="cpu")
    full = greedy_krylov(A, 4, 12, c, **kw)
    ck = GreedyCheckpoint(tmp_path / "ck.json", fingerprint={"k": 4})
    ck.save("tiny", 2, [tuple(e) for e in full.edges[:2]],
            float(np.sum(full.per_step_delta[:2])),
            extra={"deltas": full.per_step_delta[:2].tolist(),
                   "iters": full.per_step_iters[:2].tolist()})
    assert GreedyCheckpoint(tmp_path / "ck.json",
                            fingerprint={"k": 5}).load("tiny") is None
    resumed = greedy_krylov(A, 4, 12, c, checkpoint=ck, dataset="tiny", **kw)
    np.testing.assert_array_equal(resumed.edges, full.edges)
    np.testing.assert_allclose(resumed.rob_variation, full.rob_variation,
                               rtol=1e-12)
    assert not (tmp_path / "ck.json").exists()


def test_rescore_edges_matches_jax():
    """A joint edit of 4 disjoint edges scores with block size 8 through the
    host-eigh lane (n = 200): equal to JAX's rescore to rtol 1e-9."""
    A = random_graph(200, 0.04, seed=10)
    C = sp.coo_matrix(sp.tril(A, -1))
    E, used = [], set()
    for i, j in zip(C.row, C.col):
        if not {i, j} & used:
            E.append((i, j))
            used |= {i, j}
        if len(E) == 4:
            break
    E = np.asarray(E)
    tol = 1e-9 * float(np.exp(np.linalg.eigvalsh(A.toarray()).max()))
    got = tuw.rescore_edges(CooMatrix.from_scipy(A, device="cpu"), E, -1.0,
                            tol)
    want = juw.rescore_edges(JCoo.from_scipy(A), E, -1.0, tol)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_result_log_files_equal_jax(tmp_path):
    """The carried ResultLog writes byte-identical CSV and JSONL."""
    cols = ["dataset", "method", "score"]
    logs = [cls(tmp_path / name, "kr", columns=cols, key=("dataset",
                                                          "method"))
            for cls, name in ((ResultLog, "t"), (JResultLog, "j"))]
    for log in logs:
        log.append(dataset="a", method="tuning", score=1.5,
                   extra=np.float64(2.0))
        log.append(dataset="a", method="rewire", score=2)
        log.append(dataset="a", method="tuning", score=3.0)
    assert len(logs[0]) == len(logs[1]) == 2
    for attr in ("csv_path", "jsonl_path"):
        t, j = (getattr(log, attr) for log in logs)
        assert t.name == j.name and t.read_text() == j.read_text()
