"""The ``trace``, ``parity`` and ``scaling`` benches of the PyTorch port and
their CLI subcommands against the JAX package's, on synthetic graphs
written as ``.mat`` files into a data root under tmp_path.

* Tables: the same CSV columns and JSONL keys, the same dataset keys, n and
  nnz as JAX's.
* ``expmv_parity`` is deterministic: the port's f64 ``expmv`` action equals
  JAX's to 1e-12 relative, and both lie within 1e-12 of scipy ``expm``.
* ``trace_exp`` is a Monte-Carlo estimate whose probes come from a torch
  ``Generator`` (JAX: ``jax.random``), so it is held against the dense
  eigendecomposition, not against JAX's draws. Its ``tol`` bounds the change
  between two iterations, not the error: at tol 1e-4 both packages miss the
  dense trace by up to ~4e-3 on such graphs, so the gate is 1e-2. At the
  tight table's 1e-6 the deflation spans these small graphs (n ≤ 120)
  before it stops, and the estimate is exact to round-off: gate 1e-6.
"""

import csv
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import krylov_robustness_torch.experiments.parity as tparity
import krylov_robustness_torch.experiments.trace_bench as ttrace
import krylov_robustness_tpu.experiments.parity as jparity
import krylov_robustness_tpu.experiments.trace_bench as jtrace
from krylov_robustness_torch.experiments.__main__ import main
from krylov_robustness_torch.funm.expmv import expmv
from krylov_robustness_torch.graphs import io as tio
from krylov_robustness_torch.graphs.preprocess import preprocess_unweighted
from krylov_robustness_torch.ops.sparse import CooMatrix
from krylov_robustness_tpu.funm.expmv import expmv as jax_expmv
from krylov_robustness_tpu.graphs import io as jio
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

# (collection, name, n, chords, seed): connected path-plus-chords graphs
GRAPHS = (("Transport", "toyroad", 90, 40, 1),
          ("Misc", "toyhub", 120, 200, 2))


def _graph(n, chords, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(n - 1)
    src = np.concatenate([i, rng.integers(0, n, chords)])
    dst = np.concatenate([i + 1, rng.integers(0, n, chords)])
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    A = ((A + A.T) > 0).astype(np.float64)
    A.setdiag(0)
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    return A


@pytest.fixture()
def data_root(tmp_path, monkeypatch):
    root = tmp_path / "data"
    for coll, name, n, chords, seed in GRAPHS:
        path = root / "datasets_paper" / coll / f"{name}.mat"
        path.parent.mkdir(parents=True, exist_ok=True)
        scipy.io.savemat(str(path),
                         {"Problem": {"A": sp.csc_matrix(_graph(n, chords,
                                                                seed))}})
    for mod in (tio, jio):
        monkeypatch.setattr(mod, "DEFAULT_DATA_ROOTS", (str(root),))
    return root


DATASETS = [("transport", "toyroad"), ("misc", "toyhub")]


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _jsonl(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _same_table(log_t, log_j):
    ct, cj = _csv(log_t.csv_path), _csv(log_j.csv_path)
    assert list(ct[0]) == list(cj[0])
    jt, jj = _jsonl(log_t.jsonl_path), _jsonl(log_j.jsonl_path)
    assert [set(r) for r in jt] == [set(r) for r in jj]
    for a, b in zip(jt, jj):
        assert (a["dataset"], a["n"], a["nnz"]) == (b["dataset"], b["n"],
                                                    b["nnz"])
    assert log_t.key == log_j.key == ("dataset",)
    return jt, jj


def _dense_trace(A):
    return float(np.sum(np.exp(np.linalg.eigvalsh(A.toarray()))))


def test_trace_bench_matches_jax_table(data_root, tmp_path):
    assert ttrace.TRACE_COLUMNS == jtrace.TRACE_COLUMNS
    out_t, log_t = ttrace.run(datasets=DATASETS, out_dir=tmp_path / "t",
                              verbose=False, device="cpu")
    out_j, log_j = jtrace.run(datasets=DATASETS, out_dir=tmp_path / "j",
                              dtype=jnp.float64, verbose=False)
    jt, _ = _same_table(log_t, log_j)
    assert set(out_t) == set(out_j) == {"toyroad", "toyhub"}
    for row in jt:
        A = preprocess_unweighted(tio.load_misc(row["dataset"])
                                  if row["dataset"] == "toyhub"
                                  else tio.load_transport(row["dataset"]))
        assert np.isfinite(row["trace"])
        rel = abs(row["trace"] - _dense_trace(A)) / _dense_trace(A)
        assert rel <= 1e-2
        assert row["rel_err_vs_dense"] == pytest.approx(rel, rel=1e-9)
    # past the dense cutoff the oracle is skipped, not nan
    _, log = ttrace.run(datasets=DATASETS[:1], out_dir=tmp_path / "c",
                        dense_cutoff=10, verbose=False, device="cpu")
    assert log.rows[0]["rel_err_vs_dense"] == "skipped(n>cutoff)"


def test_expmv_parity_equals_jax(data_root, tmp_path, monkeypatch):
    """The whole-suite function over the synthetic graphs (the suite's
    loaders replaced), then its per-graph row against JAX's action."""
    graphs = [("toyroad", lambda: tio.load_transport("toyroad")),
              ("toyhub", lambda: tio.load_misc("toyhub"))]
    monkeypatch.setattr(tparity, "_paper_graphs", lambda cutoff: graphs)
    monkeypatch.setattr(jparity, "_paper_graphs", lambda cutoff: graphs)
    assert tparity.EXPMV_COLUMNS == jparity.EXPMV_COLUMNS
    out_t, log_t = tparity.run_expmv_parity(out_dir=tmp_path / "t",
                                            verbose=False, device="cpu")
    out_j, log_j = jparity.run_expmv_parity(out_dir=tmp_path / "j",
                                            verbose=False)
    _same_table(log_t, log_j)
    assert set(out_t) == set(out_j) == {"toyroad", "toyhub"}
    for label in out_t:
        assert out_t[label] <= 1e-12 and out_j[label] <= 1e-12
    # the action itself, port against JAX, on the suite's block
    A = preprocess_unweighted(tio.load_misc("toyhub"))
    B = np.random.default_rng(0).standard_normal((A.shape[0], 5))
    got = expmv(CooMatrix.from_scipy(A, device="cpu"),
                torch.as_tensor(B)).numpy()
    want = np.asarray(jax_expmv(JCoo.from_scipy(A), jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    row = tparity.expmv_parity_row("toyhub", A, device="cpu")
    assert row["max_rel_err"] == out_t["toyhub"]
    # a rerun skips the rows it has
    again, _ = tparity.run_expmv_parity(out_dir=tmp_path / "t",
                                        verbose=False, device="cpu")
    assert again == {}


def test_trace_tight_and_f32_lane_match_jax_tables(data_root, tmp_path):
    assert tparity.TRACE_COLUMNS == jparity.TRACE_COLUMNS
    assert tparity.F32_LANE_COLUMNS == jparity.F32_LANE_COLUMNS
    out_t, log_t = tparity.run_trace_tight(datasets=DATASETS,
                                           out_dir=tmp_path / "t",
                                           verbose=False, device="cpu")
    out_j, log_j = jparity.run_trace_tight(datasets=DATASETS,
                                           out_dir=tmp_path / "j",
                                           verbose=False)
    _same_table(log_t, log_j)
    assert all(rel <= 1e-6 for rel in out_t.values())
    lane_t, flog_t = tparity.run_trace_f32_lane(
        datasets=("toyhub",), out_dir=tmp_path / "t", verbose=False,
        device="cpu")
    lane_j, flog_j = jparity.run_trace_f32_lane(
        datasets=("toyhub",), out_dir=tmp_path / "j", verbose=False)
    jt, jj = _same_table(flog_t, flog_j)
    assert jt[0]["platform"] == "cpu" and jt[0]["agree"]
    assert lane_t["toyhub"] < 3e-4


def test_cli_trace_parity_scaling(data_root, tmp_path, monkeypatch):
    """The three subcommands on the CPU with JAX's flags: trace and parity
    write their tables (their suites pointed at the synthetic graphs), and
    scaling prints one JSON line with a rate for the one-rank mesh."""
    monkeypatch.setattr(ttrace, "DEFAULT_DATASETS", DATASETS)
    monkeypatch.setattr(tparity, "_paper_graphs", lambda cutoff: [
        ("toyroad", lambda: tio.load_transport("toyroad"))])
    real_tight, real_lane = tparity.run_trace_tight, tparity.run_trace_f32_lane
    monkeypatch.setattr(tparity, "run_trace_tight", lambda **kw: real_tight(
        datasets=DATASETS[:1], **kw))
    monkeypatch.setattr(tparity, "run_trace_f32_lane",
                        lambda **kw: real_lane(datasets=("toyhub",), **kw))
    out = tmp_path / "out"
    assert main(["--cpu", "--out-dir", str(out), "trace"]) == 0
    assert len(_csv(next(out.glob("results_trace_exp_*.csv")))) == 2
    assert main(["--cpu", "--out-dir", str(out), "parity", "--dense-cutoff",
                 "500", "--trace-tol", "1e-6"]) == 0
    for name in ("expmv_parity", "trace_exp_tight", "trace_f32_lane"):
        assert len(_csv(next(out.glob(f"results_{name}_*.csv")))) == 1
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["--cpu", "scaling", "--dataset", "toyroad", "--batch",
                     "4", "--layout", "ell"]) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["dataset"] == "toyroad" and line["layout"] == "ell"
    assert line["device"] == "cpu" and set(line["rates_nnzb_per_s"]) == {"1"}
    assert line["rates_nnzb_per_s"]["1"] > 0 and \
        line["efficiency"]["1"] == 1.0
