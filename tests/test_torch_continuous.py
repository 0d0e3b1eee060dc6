"""The continuous optimizer of the PyTorch port (optimize/continuous.py,
experiments/weighted.py and the CLI's ``weighted`` subcommand) against the
JAX package in f64 on the CPU, on the shapes and seeds of
tests/test_continuous.py, and against dense scipy oracles.

Objective, gradient and Hessian agree with JAX's to RTOL = 1e-9 of their
largest magnitude; the search space is the same (Omega, bounds identical,
f'(A) entries to 1e-10); the optimizer's minimum agrees with JAX's to 1e-6
and with a dense expm evaluation to 1e-5; the paper protocol's scores to
1e-5."""

import csv

import numpy as np
import pytest
import scipy.io
import scipy.linalg
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import krylov_robustness_torch.experiments.weighted as tw
import krylov_robustness_tpu.experiments.weighted as jw
from helpers import random_graph
from krylov_robustness_torch.experiments.__main__ import main
from krylov_robustness_torch.graphs import io as tio
from krylov_robustness_torch.graphs.centrality import compute_centrality
from krylov_robustness_torch.graphs.preprocess import (
    edges_lower,
    preprocess_weighted,
)
from krylov_robustness_torch.interop import continuous_problem_from_arrays
from krylov_robustness_torch.ops.sparse import CooMatrix as TCoo
from krylov_robustness_torch.optimize import continuous as tc
from krylov_robustness_torch.updates.low_rank import weights_to_low_rank
from krylov_robustness_torch.utils.config import WeightedConfig
from krylov_robustness_torch.utils.logging import ResultLog
from krylov_robustness_tpu.graphs import io as jio
from krylov_robustness_tpu.graphs import preprocess as jpre
from krylov_robustness_tpu.graphs.centrality import (
    compute_centrality as j_compute_centrality,
)
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo
from krylov_robustness_tpu.optimize import continuous as jc
from krylov_robustness_tpu.utils.config import WeightedConfig as JConfig
from krylov_robustness_tpu.utils.logging import ResultLog as JResultLog

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

RTOL = 1e-9


def weighted_graph(n, density, seed):
    A = random_graph(n, density, seed=seed, weighted=True)
    return A / np.abs(A).max()


def _pair(A):
    return JCoo.from_scipy(sp.csr_matrix(A)), TCoo.from_scipy(A, device="cpu")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * float(
        np.abs(want).max())


def test_fun_and_grad_matches_jax_and_block_frechet_identity():
    """The reference's gradient debug oracle
    (fun_and_grad_krylov_exp.m:89-112), n = 200, three weighted edges: the
    port's objective and gradient equal JAX's, and −2·trace of the
    top-right block of expm([[A+Δ, E_ij], [0, A+Δ]]) to 1e-5."""
    n = 200
    A = weighted_graph(n, 0.04, seed=9)
    M, T = _pair(A)
    Omega = np.array([[10, 4], [50, 23], [150, 80]])
    Ad = A.toarray()
    F = scipy.linalg.expm(Ad)
    dfA = F[Omega[:, 0], Omega[:, 1]]
    X = np.random.default_rng(2).uniform(0.05, 0.5, size=3)
    fj, gj = jc.fun_and_grad(X, M, Omega, dfA, fun="exp", tol=1e-10)
    ft, gt = tc.fun_and_grad(X, T, Omega, dfA, fun="exp", tol=1e-10)
    assert isinstance(ft, float) and gt.dtype == np.float64
    _close(ft, fj)
    _close(gt, gj)
    U, B, _ = weights_to_low_rank(Omega, X, n)
    At = Ad + U @ B @ U.T
    f_want = -(np.trace(scipy.linalg.expm(At)) - np.trace(F))
    gr_want = np.zeros(3)
    for k, (i, j) in enumerate(Omega):
        C = np.zeros((n, n))
        C[i, j] = 1.0
        big = np.block([[At, C], [np.zeros((n, n)), At]])
        gr_want[k] = -2.0 * np.trace(scipy.linalg.expm(big)[:n, n:])
    np.testing.assert_allclose(ft, f_want, rtol=1e-6)
    np.testing.assert_allclose(gt, gr_want, rtol=1e-5)


def test_fun_and_grad_sinh_matches_dense():
    """f = sinh (the Vermont-scale configuration's): the objective from a
    separate trace_fun_update run (fun_and_grad_krylov_fun.m:64-65) against
    dense eigenvalues, the gradient from fun_update of cosh against
    −2·cosh(A + Δ) at the edges."""
    n = 200
    A = weighted_graph(n, 0.04, seed=9)
    _, T = _pair(A)
    Omega = np.array([[10, 4], [50, 23]])
    Ad = A.toarray()
    dfA = scipy.linalg.coshm(Ad)[Omega[:, 0], Omega[:, 1]]
    X = np.array([0.3, 0.2])
    ft, gt = tc.fun_and_grad(X, T, Omega, dfA, fun="sinh", tol=1e-10)
    U, B, _ = weights_to_low_rank(Omega, X, n)
    At = Ad + U @ B @ U.T
    w0, w1 = np.linalg.eigvalsh(Ad), np.linalg.eigvalsh(At)
    np.testing.assert_allclose(-ft, np.sinh(w1).sum() - np.sinh(w0).sum(),
                               rtol=1e-8)
    np.testing.assert_allclose(
        gt, -2.0 * scipy.linalg.coshm(At)[Omega[:, 0], Omega[:, 1]],
        rtol=1e-8)


def test_fun_and_grad_zero_weights_shortcut():
    n = 80
    A = weighted_graph(n, 0.08, seed=11)
    _, T = _pair(A)
    Omega = np.array([[5, 2], [30, 8]])
    dfA = np.array([0.5, 0.7])
    f_val, gr = tc.fun_and_grad(np.zeros(2), T, Omega, dfA)
    assert f_val == 0.0
    np.testing.assert_allclose(gr, -2 * dfA)
    np.testing.assert_array_equal(
        gr, jc.fun_and_grad(np.zeros(2), JCoo.from_scipy(A), Omega, dfA)[1])


@pytest.mark.parametrize("exact", [True, False])
def test_hessian_matches_jax(exact):
    """The Fréchet Hessian at n = 120 (tests/test_continuous.py), with the
    transpose-probe term (exact) and in the reference's one-term form."""
    A = weighted_graph(120, 0.06, seed=13)
    Omega = np.array([[10, 4], [50, 23]])
    x0 = np.array([0.2, 0.1])
    Hj = jc.hessian(x0, A, Omega, fun="exp", tol=1e-10, exact=exact)
    Ht = tc.hessian(x0, A, Omega, fun="exp", tol=1e-10, exact=exact,
                    device="cpu")
    _close(Ht, Hj)
    np.testing.assert_allclose(Ht, Ht.T, atol=1e-10)


def test_hessian_matches_finite_differences():
    """The exact Hessian against central differences of the port's
    gradient (tests/test_continuous.py's tolerances)."""
    A = weighted_graph(120, 0.06, seed=13)
    _, T = _pair(A)
    Omega = np.array([[10, 4], [50, 23]])
    F = scipy.linalg.expm(A.toarray())
    dfA = F[Omega[:, 0], Omega[:, 1]]
    x0 = np.array([0.2, 0.1])
    H = tc.hessian(x0, A, Omega, fun="exp", tol=1e-10, device="cpu")
    eps = 1e-5
    Hfd = np.zeros((2, 2))
    for k in range(2):
        e = np.zeros(2)
        e[k] = eps
        _, gp = tc.fun_and_grad(x0 + e, T, Omega, dfA, tol=1e-11)
        _, gm = tc.fun_and_grad(x0 - e, T, Omega, dfA, tol=1e-11)
        Hfd[:, k] = (gp - gm) / (2 * eps)
    np.testing.assert_allclose(H, Hfd, rtol=1e-3,
                               atol=1e-6 * np.abs(Hfd).max())


def _problems(method, n=90, seed=17, **kw):
    A = weighted_graph(n, 0.08, seed=seed)
    M, T = _pair(A)
    cj = np.asarray(j_compute_centrality(M, "eig"))
    ct = compute_centrality(T, "eig")
    np.testing.assert_allclose(ct, cj, atol=1e-10)
    args = dict(search_space=20, modifiable_edges=6, total_weight=3.0, **kw)
    return (A, M, T, jc.build_problem(A, M, cj, method, **args),
            tc.build_problem(A, T, ct, method, **args))


@pytest.mark.parametrize("method", ["tuning", "rewire", "add"])
def test_build_problem_matches_jax(method):
    """The search space (tests/test_continuous.py's n = 90, search space
    20, 6 modifiable edges, dense f'(A) below ndense): the same edges and
    bounds, the same f'(A) entries; the per-row Arnoldi entries of larger
    graphs are held in tests/test_torch_frechet.py."""
    _, _, _, pj, pt = _problems(method, tol=1e-10)
    np.testing.assert_array_equal(pt.Omega, pj.Omega)
    np.testing.assert_array_equal(pt.lb, pj.lb)
    np.testing.assert_array_equal(pt.ub, pj.ub)
    assert pt.budget == pj.budget
    _close(pt.dfA, pj.dfA, 1e-10)
    # 'expmv' entries give the same search space
    A, _, T, _, _ = _problems(method)
    pe = tc.build_problem(A, T, compute_centrality(T, "eig"), method,
                          search_space=20, modifiable_edges=6,
                          total_weight=3.0, entries_method="expmv")
    np.testing.assert_array_equal(pe.Omega, pt.Omega)
    _close(pe.dfA, pt.dfA, 1e-8)


@pytest.mark.parametrize("method", ["tuning", "rewire", "add"])
def test_optimize_weights_matches_jax_and_dense(method):
    """trust-constr from the same problem: the port's minimum within 1e-6
    of JAX's and 1e-5 of a dense expm evaluation at its x, x inside the
    bounds and the budget; the JAX problem is carried over with
    ``continuous_problem_from_arrays``."""
    A, M, T, pj, _ = _problems(method)
    pt = continuous_problem_from_arrays(pj.Omega, pj.dfA, pj.lb, pj.ub,
                                        pj.budget)
    rj = jc.optimize_weights(A, M, pj, tol=1e-8, maxiter=50)
    rt = tc.optimize_weights(A, T, pt, tol=1e-8, maxiter=50)
    assert rt.fval < 0
    np.testing.assert_allclose(rt.fval, rj.fval, rtol=1e-6)
    assert np.all(rt.x >= pt.lb - 1e-8) and np.all(rt.x <= pt.ub + 1e-8)
    assert np.sum(rt.x) <= pt.budget + 1e-6
    U, B, _ = weights_to_low_rank(pt.Omega, rt.x, A.shape[0])
    Ad = A.toarray()
    d = np.trace(scipy.linalg.expm(Ad + U @ B @ U.T)) - np.trace(
        scipy.linalg.expm(Ad))
    np.testing.assert_allclose(-rt.fval, d, rtol=1e-5)


def test_carried_weighted_preprocessing_matches_jax():
    """preprocess_weighted and edges_lower are carried over unchanged."""
    rng = np.random.default_rng(6)
    D = rng.uniform(0, 3, size=(30, 30)) * (rng.random((30, 30)) < 0.2)
    np.testing.assert_array_equal(preprocess_weighted(D),
                                  jpre.preprocess_weighted(D))
    A = sp.csr_matrix(preprocess_weighted(D))
    E = edges_lower(A)
    np.testing.assert_array_equal(E, jpre.edges_lower(A))
    assert np.all(E[:, 0] > E[:, 1])


# -- the paper protocol and its CLI -------------------------------------------
GRIDS = {"gridA": (60, 0.12, 21), "gridB": (100, 0.07, 22)}


def _write_grids(root):
    """Two small weighted grids (both under fun_update's n ≤ 130 dense
    fallback) in the layout load_power_grids reads."""
    path = root / "datasets_paper" / "voltage_adjacencies_average_2.mat"
    path.parent.mkdir(parents=True, exist_ok=True)
    grids = {name: random_graph(n, d, seed=s, weighted=True)
             for name, (n, d, s) in GRIDS.items()}
    scipy.io.savemat(str(path), {k: sp.csc_matrix(v)
                                 for k, v in grids.items()})
    return path


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_scores(rows_t, rows_j):
    assert list(rows_t[0]) == list(rows_j[0]) == tw.WEIGHTED_COLUMNS
    assert [(r["dataset"], r["method"]) for r in rows_t] == [
        (r["dataset"], r["method"]) for r in rows_j]
    for rt, rj in zip(rows_t, rows_j):
        assert float(rt["score_pct"]) > 0
        np.testing.assert_allclose(float(rt["score_pct"]),
                                   float(rj["score_pct"]), rtol=1e-5)


def test_run_country_matches_jax(tmp_path):
    """run_country on one stand-in grid read back by load_power_grids:
    the same rows, scores within 1e-5 of JAX's."""
    path = _write_grids(tmp_path / "data")
    D = tio.load_power_grids(path)["gridB"]
    np.testing.assert_array_equal(D, jio.load_power_grids(path)["gridB"])
    cfg = dict(maxiter=20, methods=("tuning", "rewire", "add"))
    log_t = ResultLog(tmp_path / "t", "w", columns=tw.WEIGHTED_COLUMNS,
                      key=("dataset", "method"))
    log_j = JResultLog(tmp_path / "j", "w", columns=jw.WEIGHTED_COLUMNS,
                       key=("dataset", "method"))
    res = tw.run_country(D, "gridB", WeightedConfig(**cfg), log_t,
                         verbose=False, device="cpu")
    jw.run_country(D, "gridB", JConfig(**cfg), log_j, dtype=jnp.float64,
                   verbose=False)
    assert sorted(res) == ["add", "rewire", "tuning"]
    _same_scores(_rows(log_t.csv_path), _rows(log_j.csv_path))


def test_cli_weighted_cpu_matches_jax(tmp_path, monkeypatch):
    """``--cpu weighted`` on a .mat data root, the countries named with
    ``--countries`` (the stand-in holds fewer grids than the paper's
    indices reach): the rows of JAX's run_paper_suite on the same file,
    and a rerun resumes instead of repeating a row."""
    _write_grids(tmp_path / "data")
    monkeypatch.setattr(tio, "DEFAULT_DATA_ROOTS", (str(tmp_path / "data"),))
    monkeypatch.setattr(jio, "DEFAULT_DATA_ROOTS", (str(tmp_path / "data"),))
    argv = ["--cpu", "--out-dir", str(tmp_path / "t"), "weighted",
            "--countries", *GRIDS, "--methods", "add", "--maxiter", "15"]
    assert main(argv) == 0
    _, log_j = jw.run_paper_suite(JConfig(maxiter=15, methods=("add",)),
                                  out_dir=str(tmp_path / "j"),
                                  countries=list(GRIDS), dtype=jnp.float64)
    path = next((tmp_path / "t").glob("results_weighted_exp_lbfgs_*.csv"))
    rows = _rows(path)
    assert len(rows) == 2
    _same_scores(rows, _rows(log_j.csv_path))
    assert main(argv) == 0
    assert _rows(path) == rows


def test_cli_weighted_runs_on_the_card_unless_given_cpu(tmp_path,
                                                        monkeypatch):
    """Without --cpu the weighted subcommand asks for cuda:0: on a machine
    without CUDA it raises before it loads anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _write_grids(tmp_path / "data")
    monkeypatch.setattr(tio, "DEFAULT_DATA_ROOTS", (str(tmp_path / "data"),))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--out-dir", str(tmp_path / "t"), "weighted", "--countries",
              "gridA"])
    assert not (tmp_path / "t").exists()
