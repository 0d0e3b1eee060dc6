"""CONFIG 5 in the PyTorch port — weighted rewiring of trace(sinh(A)) on the
row-sharded operator (``scripts/config5_sharded_sinh_rewire.py``) — on a
world of one rank, in this process, against the JAX package's
``RowShardedMatrix`` on the conftest's 8-device CPU mesh, the port's
``CooMatrix`` and scipy. ``tests/test_torch_parallel.py`` runs the same
checks on two gloo ranks.

The inputs are those of tests/test_parallel.py's sharded-operator tests
(``random_graph(96, 0.06, seed=3)`` for the plan and entries,
``random_graph(200, 0.04, seed=10)`` for the trace update) and a small
CONFIG 5 problem on ``random_graph(150, 0.04, seed=5)``: search space 12, 6
modifiable edges, maxiter 5, the centrality and ‖A‖ given.

Tolerances: Taylor plans identical; entries of exp/sinh(A) rtol 1e-8, atol
1e-12 against scipy ``expm`` (as the JAX test); expmv rtol 1e-10 of its
largest entry; Δtrace rtol 1e-6 against dense eigenvalues (as the JAX test);
the search space identical, f'(A) entries rtol 1e-10, fval rtol 1e-8, x atol
1e-6; the Hessian rtol 1e-9 of its largest entry."""

import ast
import csv
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import scipy.linalg
import scipy.sparse as sp
import torch

from helpers import random_graph
from krylov_robustness_torch.experiments import config5
from krylov_robustness_torch.funm.expmv import expmv, select_taylor_degree
from krylov_robustness_torch.funm.normest import normest2, normest2_host
from krylov_robustness_torch.graphs import io as tio
from krylov_robustness_torch.graphs.centrality import (
    compute_centrality,
    compute_centrality_host,
)
from krylov_robustness_torch.graphs.preprocess import preprocess_unweighted
from krylov_robustness_torch.ops.sparse import CooMatrix as TCoo
from krylov_robustness_torch.optimize import continuous as tc
from krylov_robustness_torch.parallel import selfcheck
from krylov_robustness_torch.parallel.mesh import (
    from_first_rank,
    make_mesh,
    same_on_every_rank,
)
from krylov_robustness_torch.parallel.spmm_sharded import RowShardedMatrix
from krylov_robustness_tpu.funm import expmv as jexpmv
from krylov_robustness_tpu.graphs import centrality as jcent
from krylov_robustness_tpu.optimize import continuous as jc
from krylov_robustness_tpu.parallel.mesh import make_mesh as j_make_mesh
from krylov_robustness_tpu.parallel.spmm_sharded import (
    RowShardedMatrix as JRowSharded,
)

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "config5_sharded_sinh_rewire.py"


def funm_inputs():
    """Keyword arguments of ``selfcheck.check_sharded_funm``."""
    A = random_graph(96, 0.06, seed=3)
    iu, ju = np.nonzero(np.tril(A.toarray(), -1))
    A_trace = random_graph(200, 0.04, seed=10)
    it, jt = np.nonzero(np.tril(A_trace.toarray(), -1))
    return dict(A=A, X=np.random.default_rng(0).standard_normal((96, 4)),
                omega=np.stack([iu[:5], ju[:5]], axis=1), A_trace=A_trace,
                edges=np.stack([it[:6], jt[:6]], axis=1))


def problem_inputs():
    """Keyword arguments of ``selfcheck.check_config5_problem``."""
    A = preprocess_unweighted(random_graph(150, 0.04, seed=5))
    return dict(A=A, c=compute_centrality_host(A, "eig"),
                nrm=float(normest2_host(A, tol=1e-2)), search_space=12,
                modifiable_edges=6, maxiter=5)


FUNM = funm_inputs()
PROBLEM = problem_inputs()


def jax_funm():
    """The JAX package's plans and degrees on its 8-device mesh."""
    J = JRowSharded.from_scipy(FUNM["A"], j_make_mesh(8))
    plans = {}
    for t in (1.0, -1.0):
        p = jexpmv.select_taylor_degree(J, t=t, b_cols=4)
        plans[t] = (p.m, p.s, p.mu)
    return plans, np.asarray(jcent.degree_centrality(J))


def jax_problem():
    """The JAX package's CONFIG 5 problem and optimum on its 8-device
    mesh."""
    P = PROBLEM
    J = JRowSharded.from_scipy(P["A"], j_make_mesh(8))
    prob = jc.build_problem(
        P["A"], J, P["c"], "rewire", fun="sinh",
        search_space=P["search_space"],
        modifiable_edges=P["modifiable_edges"], heur_order="min",
        total_weight=10.0, ndense=0, tol=1e-6 * float(np.sinh(P["nrm"])),
        entries_method="expmv")
    res = jc.optimize_weights(P["A"], J, prob, fun="sinh", tol=1e-6,
                              maxiter=P["maxiter"], nrmA=P["nrm"])
    return prob, res


def coo_problem():
    """The same problem on the port's ``CooMatrix``: the optimum, the exact
    Hessian at it and two iterations with that Hessian."""
    P = PROBLEM
    T = TCoo.from_scipy(P["A"], device="cpu")
    prob = tc.build_problem(
        P["A"], T, P["c"], "rewire", fun="sinh",
        search_space=P["search_space"],
        modifiable_edges=P["modifiable_edges"], heur_order="min",
        total_weight=10.0, ndense=0, tol=1e-6 * float(np.sinh(P["nrm"])),
        entries_method="expmv")
    kw = dict(fun="sinh", tol=1e-6, nrmA=P["nrm"])
    res = tc.optimize_weights(P["A"], T, prob, maxiter=P["maxiter"], **kw)
    res_h = tc.optimize_weights(P["A"], T, prob, maxiter=2,
                                use_hessian=True, **kw)
    H = tc.hessian(res.x, P["A"], prob.Omega, fun="sinh", tol=1e-6,
                   device="cpu")
    return prob, res, res_h, H


def check_funm(out, jax_plans, jax_degree):
    """One rank's ``check_sharded_funm`` against the CooMatrix plans, the
    JAX mesh's, and scipy."""
    A, X, omega = FUNM["A"], FUNM["X"], FUNM["omega"]
    T = TCoo.from_scipy(A, device="cpu")
    Ad = A.toarray()
    for t in (1.0, -1.0):
        p = select_taylor_degree(T, t=t, b_cols=4)
        assert out["plans"][t] == (p.m, p.s, p.mu) == jax_plans[t]
        want = scipy.linalg.expm(t * Ad) @ X
        np.testing.assert_allclose(out["expmv"][t], want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    E = scipy.linalg.expm(Ad)
    Em = scipy.linalg.expm(-Ad)
    for fun, F in (("exp", E), ("sinh", (E - Em) / 2)):
        np.testing.assert_allclose(out["entries"][fun],
                                   F[omega[:, 0], omega[:, 1]], rtol=1e-8,
                                   atol=1e-12)
    np.testing.assert_array_equal(out["degree"], jax_degree)
    np.testing.assert_array_equal(out["degree"],
                                  np.asarray(A.sum(axis=1)).ravel())
    Ad = FUNM["A_trace"].toarray()
    base = np.sum(np.exp(np.linalg.eigvalsh(Ad)))
    want = []
    for i, j in FUNM["edges"]:
        At = Ad.copy()
        At[i, j] -= 1
        At[j, i] -= 1
        want.append(np.sum(np.exp(np.linalg.eigvalsh(At))) - base)
    np.testing.assert_allclose(out["delta"], want, rtol=1e-6)


def check_problem(out, jax_ref, coo_ref):
    """One rank's ``check_config5_problem`` against JAX's mesh and the
    port's CooMatrix."""
    jprob, jres = jax_ref
    cprob, cres, cres_h, H = coo_ref
    np.testing.assert_array_equal(out["Omega"], jprob.Omega)
    np.testing.assert_array_equal(out["Omega"], cprob.Omega)
    for key in ("lb", "ub"):
        np.testing.assert_array_equal(out[key], getattr(jprob, key))
    np.testing.assert_allclose(out["dfA"], jprob.dfA, rtol=1e-10)
    np.testing.assert_allclose(out["fval"], jres.fval, rtol=1e-8)
    np.testing.assert_allclose(out["x"], jres.x, atol=1e-6)
    assert out["iterations"] == jres.iterations
    np.testing.assert_allclose(out["fval"], cres.fval, rtol=1e-8)
    assert np.abs(out["hessian"] - H).max() <= 1e-9 * np.abs(H).max()
    np.testing.assert_allclose(out["fval_hessian"], cres_h.fval, rtol=1e-8)
    np.testing.assert_allclose(out["x_hessian"], cres_h.x, atol=1e-6)


@pytest.fixture(scope="module")
def jax_refs():
    return dict(funm=jax_funm(), problem=jax_problem(),
                coo=coo_problem())


def test_host_coo_is_the_whole_matrix():
    """Both operators' ``host_coo`` give the whole matrix; the sharded one
    keeps its gathered triple until ``vals`` is edited in place; the ELL
    layout has no COO slots to give."""
    A = FUNM["A"]
    T = TCoo.from_scipy(A, device="cpu")
    rows, cols, vals = T.host_coo()
    assert (sp.csr_matrix((vals, (rows, cols)), shape=A.shape) != A).nnz == 0
    M = RowShardedMatrix.from_scipy(A, make_mesh(device="cpu"))
    first = M.host_coo()
    assert M.host_coo() is first
    rows, cols, vals = first
    assert len(rows) == len(cols) == len(vals) == M.nnz_shard
    assert (sp.csr_matrix((vals, (rows, cols)), shape=A.shape) != A).nnz == 0
    M.vals[0] = 5.0
    assert M.host_coo() is not first and M.host_coo()[2][0] == 5.0
    E = RowShardedMatrix.from_scipy(A, make_mesh(device="cpu"),
                                    layout="ell")
    with pytest.raises(NotImplementedError, match="COO layout"):
        E.host_coo()


def test_sharded_funm_on_one_rank_matches_coo_jax_and_scipy(jax_refs):
    """(select_taylor_degree, expmv, entries_of_f_expmv, degree_centrality,
    trace_fun_update_edges on a world of one.)"""
    out = selfcheck.check_sharded_funm(rank=0, **FUNM)
    check_funm(out, *jax_refs["funm"])


def test_norms_and_centralities_on_one_rank_equal_coo():
    """normest2 and every device centrality read the sharded operator as
    they read the CooMatrix."""
    A = FUNM["A"]
    T = TCoo.from_scipy(A, device="cpu")
    M = RowShardedMatrix.from_scipy(A, make_mesh(device="cpu"))
    assert float(normest2(M)) == float(normest2(T))
    for kind in ("eig", "deg", "pr", "res"):
        np.testing.assert_allclose(compute_centrality(M, kind),
                                   compute_centrality(T, kind), rtol=1e-12)


def test_config5_problem_on_one_rank_matches_jax_and_coo(jax_refs):
    out = selfcheck.check_config5_problem(rank=0, **PROBLEM)
    check_problem(out, jax_refs["problem"], jax_refs["coo"])


def test_rank_agreement_helpers_without_a_process_group():
    """Without process groups there is nothing to compare or broadcast."""
    mesh = make_mesh(device="cpu")
    same_on_every_rank(mesh, "anything", np.arange(3), 1.5)
    same_on_every_rank(None, "anything", 0)
    assert from_first_rank(mesh, lambda: 7) == 7


def _script_columns():
    """The ``columns=[...]`` of the JAX script's ResultLog, read from its
    source (running it would run the whole protocol)."""
    for node in ast.walk(ast.parse(SCRIPT.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id",
                                                  None) == "ResultLog":
            for kw in node.keywords:
                if kw.arg == "columns":
                    return ast.literal_eval(kw.value)
    raise AssertionError("no ResultLog(columns=...) in the script")


def write_transport(root: Path, name: str, A) -> None:
    path = root / "datasets_paper" / "Transport" / f"{name}.mat"
    path.parent.mkdir(parents=True)
    scipy.io.savemat(str(path), {"Problem": {"A": sp.csc_matrix(A)}})


def test_config5_driver_cpu_end_to_end(tmp_path, monkeypatch):
    """``python -m krylov_robustness_torch.experiments.config5 g150 1
    --cpu`` on a .mat data root: one CSV row with the JAX script's columns;
    its score is −fval over a dense trace(sinh(A)) within the Hutchinson
    estimate's tolerance, and fval is the CooMatrix optimum of the script's
    problem."""
    A = PROBLEM["A"]
    write_transport(tmp_path / "data", "g150", A)
    monkeypatch.setattr(tio, "DEFAULT_DATA_ROOTS", (str(tmp_path / "data"),))
    out_dir = tmp_path / "out"
    assert config5.main(["g150", "1", "--cpu", "--out-dir",
                         str(out_dir)]) == 0
    path = next(out_dir.glob("results_config5_sharded_sinh_rewire_*.csv"))
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    assert reader.fieldnames == _script_columns() == config5.CONFIG5_COLUMNS
    assert len(rows) == 1
    row = rows[0]
    assert (row["dataset"], row["n"], row["n_devices"], row["method"],
            row["fun"]) == ("g150", str(A.shape[0]), "1", "rewire", "sinh")
    T = TCoo.from_scipy(A, device="cpu")
    nrm = PROBLEM["nrm"]
    prob = tc.build_problem(
        A, T, PROBLEM["c"], "rewire", fun="sinh", search_space=30,
        modifiable_edges=10, heur_order="min", total_weight=10.0, ndense=0,
        tol=1e-6 * float(np.sinh(nrm)), entries_method="expmv")
    res = tc.optimize_weights(A, T, prob, fun="sinh", tol=1e-6, maxiter=50,
                              nrmA=nrm)
    assert int(row["iterations"]) == res.iterations
    tr_sinh = float(np.sum(np.sinh(np.linalg.eigvalsh(A.toarray()))))
    np.testing.assert_allclose(float(row["score_pct"]),
                               -res.fval / tr_sinh * 100, rtol=1e-2)
    assert float(row["time_build"]) > 0 and float(row["time_opt"]) > 0


def test_config5_driver_checks_the_world_and_the_card(tmp_path,
                                                      monkeypatch):
    """n_devices other than the world size raises; without --cpu the
    driver asks for the card, and on a machine without CUDA raises before it
    writes anything."""
    write_transport(tmp_path / "data", "g150", PROBLEM["A"])
    monkeypatch.setattr(tio, "DEFAULT_DATA_ROOTS", (str(tmp_path / "data"),))
    out_dir = tmp_path / "out"
    with pytest.raises(ValueError, match="n_devices = 2.*world has 1"):
        config5.main(["g150", "2", "--cpu", "--out-dir", str(out_dir)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            config5.main(["g150", "--out-dir", str(out_dir)])
    assert not out_dir.exists()
