"""Continuous robustness optimization: tuning / rewire / add of edge weights
— port of ``krylov_robustness_tpu/optimize/continuous.py``.

Reproduces the reference's interior-point protocol
(``Tests/test_weighted_exp_lbfgs.m`` family): maximize
trace(f(A+Δ)) − trace(f(A)) over weights x on a selected edge set Omega,
subject to box bounds and the budget Σx ≤ b. The optimizer loop runs on the
host (scipy trust-constr in place of MATLAB fmincon interior-point: iterates
differ, acceptance is by objective value), one device-to-host copy of the
objective and gradient per call; the evaluations run on the operator's
device:

* objective + gradient: one ``fun_update`` (reference
  ``fun_and_grad_krylov_exp.m:83-88``; a general f adds a
  ``trace_fun_update`` for the objective, ``fun_and_grad_krylov_fun.m:64-65``),
* exact Hessian: batched Fréchet factorizations
  (``hessianfcn_exp.m`` / ``hessianfcn_fun.m``).

On a row-sharded operator (``parallel/spmm_sharded.py::RowShardedMatrix``)
every rank runs the optimizer on its replicated copy, so every host decision
must agree or the ranks' collectives diverge: the search space, each
trust-constr iterate and each objective and gradient are checked across the
ranks (``parallel/mesh.py::same_on_every_rank``), and the exact Hessian,
computed on a single-device copy of A + Δ, is taken from the first rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..funm.dense import fun_sym
from ..funm.normest import normest2
from ..funm.scalar import derivative_of, get_fun, value_at
from ..graphs.top_edges import find_top_edges, find_top_missing_edges
from ..ops.sparse import CooMatrix
from ..parallel.mesh import from_first_rank, mesh_of, same_on_every_rank
from ..updates.entries import entries_of_f_expmv, function_multiple_entries
from ..updates.frechet import multiple_frechet_eval
from ..updates.fun_update import fun_update
from ..updates.low_rank import weights_to_low_rank
from ..updates.trace_update import trace_fun_update_batched


def _host(t: torch.Tensor) -> np.ndarray:
    return t.double().cpu().numpy()


def fun_and_grad(
    X: np.ndarray,
    A: CooMatrix,
    Omega: np.ndarray,
    dfA: np.ndarray,
    fun="exp",
    tol: float = 1e-8,
    nrmA: float | None = None,
    A_dense=None,
):
    """f = −[trace(f(A+Δ)) − trace(f(A))] and its gradient
    gr_j = −2·(f'(A)_{Ω_j} + Δf'(A)_{Ω_j}), both on the host in f64.

    Mirrors ``fun_and_grad_krylov_exp.m`` (f = exp shares one Krylov run
    between objective and gradient since f' = f) and
    ``fun_and_grad_krylov_fun.m`` (general f: a separate objective run). U and
    B are built in A's dtype on A's device.
    """
    fun = get_fun(fun)
    dfun = derivative_of(fun)
    Omega = np.asarray(Omega, dtype=np.int64)
    X = np.asarray(X, dtype=np.float64)
    if np.sum(np.abs(X)) == 0:
        return 0.0, -2.0 * np.asarray(dfA)
    if nrmA is None:
        nrmA = float(normest2(A))
    U, B, _ = weights_to_low_rank(Omega, X, A.n)
    kw = dict(dtype=A.dtype, device=A.device)
    Uj = torch.as_tensor(U, **kw)[None]
    Bj = torch.as_tensor(B, **kw)[None]
    upd = fun_update(A, Uj, Bj, fun=dfun, tol=tol * value_at(dfun, nrmA),
                     A_dense=A_dense)
    d_entries = _host(upd.entries(Omega[:, 0], Omega[:, 1])[0])
    if fun.name == dfun.name:  # exp: objective from the same factors
        f_val = -float(upd.trace()[0])
    else:
        res = trace_fun_update_batched(A, Uj, Bj, fun=fun,
                                       tol=tol * value_at(fun, nrmA))
        f_val = -float(res.delta[0])
    gr = -2.0 * (np.asarray(dfA) + d_entries)
    return f_val, gr


def hessian(
    X: np.ndarray,
    A_scipy: sp.spmatrix,
    Omega: np.ndarray,
    fun="exp",
    tol: float = 1e-8,
    dtype=torch.float64,
    exact: bool = True,
    *,
    device,
):
    """Exact IPM Hessian (``hessianfcn_exp.m`` / ``hessianfcn_fun.m``):
    Atilde = A + sym(X on Omega) as a ``CooMatrix`` of ``dtype`` on
    ``device``; Hes from batched Fréchet derivatives of f' at Atilde,
    symmetrized, ×(−2). ``exact=False`` reproduces the reference's one-term
    assembly (it omits the transpose-probe term of the symmetric direction,
    see FrechetBatch.hessian)."""
    fun = get_fun(fun)
    dfun = derivative_of(fun)
    Omega = np.asarray(Omega, dtype=np.int64)
    n = A_scipy.shape[0]
    XX = sp.coo_matrix(
        (np.asarray(X, dtype=np.float64), (Omega[:, 0], Omega[:, 1])),
        shape=(n, n),
    )
    Atilde = sp.csr_matrix(A_scipy) + (XX + XX.T).tocsr()
    M = CooMatrix.from_scipy(Atilde, dtype=dtype, device=device)
    fb = multiple_frechet_eval(M, Omega, fun=dfun, tol=tol)
    H = _host(fb.hessian(Omega, exact=exact))
    H = np.triu(H) + np.triu(H, 1).T  # hessianfcn_exp.m:14 symmetrization
    return -2.0 * H


@dataclasses.dataclass
class ContinuousProblem:
    Omega: np.ndarray  # (k, 2) modifiable edges
    dfA: np.ndarray  # f'(A) entries at Omega
    lb: np.ndarray
    ub: np.ndarray
    budget: float


def build_problem(
    A_scipy: sp.spmatrix,
    A: CooMatrix,
    centrality: np.ndarray,
    method: str,
    fun="exp",
    search_space: int = 100,
    modifiable_edges: int = 30,
    heur_order: str = "min",
    total_weight: float = 10.0,
    ndense: int = 500,
    tol: float = 1e-8,
    entries_method: str = "auto",
) -> ContinuousProblem:
    """Search-space construction for the three weighted problems
    (``test_weighted_exp_lbfgs.m:80-186``): centrality preselection, gradient
    refinement by the largest f'(A) entries, then method-specific bounds.

    ``entries_method``: 'auto' follows the reference (dense f'(A) when
    n < ndense, per-row Arnoldi entries otherwise); 'expmv' uses the batched
    expmv actions (exp-family f only).
    """
    fun = get_fun(fun)
    dfun = derivative_of(fun)
    n = A_scipy.shape[0]

    def grad_entries(E):
        if entries_method == "expmv":
            vals, _ = entries_of_f_expmv(A, E, fun=dfun)
            return _host(vals)
        if n < ndense:
            Ad = torch.as_tensor(A_scipy.toarray(), dtype=A.dtype,
                                 device=A.device)
            F = _host(fun_sym(Ad, dfun))
            return F[E[:, 0], E[:, 1]]
        vals, _ = function_multiple_entries(A, E, fun=dfun, tol=tol)
        return _host(vals)

    def refine(E, keep):
        g = grad_entries(E)
        ind = np.argsort(-g, kind="stable")[:keep]
        return E[ind], g[ind]

    if method == "tuning":
        E = find_top_edges(A_scipy, centrality, search_space, heur_order)
        E, dfA = refine(E, modifiable_edges)
        w = np.asarray(A_scipy[E[:, 0], E[:, 1]]).ravel()
        lb = -0.5 * w
        ub = -2.0 * lb
    elif method == "rewire":
        E1 = find_top_edges(A_scipy, centrality, search_space // 2, heur_order)
        E2 = find_top_missing_edges(A_scipy, centrality, search_space // 2,
                                    heur_order)
        E1, g1 = refine(E1, modifiable_edges // 2)
        E2, g2 = refine(E2, modifiable_edges // 2)
        E = np.concatenate([E1, E2], axis=0)
        dfA = np.concatenate([g1, g2])
        w1 = np.asarray(A_scipy[E1[:, 0], E1[:, 1]]).ravel()
        lb = np.concatenate([-w1, np.zeros(len(E2))])
        ub = np.concatenate([w1, np.ones(len(E2))])
    elif method == "add":
        E = find_top_missing_edges(A_scipy, centrality, search_space,
                                   heur_order)
        E, dfA = refine(E, modifiable_edges)
        lb = np.zeros(len(E))
        ub = np.ones(len(E))
    else:
        raise ValueError(f"unknown method {method!r}")
    same_on_every_rank(mesh_of(A), "the search space (Omega, f'(A) entries)",
                       E, dfA)
    return ContinuousProblem(Omega=E, dfA=dfA, lb=lb, ub=ub,
                             budget=total_weight)


@dataclasses.dataclass
class ContinuousResult:
    x: np.ndarray
    fval: float  # minimized −Δtrace
    iterations: int
    success: bool
    message: str


def optimize_weights(
    A_scipy: sp.spmatrix,
    A: CooMatrix,
    problem: ContinuousProblem,
    fun="exp",
    tol: float = 1e-8,
    use_hessian: bool = False,
    maxiter: int = 200,
    nrmA: float | None = None,
) -> ContinuousResult:
    """Host-side optimizer driving the device evaluations. trust-constr plays
    the role of fmincon interior-point (with BFGS approximation by default,
    the exact Krylov Hessian in f64 on A's device when ``use_hessian``)."""
    from scipy.optimize import LinearConstraint, minimize

    if nrmA is None:
        nrmA = float(normest2(A))
    k = len(problem.Omega)
    mesh = mesh_of(A)
    # densified once for fun_update's dense fallback at n ≤ 130, at the
    # operator's size (a row-sharded one pads its rows with zeros)
    A_dense = None
    if A_scipy.shape[0] <= 130:
        n = A_scipy.shape[0]
        A_dense = torch.zeros((A.n, A.n), dtype=A.dtype, device=A.device)
        A_dense[:n, :n] = torch.as_tensor(A_scipy.toarray())

    def obj(x):
        same_on_every_rank(mesh, "the trust-constr iterate", x)
        f, g = fun_and_grad(
            x, A, problem.Omega, problem.dfA, fun=fun, tol=tol, nrmA=nrmA,
            A_dense=A_dense,
        )
        same_on_every_rank(mesh, "the objective and gradient", f, g)
        return f, g

    kwargs = {}
    if use_hessian:
        kwargs["hess"] = lambda x: from_first_rank(mesh, lambda: hessian(
            x, A_scipy, problem.Omega, fun=fun, tol=tol, device=A.device))
    res = minimize(
        obj,
        np.zeros(k),
        jac=True,
        method="trust-constr",
        bounds=list(zip(problem.lb, problem.ub)),
        constraints=[LinearConstraint(np.ones((1, k)), -np.inf,
                                      problem.budget)],
        options={"maxiter": maxiter, "gtol": 1e-8, "xtol": 1e-12},
        **kwargs,
    )
    return ContinuousResult(
        x=np.asarray(res.x),
        fval=float(res.fun),
        iterations=int(res.nit),
        success=bool(res.success),
        message=str(res.message),
    )
