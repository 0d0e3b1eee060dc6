"""Action of the matrix exponential: f = exp(t·A)·B without forming exp(t·A)
— port of ``krylov_robustness_tpu/funm/expmv.py`` (Al-Mohy & Higham Alg. 3.2,
reference ``functions/expmv.m`` + ``functions/select_taylor_degree.m``).

The degree/stage selection is a host-side plan computed once per operator
from norm estimates. The Taylor recurrence ``b ← (t/(s·k))·A·b; f ← f + b``
runs on the operator's device over (n, width) blocks; its data-dependent
early exit (``expmv.m:81-88``) is one host check per term. On a row-sharded
operator the plan is built from the whole matrix (``host_coo``) on every
rank, and the ranks' plans are checked equal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.sparse as sp
import torch

from ..parallel.mesh import mesh_of, same_on_every_rank
from .normest import norm_inf_rowsum, normAm_nonneg, normest1_power
from .theta import THETA_DOUBLE

_PREC_TOL = {"double": 2.0 ** -53, "single": 2.0 ** -24, "half": 2.0 ** -10}


@dataclasses.dataclass(frozen=True)
class ExpmvPlan:
    """Static Taylor-evaluation plan: degree m, s scaling stages."""

    m: int
    s: int
    t: float
    mu: float
    prec: str = "double"
    shift: bool = True

    @property
    def tol(self) -> float:
        return _PREC_TOL[self.prec]


def select_taylor_degree(
    A,
    t: float = 1.0,
    b_cols: int = 1,
    m_max: int = 55,
    p_max: int = 8,
    prec: str = "double",
    shift: bool = True,
    force_estm: bool = False,
) -> ExpmvPlan:
    """Choose Taylor degree m and number of stages s (host-side).

    Mirrors the selection logic of ``functions/select_taylor_degree.m`` and
    the cost minimization of ``functions/expmv.m:57-68``. α_p estimates use
    the nonnegative-exact path of ``functions/normAm.m:17-23`` applied to |A|
    for nonnegative operators and the ``normest1`` block estimator otherwise.
    """
    if p_max < 2 or m_max > 60 or m_max + 1 < p_max * (p_max - 1):
        raise ValueError("invalid p_max or m_max")
    theta = THETA_DOUBLE  # double table; prec only changes the loop tol
    n = A.n
    # the whole matrix on every rank of a row-sharded operator
    rows, cols, vals = A.host_coo()
    on_diag = rows == cols
    mu = float(np.sum(vals[on_diag])) / n if shift else 0.0

    # 1-norm of the shifted, scaled operator t*(A - mu*I): column sums of
    # |A| with the |diag| contribution replaced by |diag - mu|
    colsum = np.zeros(n, vals.dtype)
    np.add.at(colsum, cols, np.abs(vals))
    if mu != 0.0:
        diag = np.zeros(n)
        np.add.at(diag, cols[on_diag], vals[on_diag])
        colsum = colsum - np.abs(diag) + np.abs(diag - mu)
    normA = abs(t) * float(np.max(colsum))

    if (not force_estm) and normA <= 4 * theta[m_max - 1] * p_max * (
        p_max + 3
    ) / (m_max * b_cols):
        alpha = np.full(p_max - 1, normA)
    else:
        nonneg = bool(np.all(vals >= 0)) and mu <= 0.0
        if not nonneg:
            # mixed-sign operator: the |A|-product bound would inflate the
            # Taylor degree; use the normest1-style block estimator on the
            # true shifted operator (``functions/normAm.m:25-51``)
            Bs = sp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                               shape=(n, n))
        eta = np.zeros(p_max)
        for p in range(1, p_max + 1):
            if nonneg:
                c = float(normAm_abs(A, p + 1, mu=mu))
            else:
                c = normest1_power(lambda X: Bs @ X - mu * X, n, m=p + 1,
                                   t=2)
            eta[p - 1] = (abs(t) ** (p + 1) * c) ** (1.0 / (p + 1))
        alpha = np.maximum(eta[: p_max - 1], eta[1:p_max])

    # M(m, p): alpha_p / theta_m for admissible degrees; cost = ceil(M)·m.
    M = np.zeros((m_max, p_max - 1))
    for p in range(2, p_max + 1):
        for m in range(p * (p - 1) - 1, m_max + 1):
            M[m - 1, p - 2] = alpha[p - 2] / theta[m - 1]

    C = np.ceil(M).T * np.arange(1, m_max + 1)[None, :]
    C[C == 0] = np.inf
    idx = np.unravel_index(np.argmin(C), C.shape)
    cost = C[idx]
    m = int(idx[1] + 1)
    if not np.isfinite(cost):
        cost = 0.0
    s = max(int(math.ceil(cost / m)), 1)
    same_on_every_rank(mesh_of(A), "the Taylor plan (m, s, mu)", m, s, mu)
    return ExpmvPlan(m=m, s=s, t=float(t), mu=mu, prec=prec, shift=shift)


def normAm_abs(A, m: int, mu: float = 0.0) -> torch.Tensor:
    """‖|A − μI|^m‖₁ upper-bound estimate via chained products with |A|."""
    absA = dataclasses.replace(A, vals=A.vals.abs())
    if mu == 0.0:
        return normAm_nonneg(absA, m)
    e = torch.ones((A.n,), dtype=A.dtype, device=A.device)
    for _ in range(m):
        e = absA @ e + abs(mu) * e
    return e.max()


def _expmv_core(A, b, t, mu, tol, m: int, s: int, shift: bool,
                full_term: bool, sigma=0.0):
    dtype, dev = b.dtype, b.device
    t = torch.tensor(t, dtype=dtype, device=dev)
    mu = torch.tensor(mu, dtype=dtype, device=dev)
    # spectral shift: exp(t·(A−σI))·b only changes the per-stage unshift
    # factor (the Taylor recurrence itself runs on A−μI); with σ≈λmax every
    # stage value stays O(‖b‖), the f32 overflow guard for hub graphs
    mu_eff = (mu if shift else torch.zeros_like(mu)) - sigma
    eta = torch.exp(t * mu_eff / s)

    def op(x):
        y = A @ x
        return y - mu * x if shift else y

    f = b
    for _ in range(s):
        c1 = norm_inf_rowsum(b)
        k = 1
        while k <= m:
            b = (t / (s * k)) * op(b)
            f = f + b
            c2 = norm_inf_rowsum(b)
            if not full_term and bool(c1 + c2 <= tol * norm_inf_rowsum(f)):
                break
            c1 = c2
            k += 1
        f = eta * f
        b = f
    return f


def expmv(A, b: torch.Tensor, t: float = 1.0, plan: ExpmvPlan | None = None,
          prec: str = "double", shift: bool = True, full_term: bool = False,
          b_cols_hint: int | None = None, sigma: float = 0.0) -> torch.Tensor:
    """exp(t·(A − σI))·b (σ=``sigma``, default 0 ⇒ plain exp(t·A)·b).
    Builds a plan on first use if not provided; for repeated application
    with the same A compute ``plan = select_taylor_degree(A, t, b_cols)``
    once and pass it in (``functions/expmv.m:12-15``)."""
    if plan is None:
        cols = b_cols_hint or (b.shape[1] if b.ndim == 2 else 1)
        plan = select_taylor_degree(A, t=t, b_cols=cols, prec=prec,
                                    shift=shift)
    if t == 0.0:
        return b
    if plan.t != t:
        # the plan bakes in t (degree/scaling chosen from |t|·α and the
        # stage factor t/(s·k) uses plan.t)
        raise ValueError(
            f"expmv plan was built for t={plan.t} but t={t} was requested; "
            "build a plan per t")
    return _expmv_core(A, b, plan.t, plan.mu, plan.tol, plan.m, plan.s,
                       plan.shift, full_term, sigma=sigma)
