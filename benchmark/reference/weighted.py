"""Plain reference of the weighted problems (paper §6, Tables 5–6, and
CONFIG 5): the search space Omega, and the objective and gradient at given
weights x on Omega,

    f(x) = −[trace F(A + D) − trace F(A)],   g_p = −2·F′(A + D)_{i_p j_p},

with D = Σ_p x_p (e_i e_jᵀ + e_j e_iᵀ) and F one of exp, sinh, cosh. The
entries of F′(A + tD) come from exp(±(A + tD)) applied to unit vectors by a
scaled Taylor series (‖·‖₁/s ≤ ½, terms until they fall below the unit
roundoff of the sum); the trace difference is ∫₀¹ trace(F′(A + tD)·D) dt
by 16-point Gauss–Legendre, which its analytic integrand makes exact to
rounding. No Krylov method and no low-rank update, so it shares no
algorithm with the program. ``precision='float32'`` is the control.

Whether the weights solve the problem: the Frank–Wolfe gap of the
reference's gradient at them over the feasible set, the box of each edge's
bounds ('rewire': an existing edge of weight w in [−w, w], a missing one in
[0, 1]) under the budget Σx ≤ b, which is zero exactly at a first-order
stationary point.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import scipy.sparse as sp
import torch

from . import to_torch_csr, top_edges_min, top_missing_edges_min

DTYPES = {"float64": torch.float64, "float32": torch.float32}
GAUSS_NODES = 16
DERIVATIVE = {"exp": "exp", "sinh": "cosh", "cosh": "sinh"}


def _norm1(M: sp.spmatrix) -> float:
    return float(abs(sp.csr_matrix(M)).sum(axis=1).max()) if M.nnz else 0.0


def _expm_columns(A, D, X, t, sgn, norm1: float, dtype):
    """exp(sgn_c·(A + t_c·D))·x_c for every column c of X (n, k); ``t`` and
    ``sgn`` are (k,) tensors; A and D torch sparse CSR (D may be None);
    ``norm1`` bounds ‖A + t·D‖₁ over the t used."""
    s = max(1, int(np.ceil(norm1 / 0.5)))
    eps = torch.finfo(dtype).eps

    def op(Y):
        Z = torch.sparse.mm(A, Y)
        if D is not None:
            Z = Z + torch.sparse.mm(D, Y) * t[None, :]
        return Z * sgn[None, :]

    for _ in range(s):
        acc, term = X, X
        for k in range(1, 60):
            term = op(term) / (s * k)
            acc = acc + term
            if float(term.abs().max()) <= eps * float(acc.abs().max()):
                break
        X = acc
    return X


def _fprime_entries(A, D, pairs: np.ndarray, ts: np.ndarray, fun: str,
                    norm1: float, dtype, device) -> np.ndarray:
    """[F′(A + t·D)]_{i j} for each t of ``ts`` and each pair (i, j):
    (len(ts), len(pairs)) float64."""
    dfun = DERIVATIVE[fun]
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    cols, where = np.unique(pairs[:, 1], return_inverse=True)
    n = A.shape[0]
    signs = [1.0] if dfun == "exp" else [1.0, -1.0]
    blocks = [(ti, t, s) for s in signs for ti, t in enumerate(ts)]
    k = len(cols)
    X = torch.zeros((n, k * len(blocks)), dtype=dtype, device=device)
    t_col = torch.empty(k * len(blocks), dtype=dtype, device=device)
    s_col = torch.empty_like(t_col)
    for b, (_, t, s) in enumerate(blocks):
        X[torch.as_tensor(cols, device=device),
          torch.arange(b * k, (b + 1) * k, device=device)] = 1.0
        t_col[b * k:(b + 1) * k] = t
        s_col[b * k:(b + 1) * k] = s
    Y = _expm_columns(A, D, X, t_col, s_col, norm1, dtype)
    rows = torch.as_tensor(pairs[:, 0], device=device)
    out = np.zeros((len(ts), len(pairs)))
    for b, (ti, _, s) in enumerate(blocks):
        vals = Y[rows, torch.as_tensor(b * k + where, device=device)]
        vals = vals.double().cpu().numpy()
        if dfun == "exp":
            out[ti] += vals
        elif dfun == "cosh":
            out[ti] += vals / 2
        else:  # sinh
            out[ti] += s * vals / 2
    return out


def search_space(A: sp.spmatrix, centrality: np.ndarray, method: str,
                 fun: str, search_space_size: int, modifiable: int, *,
                 precision: str = "float64", device="cpu") -> np.ndarray:
    """Omega of ``test_weighted_*.m:80-186`` for 'rewire': the first
    search_space/2 existing and missing edges in the 'min' order, each half
    cut to its modifiable/2 largest F′(A) entries (stable order)."""
    if method != "rewire":
        raise ValueError(f"reference has only 'rewire', not {method!r}")
    dtype, dev = DTYPES[precision], torch.device(device)
    At = to_torch_csr(A, dtype, dev)
    halves = []
    for E in (top_edges_min(A, centrality, search_space_size // 2),
              top_missing_edges_min(A, centrality, search_space_size // 2)):
        g = _fprime_entries(At, None, E, np.array([0.0]), fun, _norm1(A),
                            dtype, dev)[0]
        halves.append(E[np.argsort(-g, kind="stable")[:modifiable // 2]])
    return np.concatenate(halves, axis=0)


def objective_and_gradient(A: sp.spmatrix, Omega: np.ndarray, x: np.ndarray,
                           fun: str, *, precision: str = "float64",
                           device="cpu") -> tuple[float, np.ndarray]:
    """(f(x), g(x)) as defined above, in ``precision``."""
    dtype, dev = DTYPES[precision], torch.device(device)
    Omega = np.asarray(Omega, np.int64).reshape(-1, 2)
    x = np.asarray(x, np.float64)
    n = A.shape[0]
    Dm = sp.coo_matrix((np.concatenate([x, x]),
                        (np.concatenate([Omega[:, 0], Omega[:, 1]]),
                         np.concatenate([Omega[:, 1], Omega[:, 0]]))),
                       shape=(n, n)).tocsr()
    At, Dt = to_torch_csr(A, dtype, dev), to_torch_csr(Dm, dtype, dev)
    z, w = np.polynomial.legendre.leggauss(GAUSS_NODES)
    ts = np.concatenate([(z + 1) / 2, [1.0]])
    E = _fprime_entries(At, Dt, Omega, ts, fun, _norm1(A) + _norm1(Dm),
                        dtype, dev)
    # d/dt trace F(A + tD) = trace(F′(A + tD)·D) = Σ_p 2·x_p·F′_{i_p j_p}
    integrand = E[:GAUSS_NODES] @ (2.0 * x)
    f = -float(np.dot(w / 2, integrand))
    return f, -2.0 * E[GAUSS_NODES]


def rewire_bounds(A: sp.spmatrix, Omega: np.ndarray) -> tuple:
    """(lb, ub) of 'rewire' (``test_weighted_rewire.m``): an existing edge
    of weight w may move within [−w, w], a missing edge within [0, 1]."""
    Omega = np.asarray(Omega, np.int64).reshape(-1, 2)
    w = np.asarray(sp.csr_matrix(A)[Omega[:, 0], Omega[:, 1]]).ravel()
    return np.where(w != 0, -w, 0.0), np.where(w != 0, w, 1.0)


def optimality_gap(g: np.ndarray, x: np.ndarray, lb: np.ndarray,
                   ub: np.ndarray, budget: float) -> float:
    """|gᵀx − min gᵀy| over y in the box [lb, ub] with Σy ≤ budget (a
    linear program, by HiGHS), over |g|ᵀ(ub − lb), the most that a move
    across the box could change f to first order: 0 where x is stationary,
    and of order 1 at the start of a solve that has not moved."""
    g, x = np.asarray(g, np.float64), np.asarray(x, np.float64)
    lp = scipy.optimize.linprog(g, A_ub=np.ones((1, len(g))), b_ub=[budget],
                                bounds=list(zip(lb, ub)), method="highs")
    return abs(float(g @ x) - float(lp.fun)) / float(np.abs(g) @ (ub - lb))
