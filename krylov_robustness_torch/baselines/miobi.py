"""MIOBI eigen-perturbation greedy baselines (Chan/Akoglu/Tong 2014) —
carried over from ``krylov_robustness_tpu/baselines/miobi.py``.

Behavioral reimplementation of the reference's private-communication code
(``MIOBI Codes/MIOBIBreakEdge2.m``, ``MIOBIMakeEdge.m``,
``MIOBIBreakEdge2_weighted.m``, ``MIOBIMakeEdge_weighted.m``,
``MIOBIBreakNode.m``): greedy edge edits scored by top-t eigenpairs,

    break: score(p,r) = Σ_t exp(λ_t) · exp(−2·u_t(p)·u_t(r)) → remove min
    make:  score(p,r) = Σ_t exp(λ_t) · exp(+2·u_t(p)·u_t(r)) → add max

with first-order eigenvalue perturbation updates λ̃ = λ + diag(VᵀΔA·V)
(eq. 4, ``MIOBIBreakEdge2.m:86-90``).

Fidelity note on the eigenvector update (eq. 9): the reference's
implementation *neuters itself* — ``diffE(naR, naC) = 0`` with the full
off-diagonal index lists zeroes the whole mixing matrix via MATLAB's
cross-product submatrix assignment (``MIOBIBreakEdge2.m:94-100``), so
eigenvectors never actually change (beyond renormalization and the
abs of the first column). ``eigvec_update='neutered'`` (default) reproduces
that observed behavior exactly; ``'full'`` implements the intended eq. 9.

The robustness score R = log(mean(exp(eigs(A, topT)))) matches
``MIOBIBreakEdge2.m:40-43``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def _top_eigs(A: sp.spmatrix, t: int):
    """Top-t eigenpairs by magnitude, ordered like MATLAB eigs (descending
    |λ|), first eigenvector made nonnegative (``V = [abs(V(:,1)) ...]``)."""
    t = min(t, A.shape[0] - 2)
    w, V = spla.eigsh(A.astype(np.float64), k=t, which="LM")
    order = np.argsort(-np.abs(w), kind="stable")
    w = w[order]
    V = V[:, order]
    V = np.concatenate([np.abs(V[:, :1]), V[:, 1:]], axis=1)
    return w, V


def robustness_score(A: sp.spmatrix, topT: int) -> float:
    """R = log(mean(exp(top eigenvalues))) (``MIOBIBreakEdge2.m:40-43``)."""
    t = min(topT, A.shape[0] - 2)
    w = spla.eigsh(A.astype(np.float64), k=t, which="LM",
                   return_eigenvectors=False)
    return float(np.log(np.mean(np.exp(w))))


def _perturb_eigs(w, V, i, j, delta, eigvec_update: str):
    """First-order eigenpair update for ΔA = delta·(e_i e_jᵀ + e_j e_iᵀ)."""
    t = len(w)
    # VᵀΔA·V = delta·(V[i]ᵀ⊗V[j] + V[j]ᵀ⊗V[i])
    dH = delta * (np.outer(V[i], V[j]) + np.outer(V[j], V[i]))
    w_new = w + np.diag(dH).copy()
    if eigvec_update == "neutered":
        V_new = V.copy()
    else:
        dH0 = dH.copy()
        np.fill_diagonal(dH0, 0.0)
        diff = w[None, :] - w[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.eye(t, dtype=bool), 0.0, 1.0 / diff)
        inner = dH0 * inv
        V_new = V + V @ inner
    V_new = V_new / np.linalg.norm(V_new, axis=0, keepdims=True)
    V_new = np.concatenate([np.abs(V_new[:, :1]), V_new[:, 1:]], axis=1)
    return w_new, V_new


@dataclasses.dataclass
class MiobiResult:
    edges: np.ndarray
    A_new: sp.csr_matrix
    rob_score_pct: float  # (R0 − Rk)/R0 · 100


def miobi_break(A: sp.spmatrix, k: int, topT: int = 25,
                recompute_every: int | None = None,
                eigvec_update: str = "neutered") -> MiobiResult:
    """Greedy edge deletion (``MIOBIBreakEdge2.m``). ``recompute_every=None``
    is the "NoUpdate" variant whose modified matrix the paper drivers rescore
    (``Tests/test_unweighted_break.m:92``); 50 gives the "RC@50" variant."""
    A = sp.csr_matrix(A, copy=True)
    A.data[:] = 1.0
    R0 = robustness_score(A, topT)
    w, V = _top_eigs(A, topT)
    chosen = []
    A = A.tolil()
    for step in range(k):
        Acsr = sp.csr_matrix(A)
        C = sp.coo_matrix(sp.triu(Acsr, 1))
        p, r = C.row, C.col
        score = np.exp(w)[None, :] * np.exp(-2.0 * V[p] * V[r])
        score = score.sum(axis=1)
        h = int(np.argmin(score))
        i, j = int(p[h]), int(r[h])
        chosen.append((i, j))
        A[i, j] = 0.0
        A[j, i] = 0.0
        w, V = _perturb_eigs(w, V, i, j, -1.0, eigvec_update)
        if recompute_every and (step + 1) % recompute_every == 0:
            w, V = _top_eigs(sp.csr_matrix(A), topT)
    A_new = sp.csr_matrix(A)
    A_new.eliminate_zeros()
    Rk = robustness_score(A_new, topT)
    return MiobiResult(
        edges=np.asarray(chosen, dtype=np.int64).reshape(-1, 2),
        A_new=A_new,
        rob_score_pct=(R0 - Rk) * 100.0 / R0,
    )


def miobi_make(A: sp.spmatrix, k: int, topT: int = 25, t_pert: int = 50,
               recompute_every: int | None = None,
               eigvec_update: str = "neutered") -> MiobiResult:
    """Greedy edge addition (``MIOBIMakeEdge.m``): candidates are the missing
    pairs among the top (dmax+k) nodes by dominant-eigenvector score
    (``MIOBIMakeEdge.m:59-83``); perturbation basis size is hardcoded to 50
    in the reference (``MIOBIMakeEdge.m:10``)."""
    A = sp.csr_matrix(A, copy=True)
    A.data[:] = 1.0
    n = A.shape[0]
    R0 = robustness_score(A, topT)
    w, V = _top_eigs(A, t_pert)
    chosen = []
    A = A.tolil()
    for step in range(k):
        Acsr = sp.csr_matrix(A)
        deg = np.asarray(Acsr.sum(axis=1)).ravel()
        dmax = int(deg.max())
        order = np.argsort(-V[:, 0], kind="stable")
        top_nodes = order[: min(dmax + k, n)]
        dense_blk = np.asarray(
            Acsr[np.ix_(top_nodes, top_nodes)].todense()
        )
        iu, ju = np.triu_indices(len(top_nodes), 1)
        missing = dense_blk[iu, ju] == 0
        p = top_nodes[iu[missing]]
        r = top_nodes[ju[missing]]
        if len(p) == 0:
            break
        score = np.exp(w)[None, :] * np.exp(2.0 * V[p] * V[r])
        score = score.sum(axis=1)
        h = int(np.argmax(score))
        i, j = int(p[h]), int(r[h])
        chosen.append((i, j))
        A[i, j] = 1.0
        A[j, i] = 1.0
        w, V = _perturb_eigs(w, V, i, j, +1.0, eigvec_update)
        if recompute_every and (step + 1) % recompute_every == 0:
            w, V = _top_eigs(sp.csr_matrix(A), t_pert)
    A_new = sp.csr_matrix(A)
    Rk = robustness_score(A_new, topT)
    return MiobiResult(
        edges=np.asarray(chosen, dtype=np.int64).reshape(-1, 2),
        A_new=A_new,
        rob_score_pct=(R0 - Rk) * 100.0 / R0,
    )


def miobi_break_weighted(A: sp.spmatrix, k: int, topT: int = 25,
                         recompute_every: int | None = None,
                         eigvec_update: str = "neutered") -> MiobiResult:
    """Weighted deletion (``MIOBIBreakEdge2_weighted.m``): keeps real weights;
    ΔA removes the full weight of the chosen edge."""
    A = sp.csr_matrix(A, copy=True).astype(np.float64)
    if (abs(A - A.T) > 1e-12).nnz:
        raise ValueError("matrix must be symmetric")
    R0 = robustness_score(A, topT)
    w, V = _top_eigs(A, topT)
    chosen = []
    A = A.tolil()
    for step in range(k):
        Acsr = sp.csr_matrix(A)
        C = sp.coo_matrix(sp.triu(Acsr, 1))
        p, r, wts = C.row, C.col, C.data
        score = np.exp(w)[None, :] * np.exp(-2.0 * wts[:, None] * V[p] * V[r])
        score = score.sum(axis=1)
        h = int(np.argmin(score))
        i, j, wt = int(p[h]), int(r[h]), float(wts[h])
        chosen.append((i, j))
        A[i, j] = 0.0
        A[j, i] = 0.0
        w, V = _perturb_eigs(w, V, i, j, -wt, eigvec_update)
        if recompute_every and (step + 1) % recompute_every == 0:
            w, V = _top_eigs(sp.csr_matrix(A), topT)
    A_new = sp.csr_matrix(A)
    A_new.eliminate_zeros()
    Rk = robustness_score(A_new, topT)
    return MiobiResult(
        edges=np.asarray(chosen, dtype=np.int64).reshape(-1, 2),
        A_new=A_new,
        rob_score_pct=(R0 - Rk) * 100.0 / R0,
    )


def miobi_make_weighted(A: sp.spmatrix, k: int, E: np.ndarray,
                        weights: np.ndarray, topT: int = 25,
                        eigvec_update: str = "neutered") -> MiobiResult:
    """Weighted addition over an explicit candidate list (i, j, w)
    (``MIOBIMakeEdge_weighted.m:68-112``)."""
    A = sp.csr_matrix(A, copy=True).astype(np.float64)
    R0 = robustness_score(A, topT)
    w, V = _top_eigs(A, topT)
    E = np.asarray(E, dtype=np.int64).copy()
    weights = np.asarray(weights, dtype=np.float64).copy()
    chosen = []
    A = A.tolil()
    for step in range(min(len(E), 10 ** 9)):
        if len(E) == 0 or len(chosen) >= len(weights):
            break
        p, r = E[:, 0], E[:, 1]
        score = np.exp(w)[None, :] * np.exp(
            2.0 * weights[:, None] * V[p] * V[r]
        )
        score = score.sum(axis=1)
        h = int(np.argmax(score))
        i, j, wt = int(p[h]), int(r[h]), float(weights[h])
        chosen.append((i, j))
        A[i, j] = A[i, j] + wt
        A[j, i] = A[j, i] + wt
        w, V = _perturb_eigs(w, V, i, j, wt, eigvec_update)
        E = np.delete(E, h, axis=0)
        weights = np.delete(weights, h)
    A_new = sp.csr_matrix(A)
    Rk = robustness_score(A_new, topT)
    return MiobiResult(
        edges=np.asarray(chosen, dtype=np.int64).reshape(-1, 2),
        A_new=A_new,
        rob_score_pct=(R0 - Rk) * 100.0 / R0,
    )


def miobi_break_node(A: sp.spmatrix, k: int, topT: int = 25,
                     eigvec_update: str = "neutered") -> MiobiResult:
    """Node deletion variant (``MIOBIBreakNode.m``): per-node score summed
    over incident edges; the chosen node's row/column is zeroed."""
    A = sp.csr_matrix(A, copy=True)
    A.data[:] = 1.0
    n = A.shape[0]
    R0 = robustness_score(A, topT)
    w, V = _top_eigs(A, topT)
    removed = []
    A = A.tolil()
    for step in range(k):
        Acsr = sp.csr_matrix(A)
        C = sp.coo_matrix(sp.triu(Acsr, 1))
        p, r = C.row, C.col
        edge_score = (np.exp(w)[None, :] * np.exp(-2.0 * V[p] * V[r])).sum(axis=1)
        node_score = np.zeros(n)
        np.add.at(node_score, p, edge_score)
        np.add.at(node_score, r, edge_score)
        deg = np.asarray(Acsr.sum(axis=1)).ravel()
        node_score[deg == 0] = np.inf
        node_score[removed] = np.inf
        v = int(np.argmin(node_score))
        removed.append(v)
        # zero row/col and eigen-update per removed incident edge
        neigh = sp.csr_matrix(A).getrow(v).indices
        for u in neigh:
            A[v, u] = 0.0
            A[u, v] = 0.0
            w, V = _perturb_eigs(w, V, v, int(u), -1.0, eigvec_update)
    A_new = sp.csr_matrix(A)
    A_new.eliminate_zeros()
    Rk = robustness_score(A_new, topT)
    return MiobiResult(
        edges=np.asarray(removed, dtype=np.int64).reshape(-1, 1),
        A_new=A_new,
        rob_score_pct=(R0 - Rk) * 100.0 / R0,
    )
