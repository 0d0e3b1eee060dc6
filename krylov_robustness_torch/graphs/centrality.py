"""Node centralities (reference ``functions/compute_centrality.m``) — port
of ``krylov_robustness_tpu/graphs/centrality.py``.

'eig' (the only one the paper drivers use, ``test_unweighted_break.m:63``)
runs as power iteration on the operator's device; the others mirror the
reference options. The JAX ``lax.while_loop``s become Python loops with one
host check of the stopping test per iteration. ``compute_centrality_host``
(scipy) is carried over.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch


def _power_iteration(A, tol: float, max_iter: int):
    """(|x|, λ) of the dominant eigenpair by power iteration from the
    normalized ones vector, stopping at |λ − λ₀| ≤ tol·|λ|."""
    x = torch.ones((A.n,), dtype=A.dtype, device=A.device) / np.sqrt(A.n)
    lam = torch.ones((), dtype=A.dtype, device=A.device)
    lam0 = torch.zeros_like(lam)
    it = 0
    while it < max_iter and bool((lam - lam0).abs() > tol * lam.abs()):
        y = A @ x
        lam0, lam = lam, torch.linalg.norm(y)
        x = y / torch.clamp(lam, min=1e-300)
        it += 1
    return x, lam


def eig_centrality(A, tol: float = 1e-10, max_iter: int = 2000):
    """|dominant eigenvector| via power iteration
    (``compute_centrality.m:15-17``)."""
    return _power_iteration(A, tol, max_iter)[0].abs()


def eig_spectral_radius(A, tol: float = 1e-8, max_iter: int = 2000):
    return _power_iteration(A, tol, max_iter)[1]


def degree_centrality(A):
    """Row sums (``compute_centrality.m:18-19``) on A's device, from the
    whole matrix's COO triple (``host_coo``, which a row-sharded operator
    gathers on every rank)."""
    rows, _, vals = A.host_coo()
    out = np.zeros(A.n, vals.dtype)
    np.add.at(out, rows, vals)
    return torch.as_tensor(out, device=A.device)


def pagerank_centrality(A, alpha: float = 0.85, tol: float = 1e-12,
                        max_iter: int = 1000):
    """PageRank dominant eigenvector (``compute_centrality.m:20-26``)."""
    n = A.n
    deg = degree_centrality(A)
    inv_deg = torch.where(deg > 0, 1.0 / deg, torch.zeros_like(deg))
    x = torch.ones((n,), dtype=A.dtype, device=A.device) / n
    diff = float("inf")
    it = 0
    while it < max_iter and diff > tol:
        y = alpha * (A @ (inv_deg * x)) + (1 - alpha) * x.sum() / n
        y = y / torch.linalg.norm(y)
        diff = float(torch.linalg.norm(y - x))
        x = y
        it += 1
    return x.abs()


def exp_centrality_dense(A_dense: torch.Tensor):
    """diag(expm(A)) via eigh — small-n path (``compute_centrality.m:10``)."""
    w, V = torch.linalg.eigh((A_dense + A_dense.T) / 2)
    return torch.einsum("ij,j,ij->i", V, torch.exp(w), V)


def resolvent_centrality(A, tol: float = 1e-10, max_iter: int = 500):
    """Katz resolvent (I − αA)⁻¹·1 with α = 1/(2ρ), by the fixed point
    x = 1 + αA x (the reference variant has a latent bug, undefined n,
    ``compute_centrality.m:11-14``)."""
    alpha = 1.0 / (2.0 * eig_spectral_radius(A))
    ones = torch.ones((A.n,), dtype=A.dtype, device=A.device)
    x = ones
    diff = float("inf")
    it = 0
    while it < max_iter and diff > tol:
        y = ones + alpha * (A @ x)
        diff = float(torch.linalg.norm(y - x) / torch.linalg.norm(y))
        x = y
        it += 1
    return x


def compute_centrality(A, kind: str = "eig") -> np.ndarray:
    """Dispatcher matching ``compute_centrality.m`` on A's device; returns a
    host array for the host-side candidate selection."""
    if kind == "deg":
        c = degree_centrality(A)
    elif kind == "pr":
        c = pagerank_centrality(A)
    elif kind == "res":
        c = resolvent_centrality(A)
    elif kind == "exp":
        c = exp_centrality_dense(A.todense())
    else:
        c = eig_centrality(A)
    return c.cpu().numpy()


def compute_centrality_host(A_scipy, kind: str = "eig") -> np.ndarray:
    """'eig' (the paper experiments' choice, ``test_unweighted_break.m:63``),
    'deg', 'pr', 'res' or 'exp'; anything else falls back to 'eig'. The
    eigsh calls start from the ones vector, so that every process computes
    the same centrality (ARPACK's own start vector is random in each)."""
    A = sp.csr_matrix(A_scipy).astype(np.float64)
    n = A.shape[0]
    if kind == "deg":
        return np.asarray(A.sum(axis=1)).ravel()
    if kind == "pr":
        alpha = 0.85
        deg = np.asarray(A.sum(axis=1)).ravel()
        inv = np.where(deg > 0, 1.0 / deg, 0.0)
        x = np.full(n, 1.0 / n)
        for _ in range(1000):
            y = alpha * (A @ (inv * x)) + (1 - alpha) * x.sum() / n
            y /= np.linalg.norm(y)
            if np.linalg.norm(y - x) < 1e-12:
                x = y
                break
            x = y
        return np.abs(x)
    if kind == "res":
        rho = np.abs(spla.eigsh(A, k=1, return_eigenvectors=False,
                                v0=np.ones(n)))[0]
        alpha = 1.0 / (2 * rho)
        x = np.ones(n)
        for _ in range(500):
            y = 1.0 + alpha * (A @ x)
            if np.linalg.norm(y - x) / np.linalg.norm(y) < 1e-10:
                x = y
                break
            x = y
        return x
    if kind == "exp":
        import scipy.linalg

        return np.diag(scipy.linalg.expm(A.toarray()))
    _, v = spla.eigsh(A, k=1, which="LA", v0=np.ones(n))
    return np.abs(v[:, 0])
