"""Node centralities on the host (scipy) — carried over from
``krylov_robustness_tpu/graphs/centrality.py::compute_centrality_host``
(reference ``functions/compute_centrality.m``). The device centralities are
not ported yet."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def compute_centrality_host(A_scipy, kind: str = "eig") -> np.ndarray:
    """'eig' (the paper experiments' choice, ``test_unweighted_break.m:63``),
    'deg', 'pr', 'res' or 'exp'; anything else falls back to 'eig'."""
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
        rho = np.abs(spla.eigsh(A, k=1, return_eigenvectors=False))[0]
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
    _, v = spla.eigsh(A, k=1, which="LA")
    return np.abs(v[:, 0])
