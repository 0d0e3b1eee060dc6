"""Norm estimators for sparse operators — port of
``krylov_robustness_tpu/funm/normest.py``.

Replaces the reference's ``normAm`` (``functions/normAm.m``) and MATLAB's
``normest`` 2-norm power iteration. The device functions take a
:class:`..ops.sparse.CooMatrix` and run on its device; the JAX
``lax.while_loop``/``fori_loop`` become Python loops, with one host check of
the stopping test per iteration. ``normest1_power`` and ``normest2_host`` are
host numpy/scipy, carried over.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch


def _abs_colsum(A) -> torch.Tensor:
    """Column sums of |A| on A's device, from the whole matrix's COO triple
    (``host_coo``, which a row-sharded operator gathers on every rank)."""
    _, cols, vals = A.host_coo()
    out = np.zeros(A.n, vals.dtype)
    np.add.at(out, cols, np.abs(vals))
    return torch.as_tensor(out, device=A.device)


def norm1(A) -> torch.Tensor:
    """Exact 1-norm (max abs column sum) of a sparse matrix."""
    return _abs_colsum(A).max()


def norm_inf_rowsum(x: torch.Tensor) -> torch.Tensor:
    """MATLAB ``norm(B, inf)`` for a block vector: max row sum of abs."""
    if x.ndim == 1:
        return x.abs().max()
    return x.abs().sum(dim=1).max()


def normAm_nonneg(A, m: int) -> torch.Tensor:
    """‖A^m‖₁ — exact for elementwise-nonnegative A via m chained products on
    the ones vector (``functions/normAm.m:17-23``; A symmetric, so Aᵀe = Ae).
    For general A call with |A| to obtain an upper bound."""
    e = torch.ones((A.n,), dtype=A.dtype, device=A.device)
    for _ in range(m):
        e = A @ e
    return e.max()


def normest2(A, tol: float = 1e-2, max_iter: int = 100) -> torch.Tensor:
    """2-norm estimate via power iteration on the symmetric operator —
    replacement for MATLAB ``normest(A, tol)`` used by the test drivers
    (``Tests/test_unweighted_break.m:56``). Starts, as ``normest`` does, from
    the column-sum vector x = sum(abs(A))'."""
    x = _abs_colsum(A)
    e = torch.linalg.norm(x)
    x = x / torch.clamp(e, min=1e-300)
    e0 = torch.zeros_like(e)
    it = 0
    while it < max_iter and bool((e - e0).abs() > tol * e):
        e0 = e
        Ax = A @ x
        nrm = torch.linalg.norm(Ax)
        x = torch.where(nrm > 0, Ax / nrm, Ax)
        e = torch.linalg.norm(A @ x) / torch.clamp(torch.linalg.norm(x),
                                                   min=1e-300)
        it += 1
    return e


def normest1_power(matvec, n: int, m: int = 1, t: int = 2,
                   itmax: int = 5, seed: int = 0) -> float:
    """Block 1-norm estimate of ‖B^m‖₁ for the operator ``matvec: X → B X``
    (Higham & Tisseur 2000) — the general-matrix branch of the reference's
    ``functions/normAm.m:25-51`` (MATLAB ``normest1`` with the ``afun_power``
    callback). Used when B has mixed signs, where the |B|-product bound of
    :func:`normAm_nonneg` would inflate the Taylor degree. B must be real
    symmetric, so the transposed products reuse ``matvec``. Host numpy."""

    def power(X):
        for _ in range(m):
            X = matvec(X)
        return X

    rng = np.random.default_rng(seed)
    X = np.ones((n, t), dtype=np.float64)
    if t > 1:
        X[:, 1:] = rng.choice([-1.0, 1.0], size=(n, t - 1))
        # deduplicate parallel sign columns
        for j in range(1, t):
            while any(abs(X[:, j] @ X[:, i]) == n for i in range(j)):
                X[:, j] = rng.choice([-1.0, 1.0], size=n)
    X /= n

    est_old = 0.0
    ind_best = 0
    ind_hist: set[int] = set()
    S = np.zeros((n, t))
    est = 0.0
    # unit-vector index behind each current X column; None on the first
    # iteration, whose start block is the averaged ones/sign columns
    # (MATLAB normest1's k=1 special case)
    col_src: "np.ndarray | None" = None
    for k in range(1, itmax + 1):
        Y = power(X)
        sums = np.sum(np.abs(Y), axis=0)
        j = int(np.argmax(sums))
        est = float(sums[j])
        if est > est_old or k == 2:
            ind_best = j if col_src is None else int(col_src[j])
        if k >= 2 and est <= est_old:
            est = est_old
            break
        est_old = est
        S_old = S
        S = np.sign(Y)
        S[S == 0] = 1.0
        if t > 1:
            # every column of S parallel to one of S_old → converged
            if np.all(np.any(np.abs(S_old.T @ S) == n, axis=0)):
                break
            # replace columns parallel to earlier/new ones by random signs
            for j2 in range(t):
                while any(
                    abs(S[:, j2] @ S[:, i]) == n for i in range(j2)
                ) or np.any(np.abs(S_old.T @ S[:, j2]) == n):
                    S[:, j2] = rng.choice([-1.0, 1.0], size=n)
        Z = power(S)  # B symmetric: Bᵀ S = B S
        h = np.max(np.abs(Z), axis=1)
        if k >= 2 and float(np.max(h)) == float(h[ind_best]):
            break
        ind = np.argsort(-h, kind="stable")
        if t > 1:
            if set(map(int, ind[:t])) <= ind_hist:
                break
            fresh = [int(i) for i in ind if int(i) not in ind_hist][:t]
            ind = np.asarray(fresh + [int(i) for i in ind[:t]], dtype=int)[:t]
        else:
            ind = ind[:t]
        X = np.zeros((n, t))
        for j2, i in enumerate(ind[:t]):
            X[int(i), j2] = 1.0
        col_src = np.asarray(ind[:t], dtype=int)
        ind_hist.update(int(i) for i in ind[:t])
    return est


def normest2_host(A_scipy, tol: float = 1e-2) -> float:
    """‖A‖₂ of a symmetric sparse matrix via scipy eigsh (largest |λ|),
    started from the ones vector: the same value in every process (ARPACK's
    own start vector is random in each)."""
    A = sp.csr_matrix(A_scipy).astype(np.float64)
    w = spla.eigsh(A, k=1, which="LM", return_eigenvectors=False,
                   tol=max(tol * 1e-2, 1e-10), v0=np.ones(A.shape[0]))
    return float(abs(w[0]))
