"""Graph preprocessing of the paper experiments — carried over from
``krylov_robustness_tpu/graphs/preprocess.py`` (reference protocol
``Tests/test_unweighted_break.m:45-53``): symmetrize + binarize
``spones(A+A')``, strip the diagonal, keep the largest connected component;
the weighted protocol symmetrizes and normalizes instead.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def symmetrize_binarize(A: sp.spmatrix) -> sp.csr_matrix:
    """``spones(A + A')`` with zero diagonal (COO-based: fast at 100k nodes)."""
    C = sp.coo_matrix(A)
    rows = np.concatenate([C.row, C.col])
    cols = np.concatenate([C.col, C.row])
    keep = rows != cols
    S = sp.coo_matrix(
        (np.ones(keep.sum()), (rows[keep], cols[keep])), shape=A.shape
    ).tocsr()
    S.sum_duplicates()
    S.data[:] = 1.0
    return S


def largest_connected_component(A: sp.spmatrix) -> np.ndarray:
    """Boolean mask of the largest connected component
    (``Tests/test_unweighted_break.m:160-169``)."""
    n_comp, labels = sp.csgraph.connected_components(A, directed=False)
    sizes = np.bincount(labels, minlength=n_comp)
    return labels == np.argmax(sizes)


def preprocess_unweighted(A: sp.spmatrix) -> sp.csr_matrix:
    S = symmetrize_binarize(A)
    idx = np.flatnonzero(largest_connected_component(S))
    # row-then-column CSR/CSC slicing (np.ix_ is pathological at 100k nodes)
    return S[idx, :].tocsc()[:, idx].tocsr()


def preprocess_weighted(A: np.ndarray) -> np.ndarray:
    """Weighted protocol (``Tests/test_weighted_exp_lbfgs.m:33-40``):
    symmetrize, zero diagonal, normalize to max weight 1."""
    A = np.asarray(A, dtype=np.float64)
    A = (A + A.T) / 2.0
    np.fill_diagonal(A, 0.0)
    mx = np.abs(A).max()
    if mx > 0:
        A = A / mx
    return A


def edges_lower(A: sp.spmatrix) -> np.ndarray:
    """Existing edges as (e, 2) with i > j (``tril(A,-1)`` convention of
    ``functions/find_top_edges.m:22``)."""
    C = sp.coo_matrix(sp.tril(A, -1))
    return np.stack([C.row, C.col], axis=1)
