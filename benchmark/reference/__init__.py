"""Plain references that decide ``correct``: NumPy, SciPy and plain torch
operations only. They import nothing of the port and take nothing it made:
the benchmark hands them the same generated graph and protocol inputs
(‖A‖, centrality) that it hands the program, and they read the program's
answers only to judge them."""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch


def to_torch_csr(A: sp.spmatrix, dtype: torch.dtype, device) -> torch.Tensor:
    """A as a torch sparse CSR tensor of ``dtype`` on ``device``."""
    C = sp.csr_matrix(A)
    C.sort_indices()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "in beta state"
        return torch.sparse_csr_tensor(
            torch.as_tensor(C.indptr.astype(np.int64)),
            torch.as_tensor(C.indices.astype(np.int64)),
            torch.as_tensor(C.data, dtype=dtype), size=C.shape,
            check_invariants=False).to(device)


def rank_of_values(centrality: np.ndarray) -> np.ndarray:
    """1-based rank of each node: the first position of its value in the
    descending sort (equal values share a rank, as MATLAB's
    ``find(sc == c, 1)``)."""
    sc = np.sort(centrality)[::-1]
    return np.searchsorted(-sc, -centrality, side="left") + 1


def top_edges_min(A: sp.spmatrix, centrality: np.ndarray,
                  num: int) -> np.ndarray:
    """The first ``num`` existing edges (i > j) in the paper's 'min' order
    (``functions/find_top_edges.m``): by the score mx(mx−1)/2 + mn of their
    endpoint ranks, ascending, ties in tril order."""
    C = sp.coo_matrix(sp.tril(A, -1))
    rank = rank_of_values(centrality)
    r1, r2 = rank[C.row], rank[C.col]
    mn, mx = np.minimum(r1, r2), np.maximum(r1, r2)
    ind = np.argsort(mx * (mx - 1) / 2 + mn, kind="stable")[:num]
    return np.stack([C.row[ind], C.col[ind]], axis=1).astype(np.int64)


def top_missing_edges_min(A: sp.spmatrix, centrality: np.ndarray,
                          num: int) -> np.ndarray:
    """The first ``num`` missing edges in the 'min' order
    (``functions/find_top_missing_edges.m``): nodes in descending
    centrality; each contributes its non-edges to every node ranked above
    it, in that order."""
    A = sp.csr_matrix(A)
    order = np.argsort(-np.asarray(centrality), kind="stable")
    out = []
    for pos in range(1, A.shape[0]):
        node, higher = order[pos], order[:pos]
        linked = np.asarray(A[higher, node].todense()).ravel() != 0
        out += [(h, node) for h in higher[~linked]]
        if len(out) >= num:
            break
    return np.asarray(out[:num], dtype=np.int64).reshape(-1, 2)
