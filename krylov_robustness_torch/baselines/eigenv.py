"""EIGENV heuristic baseline (Arrigo & Benzi, SISC 2016) — carried over
from ``krylov_robustness_tpu/baselines/eigenv.py``.

The reference inlines this in every unweighted driver
(``Tests/test_unweighted_break.m:110-129``): restrict to the top n/5 nodes by
eigenvector centrality, take the top-k existing edges by the 'mult' order
(product of endpoint centralities), and report their joint deletion Δtrace.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..graphs.top_edges import find_top_edges, find_top_missing_edges


def eigenv_edges(A: sp.spmatrix, centrality: np.ndarray, k: int,
                 mode: str = "break") -> np.ndarray:
    """Select k edges by the EIGENV heuristic; returns global (i, j) pairs."""
    n = A.shape[0]
    ind = np.argsort(-np.asarray(centrality).ravel(), kind="stable")
    top = ind[: int(np.ceil(n / 5))]
    Asmall = sp.csr_matrix(A)[np.ix_(top, top)]
    if mode == "break" and Asmall.nnz < 2 * k:
        Asmall = sp.csr_matrix(A)
        top = np.arange(n)
    c_small = np.asarray(centrality).ravel()[top]
    if mode == "break":
        E = find_top_edges(Asmall, c_small, k, "mult")
    else:
        E = find_top_missing_edges(Asmall, c_small, k, "mult")
    return np.stack([top[E[:, 0]], top[E[:, 1]]], axis=1)
