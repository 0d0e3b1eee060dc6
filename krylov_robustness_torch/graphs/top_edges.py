"""Candidate edge selection with the reference's exact tie semantics —
carried over from ``krylov_robustness_tpu/graphs/top_edges.py`` (the port
does not import the JAX package; tests hold the two equal).

Host/NumPy code: selection runs once per greedy sweep over at most O(nnz)
candidates — not a device hot path. The ordering rules matter for
reproducing the paper's edge picks:

* ``find_top_edges`` (``functions/find_top_edges.m``): existing edges from
  tril(A,−1); 'mult' = product of endpoint centralities descending; 'min' =
  rank-based lexicographic score mx(mx−1)/2+mn ascending, where ranks come
  from the first position of each value in the descending-sorted centrality
  (ties collapse to the same rank, exactly like MATLAB's find(sc==c,1)).
* ``find_top_missing_edges`` (``functions/find_top_missing_edges.m``): 'min'
  (default) walks nodes in descending centrality collecting non-edges
  against all higher-ranked nodes; 'mult' bounds a candidate node set then
  filters non-edges in score order.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _rank_of_values(centrality: np.ndarray) -> np.ndarray:
    """rank[i] = 1-based first index of centrality[i] in the descending sort
    (MATLAB ``find(sc == centrality(I(h)), 1)``)."""
    sc = np.sort(centrality)[::-1]
    # first position of each distinct value in sc
    return np.searchsorted(-sc, -centrality, side="left") + 1


def find_top_edges(A: sp.spmatrix, centrality: np.ndarray, num: int,
                   order: str = "mult") -> np.ndarray:
    C = sp.coo_matrix(sp.tril(A, -1))
    I, J = C.row, C.col
    E = np.stack([I, J], axis=1)
    if len(I) < num:
        import warnings

        warnings.warn("find_top_edges: not enough edges in the graph")
        num = len(I)
    if order == "mult":
        c = centrality[I] * centrality[J]
        ind = np.argsort(-c, kind="stable")
    elif order == "min":
        rank = _rank_of_values(centrality)
        r1, r2 = rank[I], rank[J]
        mn = np.minimum(r1, r2)
        mx = np.maximum(r1, r2)
        scores = mx * (mx - 1) / 2 + mn
        ind = np.argsort(scores, kind="stable")
    else:
        raise ValueError(f"unknown order {order!r}")
    return E[ind[:num]]


def find_top_missing_edges(A: sp.spmatrix, centrality: np.ndarray, num: int,
                           order: str = "min") -> np.ndarray:
    A = sp.csr_matrix(A)
    n = A.shape[0]
    centrality = np.asarray(centrality).ravel()
    indC = np.argsort(-centrality, kind="stable")
    if order == "mult":
        total_missing = (n * n - A.nnz - n) / 2
        if total_missing <= num:
            S = np.triu(np.outer(centrality[indC], centrality[indC]))
            ind = np.argsort(-S.ravel(), kind="stable")
            I, J = np.unravel_index(ind, S.shape)
            I, J = indC[I], indC[J]
        else:
            # minimum N such that enough missing edges exist among top nodes
            length = 0
            min_N = 2
            while length < num and min_N <= n:
                row = np.asarray(
                    A[indC[: min_N - 1], indC[min_N - 1]].todense()
                ).ravel()
                length += int(np.sum(row == 0))
                min_N += 1
            min_N -= 1
            sc = centrality[indC]
            N = int(np.sum(sc[0] * sc > sc[min_N - 1] ** 2))
            S = np.triu(np.outer(centrality[indC[:N]], centrality[indC[:N]]))
            ind = np.argsort(-S.ravel(), kind="stable")
            I, J = np.unravel_index(ind, S.shape)
            I, J = indC[I], indC[J]
        E = []
        for i, j in zip(I, J):
            if i != j and A[i, j] == 0:
                E.append((i, j))
                if len(E) == num:
                    break
        return np.array(E, dtype=np.int64).reshape(-1, 2)
    elif order == "min":
        E = []
        j = 1  # 0-based position in indC of the "new" node (MATLAB j=2)
        while len(E) < num and j < n:
            node = indC[j]
            higher = indC[:j]
            row = np.asarray(A[higher, node].todense()).ravel()
            missing = higher[row == 0]
            for h in missing:
                E.append((h, node))
            j += 1
        return np.array(E[:num], dtype=np.int64).reshape(-1, 2)
    raise ValueError(f"unknown order {order!r}")
