"""Edge set → low-rank correction factors — carried over from
``krylov_robustness_tpu/updates/low_rank.py`` (reference
``functions/edge2low_rank.m``): U selects the unique touched nodes, B carries
∓1 at the touched pairs. The sign parameter covers the 'make' copy that the
drivers duplicate locally with +1 (``Tests/test_unweighted_make.m:171-183``);
:func:`weights_to_low_rank` carries edge weights instead, for the continuous
problems.
"""

from __future__ import annotations

import numpy as np


def edge2low_rank(E: np.ndarray, n: int, sign: float = -1.0):
    """Returns (U, B, nodes): U is (n, u) one-hot over the u unique touched
    nodes, B is (u, u) with `sign` at touched pairs."""
    E = np.asarray(E, dtype=np.int64)
    nodes = np.unique(E.ravel())
    idx = {int(v): i for i, v in enumerate(nodes)}
    u = len(nodes)
    U = np.zeros((n, u))
    U[nodes, np.arange(u)] = 1.0
    B = np.zeros((u, u))
    for i, j in E:
        a, b = idx[int(i)], idx[int(j)]
        B[a, b] = sign
        B[b, a] = sign
    return U, B, nodes


def weights_to_low_rank(Omega: np.ndarray, X: np.ndarray, n: int):
    """Weighted correction for the continuous problems
    (``functions/fun_and_grad_krylov_exp.m:56-73``): B(i1,i2)=B(i2,i1)=X_j
    over the unique touched nodes of Omega."""
    Omega = np.asarray(Omega, dtype=np.int64)
    X = np.asarray(X, dtype=np.float64)
    nodes = np.unique(Omega.ravel())
    idx = {int(v): i for i, v in enumerate(nodes)}
    u = len(nodes)
    U = np.zeros((n, u))
    U[nodes, np.arange(u)] = 1.0
    B = np.zeros((u, u))
    for x, (i, j) in zip(X, Omega):
        a, b = idx[int(i)], idx[int(j)]
        B[a, b] = x
        B[b, a] = x
    return U, B, nodes
