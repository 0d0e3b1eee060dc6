"""Shared test utilities."""

import numpy as np
import scipy.sparse as sp


def random_graph(n, density, seed=0, weighted=False):
    """Random symmetric zero-diagonal sparse matrix (test graph)."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csr")
    A = A + A.T
    if not weighted:
        A.data[:] = 1.0
    A.setdiag(0)
    A.eliminate_zeros()
    return A.tocsr()


def twin_graph():
    """Twin nodes 0/1 (adjacent) and 2/3 (not) in a random graph of 120
    nodes, and start blocks (3, 120, 2): [e_0, e_1], [e_2, e_3] and a random
    one. A·[e_i, e_j] has rank 1, so a column deflates after the first block
    step and no member breaks down."""
    n = 120
    A = random_graph(n, 0.05, seed=20).toarray()
    A[1, :] = A[0, :]
    A[:, 1] = A[:, 0]
    A[0, 1] = A[1, 0] = 1.0
    A[3, :] = A[2, :]
    A[:, 3] = A[:, 2]
    A[2, 3] = A[3, 2] = 0.0
    np.fill_diagonal(A, 0.0)
    U = np.zeros((3, n, 2))
    U[0, 0, 0] = U[0, 1, 1] = 1.0
    U[1, 2, 0] = U[1, 3, 1] = 1.0
    U[2] = np.random.default_rng(4).standard_normal((n, 2))
    return sp.csr_matrix(A), U


def breakdown_graph():
    """A 3-dimensional invariant subspace on nodes 0-2, a diagonal on 3-62
    and an isolated node 63, and start blocks (4, 64, 1): e_0, which breaks
    down by the third step in f64 (in f32 its residual may stay at rounding
    level, above the tolerance); a random block, which runs on; a zero
    block, dead from the start; and e_63, whose block is 0 after one step in
    either type."""
    D = np.zeros((64, 64))
    D[:3, :3] = [[2.0, 1.0, 0.0], [1.0, 3.0, 0.5], [0.0, 0.5, 1.0]]
    D[3:63, 3:63] = np.diag(np.arange(1, 61, dtype=float))
    U = np.zeros((4, 64, 1))
    U[0, 0, 0] = U[3, 63, 0] = 1.0
    U[1] = np.random.default_rng(1).standard_normal((64, 1))
    return sp.csr_matrix(D), U
