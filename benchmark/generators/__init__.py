"""Seeded graph generators, one module each, found by the ``generator``
name of a configuration; the frozen preprocessing every generated graph
goes through; and the graph a run takes. A generator module has
``make(config, seed) -> scipy sparse`` (the raw graph, before
preprocessing)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import scipy.sparse.linalg as spla


def preprocess(A: sp.spmatrix) -> sp.csr_matrix:
    """The paper's preprocessing of an unweighted graph, frozen here so that
    the benchmark's inputs never follow a change in the program:
    ``spones(A + A')`` with no loops, then the largest connected component
    (``Tests/test_unweighted_break.m:45-53``). Float64 ones, sorted CSR."""
    C = sp.coo_matrix(A)
    rows = np.concatenate([C.row, C.col])
    cols = np.concatenate([C.col, C.row])
    keep = rows != cols
    S = sp.coo_matrix((np.ones(int(keep.sum())), (rows[keep], cols[keep])),
                      shape=A.shape).tocsr()
    S.sum_duplicates()
    S.data[:] = 1.0
    _, labels = csgraph.connected_components(S, directed=False)
    idx = np.flatnonzero(labels == np.argmax(np.bincount(labels)))
    S = S[idx, :].tocsc()[:, idx].tocsr()
    S.sort_indices()
    return S


def protocol_inputs(A: sp.csr_matrix) -> tuple[float, np.ndarray]:
    """(‖A‖₂, eigenvector centrality) of a connected 0/1 (or nonnegative)
    symmetric graph: its Perron eigenpair by ARPACK from the ones vector, so
    that every process gets the same vector. The benchmark hands both to the
    program and to the reference alike."""
    n = A.shape[0]
    lam, v = spla.eigsh(sp.csr_matrix(A, dtype=np.float64), k=1, which="LA",
                        v0=np.ones(n))
    return float(lam[0]), np.abs(v[:, 0])


def run_graph(config: dict, generator, seed: int) -> sp.csr_matrix:
    """The graph of one run: the configuration's stand-in, made once from
    its ``structure_seed`` and preprocessed, with its nodes relabeled by a
    permutation drawn from the run's seed. Every seed gets the same graph,
    and so the same work, under other labels."""
    A = preprocess(generator.make(config, config["structure_seed"]))
    perm = np.random.default_rng([seed, 1]).permutation(A.shape[0])
    C = sp.coo_matrix(A)
    out = sp.csr_matrix((C.data, (perm[C.row], perm[C.col])), shape=A.shape)
    out.sort_indices()
    return out
