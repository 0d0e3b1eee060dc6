"""The port's greedy make sweep (paper Table 3, ``mode='make'``) against the
benchmark's plain reference (``benchmark/reference``: NumPy, SciPy and
plain torch, independent of the port), in float64 on the CPU: at every
step the port commits the reference's argmax with the reference's Δ, on
the COO operator and on the super tiles with their explicit-zero
candidate slots; and the reference's make Δ against a dense ``expm``."""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

from benchmark.generators import chung_lu, preprocess, protocol_inputs
from benchmark.reference import greedy as ref
from benchmark.reference import top_missing_edges_min
from krylov_robustness_torch.optimize.greedy import greedy_krylov
from krylov_robustness_torch.utils import tracing

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

K, Q = 5, 20


def hub_graph(n, draws, max_degree, seed=3):
    """A seeded Chung–Lu graph with hubs, preprocessed as the paper's."""
    return preprocess(chung_lu.make({"n": n, "draws": draws,
                                     "max_degree": max_degree}, seed))


@pytest.fixture(scope="module")
def graph():
    A = hub_graph(300, 1500, 40)
    assert A.shape[0] > 130  # the scorer's host-eigh lane, not dense
    lam, cent = protocol_inputs(A)
    return A, lam, cent


def with_edges(A, edges):
    """A plus the 0/1 edges ``edges`` (missing from A), both triangles."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    C = sp.coo_matrix(A)
    return sp.csr_matrix(
        (np.ones(C.nnz + 2 * len(e)),
         (np.concatenate([C.row, e[:, 0], e[:, 1]]),
          np.concatenate([C.col, e[:, 1], e[:, 0]]))), shape=A.shape)


def sweep(graph, mode, backend):
    """(result, growth of ``sweep.slots``) of one f64 sweep."""
    A, lam, cent = graph
    before = tracing.counters().get("sweep.slots", 0)
    res = greedy_krylov(A, K, Q, cent, order="min",
                        tol=1e-14 * float(np.exp(lam)), mode=mode,
                        dtype=torch.float64, backend=backend, fused_steps=0,
                        device="cpu")
    return res, tracing.counters()["sweep.slots"] - before


@pytest.mark.parametrize("backend", ["coo", "bsr"])
def test_make_picks_and_deltas_match_the_reference(graph, backend):
    A, lam, cent = graph
    res, slots = sweep(graph, "make", backend)
    want = "CooMatrix" if backend == "coo" else "SuperBsrOperator(f32)"
    assert res.operator == want
    assert slots == 2 * (Q + K)
    top = top_missing_edges_min(A, cent, Q + K)
    for step in range(K):
        before = [tuple(e) for e in res.edges[:step].tolist()]
        cands = np.asarray([e for e in map(tuple, top.tolist())
                            if e not in before][:Q], np.int64)
        truth, _ = ref.delta_trace_exp(with_edges(A, before), cands,
                                       sign=+1.0)
        h = int(np.argmax(truth))
        assert truth[h] > 0
        assert tuple(res.edges[step]) == tuple(cands[h]), step
        assert res.per_step_delta[step] == pytest.approx(truth[h], rel=1e-10)
    assert (res.A_new != with_edges(A, res.edges)).nnz == 0


@pytest.mark.parametrize("backend", ["coo", "bsr"])
def test_a_break_sweep_builds_no_slots(graph, backend):
    _, slots = sweep(graph, "break", backend)
    assert slots == 0


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_reference_make_delta_matches_dense_expm(shift):
    A = hub_graph(60, 200, 12, seed=4)
    assert A.shape[0] <= 60
    lam, cent = protocol_inputs(A)
    E = top_missing_edges_min(A, cent, 10)
    Ad = A.toarray()
    base = np.trace(scipy.linalg.expm(Ad))
    exact = np.array([np.trace(scipy.linalg.expm(
        with_edges(A, [e]).toarray())) - base for e in E])
    sigma = shift * lam
    d, _ = ref.delta_trace_exp(A, E, sign=+1.0, shift=sigma)
    assert np.all(exact > 0)
    np.testing.assert_allclose(d * np.exp(sigma), exact, rtol=1e-10)
