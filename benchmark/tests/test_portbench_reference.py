"""The plain references against dense SciPy at tiny sizes, the yardstick's
byte count against a hand count, and the reference's candidate orders
against the program's."""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

from benchmark.generators import chung_lu, preprocess, protocol_inputs, road
from benchmark.reference import (
    greedy as ref_greedy,
    top_edges_min,
    top_missing_edges_min,
    weighted as ref_weighted,
)
from benchmark.roofline import function_bytes, least_time_s


def graph(kind, seed=5):
    if kind == "road":
        return preprocess(road.make({"n": 300, "edges": 340, "max_chord": 30,
                                     "chords_per_junction": 4}, seed))
    return preprocess(chung_lu.make({"n": 300, "draws": 1500,
                                     "max_degree": 40}, seed))


@pytest.mark.parametrize("kind", ["road", "hub"])
def test_greedy_reference_matches_dense_expm(kind):
    A = graph(kind)
    lam, cent = protocol_inputs(A)
    assert lam == pytest.approx(np.max(np.linalg.eigvalsh(A.toarray())),
                                rel=1e-10)
    E = top_edges_min(A, cent, 12)
    Ad = A.toarray()
    base = np.trace(scipy.linalg.expm(Ad))
    exact = []
    for i, j in E:
        B = Ad.copy()
        B[i, j] = B[j, i] = 0.0
        exact.append(np.trace(scipy.linalg.expm(B)) - base)
    exact = np.asarray(exact)
    shift = lam if kind == "hub" else 0.0
    d, _ = ref_greedy.delta_trace_exp(A, E, sign=-1.0, shift=shift)
    np.testing.assert_allclose(d * np.exp(shift), exact, rtol=1e-10)


def test_greedy_control_is_coarser():
    """The TF32 control (emulated on the CPU) lands farther from the truth
    than f32 with full-precision products."""
    A = graph("road")
    lam, cent = protocol_inputs(A)
    E = top_edges_min(A, cent, 12)
    truth, _ = ref_greedy.delta_trace_exp(A, E)
    tol = 1e-6 * np.exp(lam)
    f32, _ = ref_greedy.delta_trace_exp(A, E, precision="float32", atol=tol)
    tf32, _ = ref_greedy.delta_trace_exp(A, E, precision="tf32", atol=tol)
    gap = lambda d: np.max(np.abs(d - truth) / np.abs(truth))  # noqa: E731
    assert gap(tf32) > gap(f32) > 1e-9


def test_step_numbers():
    cands = np.array([[3, 1], [5, 2], [7, 4]])
    d = np.array([-2.0, -3.0, -1.0])
    nums = ref_greedy.step_numbers(d, cands, (5, 2), -3.0003)
    assert nums["pick_outside"] == 0 and nums["pick_regret"] == 0.0
    assert nums["delta_gap"] == pytest.approx(1e-4)
    # a pick that is not the best reads its distance to the best, even when
    # it reports the best's Δ
    nums = ref_greedy.step_numbers(d, cands, (3, 1), -3.0)
    assert nums["pick_regret"] == pytest.approx(1 / 3)
    assert nums["delta_gap"] == pytest.approx(1 / 3)
    nums = ref_greedy.step_numbers(d, cands, (9, 9), -3.0)
    assert nums["pick_outside"] == 1
    assert ref_greedy.swapped_pick(d) == (2, -3.0)
    assert ref_greedy.swapped_pick(np.array([-1.0, -3.0])) == (0, -3.0)


def test_weighted_reference_matches_dense():
    A = graph("road")
    lam, cent = protocol_inputs(A)
    Om = ref_weighted.search_space(A, cent, "rewire", "sinh", 30, 10)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, len(Om))
    f, g = ref_weighted.objective_and_gradient(A, Om, x, "sinh")
    Ad = A.toarray()
    D = np.zeros_like(Ad)
    for (i, j), v in zip(Om, x):
        D[i, j] = D[j, i] = v

    def sinh(M):
        return (scipy.linalg.expm(M) - scipy.linalg.expm(-M)) / 2

    f_exact = -(np.trace(sinh(Ad + D)) - np.trace(sinh(Ad)))
    cosh = (scipy.linalg.expm(Ad + D) + scipy.linalg.expm(-Ad - D)) / 2
    assert f == pytest.approx(f_exact, rel=1e-11)
    np.testing.assert_allclose(g, -2 * cosh[Om[:, 0], Om[:, 1]], rtol=1e-11)
    f32, g32 = ref_weighted.objective_and_gradient(A, Om, x, "sinh",
                                                   precision="float32")
    assert abs(f32 - f_exact) / abs(f_exact) > 1e-10


def test_search_space_matches_dense_entries():
    A = graph("road", seed=9)
    _, cent = protocol_inputs(A)
    Om = ref_weighted.search_space(A, cent, "rewire", "sinh", 30, 10)
    cosh = (scipy.linalg.expm(A.toarray()) +
            scipy.linalg.expm(-A.toarray())) / 2
    for E, half in ((top_edges_min(A, cent, 15), Om[:5]),
                    (top_missing_edges_min(A, cent, 15), Om[5:])):
        g = cosh[E[:, 0], E[:, 1]]
        np.testing.assert_array_equal(half, E[np.argsort(-g,
                                                         kind="stable")[:5]])


@pytest.mark.parametrize("kind", ["road", "hub"])
def test_candidate_orders_match_the_program(kind):
    from krylov_robustness_torch.graphs.top_edges import (
        find_top_edges,
        find_top_missing_edges,
    )

    A = graph(kind)
    _, cent = protocol_inputs(A)
    np.testing.assert_array_equal(top_edges_min(A, cent, 80),
                                  find_top_edges(A, cent, 80, "min"))
    np.testing.assert_array_equal(top_missing_edges_min(A, cent, 40),
                                  find_top_missing_edges(A, cent, 40, "min"))


def test_preprocess_matches_the_program():
    from krylov_robustness_torch.graphs.preprocess import preprocess_unweighted

    raw = chung_lu.make({"n": 500, "draws": 900, "max_degree": 30}, 3)
    mine, theirs = preprocess(raw), preprocess_unweighted(raw)
    assert (mine != theirs).nnz == 0 and mine.shape == theirs.shape


def test_function_bytes_hand_count():
    """A 4 × 4 CSR with 5 entries, x of width 3: values 5·4 + indices 5·4 +
    row pointers 5·4 bytes, x and y 4·3·4 bytes each."""
    A = sp.csr_matrix(np.array([[0, 1, 0, 0], [1, 0, 1, 0], [0, 1, 0, 0],
                                [0, 0, 0, 2.0]], np.float32))
    assert A.nnz == 5
    hand = 5 * 4 + 5 * 4 + 5 * 4 + 2 * (4 * 3 * 4)
    assert function_bytes(4, A.nnz, 3, 4, 4) == hand == 156
    assert function_bytes(4, A.nnz, 3, 8, 8) == 5 * 12 + 20 + 2 * 96
    t, by = least_time_s(95672, 412448, 500, 4, 4)
    assert by == "bytes" and t == pytest.approx(
        function_bytes(95672, 412448, 500, 4, 4) / 3.35e12)
