"""The port's COO container and the host modules it carries over from the
JAX package (the port does not import it): each equal to its JAX
counterpart on the same inputs."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.funm import dense as tdense
from krylov_robustness_torch.funm import scalar as tscalar
from krylov_robustness_torch.funm.normest import normest2_host
from krylov_robustness_torch.graphs import preprocess as tpre
from krylov_robustness_torch.graphs import top_edges as ttop
from krylov_robustness_torch.graphs.centrality import compute_centrality_host
from krylov_robustness_torch.interop import coo_from_arrays
from krylov_robustness_torch.ops.banded_spmm import (
    rcm_bandwidth,
    rcm_permutation,
)
from krylov_robustness_torch.ops.sparse import CooMatrix, coo_spmm
from krylov_robustness_torch.utils.guards import check_finite
from krylov_robustness_tpu.funm import dense as jdense
from krylov_robustness_tpu.funm import normest as jnormest
from krylov_robustness_tpu.graphs import centrality as jcent
from krylov_robustness_tpu.graphs import preprocess as jpre
from krylov_robustness_tpu.graphs import top_edges as jtop
from krylov_robustness_tpu.ops import pallas_spmm as jspmm
from krylov_robustness_tpu.ops import sparse as jsparse
from krylov_robustness_tpu.utils.guards import check_finite as jcheck_finite
from test_greedy import connected_random_graph

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def test_coo_matches_jax():
    A = random_graph(120, 0.05, seed=3, weighted=True)
    x = np.random.default_rng(0).standard_normal((120, 4))
    M = jsparse.CooMatrix.from_scipy(A)
    T = CooMatrix.from_scipy(A, device="cpu")
    np.testing.assert_array_equal(T.rows.numpy(), np.asarray(M.rows)[:M.nnz])
    np.testing.assert_array_equal(T.vals.numpy(), np.asarray(M.vals)[:M.nnz])
    np.testing.assert_allclose(coo_spmm(T, torch.as_tensor(x)).numpy(),
                               np.asarray(jsparse.coo_spmm(M, jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)
    v = (T @ torch.as_tensor(x[:, 0])).numpy()
    assert v.shape == (120,)
    np.testing.assert_allclose(v, A @ x[:, 0], rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(T.todense().numpy(), A.toarray())
    assert (T.to_scipy() != A).nnz == 0
    F = coo_from_arrays(np.asarray(M.rows), np.asarray(M.cols),
                        np.asarray(M.vals), M.n, M.nnz, "cpu")
    np.testing.assert_array_equal(F.vals.numpy(), T.vals.numpy())


@pytest.mark.parametrize("order", ["min", "mult"])
def test_candidate_selection_matches_jax(order):
    A = connected_random_graph(80, 0.06, seed=23)
    c = compute_centrality_host(A, "deg") + np.linspace(0, 1e-3, 80)
    np.testing.assert_array_equal(ttop.find_top_edges(A, c, 30, order),
                                  jtop.find_top_edges(A, c, 30, order))
    np.testing.assert_array_equal(
        ttop.find_top_missing_edges(A, c, 30, order),
        jtop.find_top_missing_edges(A, c, 30, order))


def test_preprocess_and_rcm_match_jax():
    rng = np.random.default_rng(5)
    R = sp.random(300, 300, density=0.004, random_state=rng, format="coo")
    got, want = tpre.preprocess_unweighted(R), jpre.preprocess_unweighted(R)
    assert got.shape == want.shape and (got != want).nnz == 0
    p = rcm_permutation(got)
    np.testing.assert_array_equal(p, jspmm.rcm_permutation(got))
    assert rcm_bandwidth(got, p) == jspmm.rcm_bandwidth(got, p)
    assert rcm_bandwidth(got) == jspmm.rcm_bandwidth(got)


@pytest.mark.parametrize("kind", ["deg", "pr", "res", "exp", "eig"])
def test_host_centrality_and_normest_match_jax(kind):
    A = connected_random_graph(90, 0.06, seed=7)
    np.testing.assert_allclose(compute_centrality_host(A, kind),
                               jcent.compute_centrality_host(A, kind),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(normest2_host(A),
                               jnormest.normest2_host(A), rtol=1e-8)


def test_dense_functions_match_jax():
    rng = np.random.default_rng(9)
    S = rng.standard_normal((3, 12, 12))
    S = S + S.transpose(0, 2, 1)
    for f in ("exp", "sinh", "cosh", "identity"):
        np.testing.assert_allclose(
            tdense.fun_sym(torch.as_tensor(S), f).numpy(),
            np.asarray(jdense.fun_sym(jnp.asarray(S), f)),
            rtol=1e-10, atol=1e-10)
        d1, d2 = np.sort(rng.standard_normal((2, 4, 8)), axis=-1)
        np.testing.assert_allclose(
            tdense.trace_fun_difference_eigs(
                torch.as_tensor(d1), torch.as_tensor(d2), f,
                shift=0.5).numpy(),
            np.asarray(jdense.trace_fun_difference_eigs(
                jnp.asarray(d1), jnp.asarray(d2), f, shift=0.5)),
            rtol=1e-12)
    A = S[0]
    U = rng.standard_normal((12, 2))
    B = np.array([[0.0, -1.0], [-1.0, 0.0]])
    np.testing.assert_allclose(
        float(tdense.trace_fun_update_dense(
            torch.as_tensor(A), torch.as_tensor(U), torch.as_tensor(B),
            "exp")),
        float(jdense.trace_fun_update_dense(
            jnp.asarray(A), jnp.asarray(U), jnp.asarray(B), "exp")),
        rtol=1e-10)
    assert tscalar.derivative_of("sinh").name == "cosh"


def test_eigvalsh_or_nan():
    S = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    S[1, 0, 1] = float("nan")
    d = tdense.eigvalsh_or_nan(S)
    torch.testing.assert_close(d[0], torch.ones(3, dtype=torch.float64))
    assert bool(torch.isnan(d[1]).all())


def test_check_finite_matches_jax():
    good = np.array([1.0, -3.0])
    bad = np.array([1.0, np.inf])
    for x in (good, bad, [good, torch.tensor([2.0, -7.5])],
              {"a": bad, "n": np.arange(3)}):
        got = check_finite(x, "x")
        if isinstance(x, list):
            x = [np.asarray(v) for v in x]
        want = jcheck_finite(x, "x")
        assert (got.finite, got.max_abs) == (want.finite, want.max_abs)
    with pytest.raises(FloatingPointError):
        check_finite(bad).raise_if_bad()
