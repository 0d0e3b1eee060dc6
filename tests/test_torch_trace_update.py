"""Batched Δtrace scoring of the PyTorch port (updates/trace_update.py)
against the JAX package in f64: deltas (rtol 1e-9), iteration counts and
convergence flags, on each path — dense n ≤ 130, the host-eigh lane,
incremental extension past the speculated rounds, the phase lane, and
chunking."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.funm.scalar import get_fun
from krylov_robustness_torch.ops.sparse import CooMatrix as TCoo
from krylov_robustness_torch.updates import trace_update as tu
from krylov_robustness_tpu.funm.scalar import get_fun as jax_get_fun
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo
from krylov_robustness_tpu.updates import trace_update as ju

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _ops(A):
    return JCoo.from_scipy(A), TCoo.from_scipy(A, device="cpu")


def _tol(A, rel):
    """Absolute tolerance rel·exp(λmax), the paper protocol's scaling: an
    absolute tol far below round-off of |Δ| would leave the accept step to
    rounding noise."""
    return rel * float(np.exp(np.linalg.eigvalsh(A.toarray()).max()))


def _assert_same(rt, rj, rtol=1e-9):
    np.testing.assert_allclose(rt.delta.numpy(), np.asarray(rj.delta),
                               rtol=rtol, atol=1e-12)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))


def _edges(A, count, missing=False, seed=4):
    Ad = A.toarray()
    iu, ju_ = np.nonzero(np.tril(1 - Ad - np.eye(len(Ad)) if missing
                                 else Ad, -1))
    pick = np.random.default_rng(seed).choice(len(iu), size=count,
                                              replace=False)
    return np.stack([iu[pick], ju_[pick]], axis=1)


def test_edge_blocks_match_jax():
    E = np.array([[3, 1], [4, 4], [0, 7]])
    U = tu.edge_start_blocks(9, E, torch.float64, "cpu").numpy()
    np.testing.assert_array_equal(
        U, np.asarray(ju.edge_start_blocks(9, jnp.asarray(E), jnp.float64)))
    B = tu.edge_B(E, -1.0, 2.0, torch.float64, "cpu").numpy()
    np.testing.assert_array_equal(
        B, np.asarray(ju.edge_B(jnp.asarray(E), -1.0, 2.0, jnp.float64)))


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_dense_path_matches_jax(sign):
    A = random_graph(100, 0.08, seed=13)
    M, T = _ops(A)
    E = _edges(A, 10, missing=sign > 0)
    rj = ju.trace_fun_update_edges(M, E, sign=sign, tol=1e-6)
    rt = tu.trace_fun_update_edges(T, E, sign=sign, tol=1e-6)
    assert int(rt.iters.max()) == 0  # dense path, no Krylov steps
    _assert_same(rt, rj)


@pytest.mark.parametrize("sign,fun", [(-1.0, "exp"), (1.0, "exp"),
                                      (-1.0, "sinh")])
def test_host_lane_matches_jax(sign, fun):
    A = random_graph(200, 0.04, seed=10)
    M, T = _ops(A)
    E = _edges(A, 12, missing=sign > 0)
    tol = _tol(A, 1e-9)
    rj = ju.trace_fun_update_edges(M, E, sign=sign, fun=fun, tol=tol,
                                   rescale=1.5, shift=2.0)
    rt = tu.trace_fun_update_edges(T, E, sign=sign, fun=fun, tol=tol,
                                   rescale=1.5, shift=2.0)
    assert int(rt.iters.min()) > 0
    _assert_same(rt, rj)


def test_twin_nodes_match_jax():
    n = 180
    A = random_graph(n, 0.05, seed=20).toarray()
    A[1, :] = A[0, :]
    A[:, 1] = A[:, 0]
    A[0, 1] = A[1, 0] = 1.0
    np.fill_diagonal(A, 0.0)
    A = sp.csr_matrix(A)
    M, T = _ops(A)
    iu, jv = np.nonzero(np.tril(A.toarray(), -1))
    E = np.array([[1, 0]] + [[i, j] for i, j in zip(iu, jv)
                             if {i, j} & {0, 1}][:5])
    tol = _tol(A, 1e-9)
    _assert_same(tu.trace_fun_update_edges(T, E, sign=-1.0, tol=tol),
                 ju.trace_fun_update_edges(M, E, sign=-1.0, tol=tol))


def test_incremental_extension_matches_jax():
    """A tolerance that needs more than the speculated first round: the
    carried recurrence is extended incrementally, bit-identical to the
    port's full-budget speculation and equal to JAX's."""
    A = random_graph(200, 0.05, seed=11)
    M, T = _ops(A)
    C = sp.coo_matrix(sp.tril(A, -1))
    E = np.stack([C.row[:8], C.col[:8]], axis=1)
    sched = (6, 6, 8, 12)
    U0 = tu.edge_start_blocks(200, E, torch.float64, "cpu")
    B = tu.edge_B(E, -1.0, 1.0, torch.float64, "cpu")
    tol = _tol(A, 1e-12)
    inc = tu._trace_update_host_eigh(T, U0, B, get_fun("exp"), tol, sched,
                                     lag=2, spec_rounds=1)
    full = tu._trace_update_host_eigh(T, U0, B, get_fun("exp"), tol, sched,
                                      lag=2, spec_rounds=None)
    np.testing.assert_array_equal(inc.delta.numpy(), full.delta.numpy())
    np.testing.assert_array_equal(inc.iters.numpy(), full.iters.numpy())
    assert int(inc.iters.min()) > sched[0]
    rj = ju._trace_update_host_eigh(
        M, ju.edge_start_blocks(200, jnp.asarray(E), jnp.float64),
        ju.edge_B(jnp.asarray(E), -1.0, 1.0, jnp.float64),
        jax_get_fun("exp"), tol, sched, lag=2, spec_rounds=None)
    _assert_same(inc, rj)


def test_chunking_matches_jax(monkeypatch):
    """700 candidates with the cell ceiling patched to 256 columns: two
    full chunks and a padded tail, in both packages."""
    n = 150
    A = random_graph(n, 0.06, seed=11)
    M, T = _ops(A)
    iu, jv = np.nonzero(np.tril(A.toarray(), -1))
    E = np.stack([iu, jv], axis=1)[:700]
    full = tu.trace_fun_update_edges(T, E, sign=-1.0, tol=1e-2)
    monkeypatch.setattr(tu, "MAX_SCORE_CELLS", 256 * n)
    monkeypatch.setattr(ju, "MAX_SCORE_CELLS", 256 * n)
    chunked = tu.trace_fun_update_edges(T, E, sign=-1.0, tol=1e-2)
    assert chunked.delta.shape == (700,)
    np.testing.assert_allclose(chunked.delta.numpy(), full.delta.numpy(),
                               rtol=1e-12)
    _assert_same(chunked, ju.trace_fun_update_edges(M, E, sign=-1.0,
                                                    tol=1e-2))


def test_phase_lane_not_ported_raises():
    """The phase lane (``host_eigh=False``), once refused by the port, runs:
    on tests/test_trace_update.py:239-261's setup (n = 300, 12 edges, tol
    1e-9) its deltas equal JAX's phase lane to rtol 1e-9."""
    A = random_graph(300, 0.04, seed=11)
    M, T = _ops(A)
    C = sp.coo_matrix(sp.tril(A, -1))
    E = np.stack([C.row[:12], C.col[:12]], axis=1)
    rj = ju.trace_fun_update_batched(
        M, ju.edge_start_blocks(300, jnp.asarray(E), jnp.float64),
        ju.edge_B(jnp.asarray(E), -1.0, 1.0, jnp.float64), tol=1e-9,
        host_eigh=False)
    rt = tu.trace_fun_update_batched(
        T, tu.edge_start_blocks(300, E, torch.float64, "cpu"),
        tu.edge_B(E, -1.0, 1.0, torch.float64, "cpu"), tol=1e-9,
        host_eigh=False)
    np.testing.assert_allclose(rt.delta.numpy(), np.asarray(rj.delta),
                               rtol=1e-9)


@pytest.mark.parametrize("sign,fun,phases", [
    (-1.0, "exp", (3, 2, 2)), (1.0, "exp", (3, 2, 2)),
    (-1.0, "sinh", (3, 2, 2)), (-1.0, "exp", (1, 1)),
])
def test_phase_lane_matches_jax(sign, fun, phases):
    """The phase lane against JAX's on the same graph at the protocol's
    tolerance scaling (rel·exp(λmax)): deltas to rtol 1e-9, identical
    iteration counts and flags. phases (1, 1) converge in the second phase,
    after the first phase's state is carried over."""
    A = random_graph(300, 0.04, seed=11)
    M, T = _ops(A)
    E = _edges(A, 12, missing=sign > 0)
    tol = _tol(A, 1e-9)
    kw = dict(fun=fun, tol=tol, host_eigh=False, shift=2.0, phases=phases)
    rj = ju.trace_fun_update_batched(
        M, ju.edge_start_blocks(300, jnp.asarray(E), jnp.float64),
        ju.edge_B(jnp.asarray(E), sign, 1.5, jnp.float64), **kw)
    rt = tu.trace_fun_update_batched(
        T, tu.edge_start_blocks(300, E, torch.float64, "cpu"),
        tu.edge_B(E, sign, 1.5, torch.float64, "cpu"), **kw)
    assert int(rt.iters.min()) > (6 if phases[0] == 1 else 0)
    _assert_same(rt, rj)


def test_band_from_blocks_matches_jax():
    rng = np.random.default_rng(12)
    for bs in (1, 2, 3):
        h = rng.standard_normal((7, 4, 2 * bs, bs))
        beta = rng.standard_normal((7, 4, bs, bs))
        Cm = rng.standard_normal((4, bs, bs))
        for got, want in zip(tu._band_from_blocks(h, beta, Cm, 7, bs),
                             ju._band_from_blocks(h, beta, Cm, 7, bs)):
            np.testing.assert_array_equal(got, want)
