"""Batched Δtrace scoring of the PyTorch port (updates/trace_update.py)
against the JAX package in f64: deltas (rtol 1e-9), iteration counts and
convergence flags, on each path — dense n ≤ 130, the host-eigh lane,
its rounds for the stragglers only, the phase lane, and chunking."""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.funm.scalar import get_fun
from krylov_robustness_torch.ops.sparse import CooMatrix as TCoo
from krylov_robustness_torch.updates import trace_update as tu
from krylov_robustness_torch.utils import tracing
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
    """A tolerance that needs more than the first round: the carried
    recurrence is extended round by round for the stragglers and equals
    JAX's full-budget speculation."""
    A = random_graph(200, 0.05, seed=11)
    M, T = _ops(A)
    C = sp.coo_matrix(sp.tril(A, -1))
    E = np.stack([C.row[:8], C.col[:8]], axis=1)
    sched = (6, 6, 8, 12)
    U0 = tu.edge_start_blocks(200, E, torch.float64, "cpu")
    B = tu.edge_B(E, -1.0, 1.0, torch.float64, "cpu")
    tol = _tol(A, 1e-12)
    inc = tu._trace_update_host_eigh(T, U0, B, get_fun("exp"), tol, sched,
                                     lag=2)
    assert int(inc.iters.min()) > sched[0]
    rj = ju._trace_update_host_eigh(
        M, ju.edge_start_blocks(200, jnp.asarray(E), jnp.float64),
        ju.edge_B(jnp.asarray(E), -1.0, 1.0, jnp.float64),
        jax_get_fun("exp"), tol, sched, lag=2, spec_rounds=None)
    _assert_same(inc, rj)


SCHED = (6, 6, 8, 12)


def _three_round_batch():
    """A 150-node random cluster (degrees ~9) with an 80-node path hanging
    off it, and 14 candidates that the lag test accepts at three rounds of
    ``SCHED`` in f64: 7 cluster edges at m = 20, the 3 path edges next to
    the cluster at m = 12 and the 4 at the path's far end at m = 6."""
    nc, n = 150, 230
    Ad = np.zeros((n, n))
    Ad[:nc, :nc] = random_graph(nc, 0.06, seed=11).toarray()
    r = np.arange(nc - 1, n - 1)
    Ad[r, r + 1] = Ad[r + 1, r] = 1.0
    A = sp.csr_matrix(Ad)
    C = sp.coo_matrix(sp.tril(A, -1))
    E = np.stack([C.row, C.col], axis=1)
    inner, path = E[E[:, 0] < nc], E[E[:, 0] >= nc]
    inner = inner[np.random.default_rng(0).choice(len(inner), 7,
                                                  replace=False)]
    return A, np.concatenate([inner, path[:3], path[-4:]]), _tol(A, 1e-13)


class _Widths:
    """An operator that records the width of every product it is asked
    for; ``mesh_cands`` gives it a 'cands' mesh axis of that size, as a
    sharded operator whose product splits its columns has."""

    def __init__(self, op, mesh_cands=None):
        self.op, self.widths = op, []
        if mesh_cands:
            self.batch_axis = "cands"
            self.mesh = SimpleNamespace(shape={"cands": mesh_cands})

    def __matmul__(self, x):
        self.widths.append(x.shape[1])
        return self.op @ x

    def __getattr__(self, name):
        return getattr(self.op, name)


def _run_straggler_rounds(op):
    """The three-round batch through the host-eigh lane on ``op``: the
    result, its edges and the growth of the scorer's counters."""
    A, E, tol = _three_round_batch()
    U0 = tu.edge_start_blocks(A.shape[0], E, torch.float64, "cpu")
    B = tu.edge_B(E, -1.0, 1.0, torch.float64, "cpu")
    keys = ("krylov.steps_run", "krylov.steps_used", "scorer.members_dropped")
    before = tracing.counters()
    r = tu._trace_update_host_eigh(op, U0, B, get_fun("exp"), tol, SCHED,
                                   lag=2)
    after = tracing.counters()
    return r, E, {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def _jax_three_round():
    A, E, tol = _three_round_batch()
    n = A.shape[0]
    return ju._trace_update_host_eigh(
        JCoo.from_scipy(A), ju.edge_start_blocks(n, jnp.asarray(E),
                                                 jnp.float64),
        ju.edge_B(jnp.asarray(E), -1.0, 1.0, jnp.float64),
        jax_get_fun("exp"), tol, SCHED, lag=2, spec_rounds=None)


def test_straggler_rounds_run_for_the_unaccepted_only():
    """Candidates accepted at three different rounds: each round's steps
    run for the candidates not yet accepted (the products 2·batch wide in
    the first round, then 2·|stragglers|), every step run is one the lag
    test reads, the carry drops the members accepted before the last
    round, and Δ and iters equal JAX's full-budget speculation."""
    A, _, _ = _three_round_batch()
    op = _Widths(TCoo.from_scipy(A, device="cpu"))
    r, E, grew = _run_straggler_rounds(op)
    _assert_same(r, _jax_three_round())
    iters = r.iters.numpy()
    assert bool(r.converged.all())
    assert sorted(set(iters.tolist())) == [6, 12, 20]
    want, m = [], 0
    for steps in SCHED:
        m += steps
        left = int((iters >= m).sum())
        if not left:
            break
        want += [2 * left] * steps
    assert op.widths == want
    assert want[0] == 2 * len(E) and want[0] > want[6] > want[12]
    assert grew["krylov.steps_run"] == grew["krylov.steps_used"] == \
        int(iters.sum())
    assert grew["scorer.members_dropped"] == int((iters < 20).sum())


def test_straggler_rounds_pad_to_the_batch_axis():
    """On an operator whose product shards its columns over a 2-wide mesh
    axis, every round's carry is a multiple of that axis (7 stragglers in
    the last round run as 8, one repeated), and the results are those of
    the unsharded lane."""
    A, _, _ = _three_round_batch()
    op = _Widths(TCoo.from_scipy(A, device="cpu"), mesh_cands=2)
    r, E, grew = _run_straggler_rounds(op)
    _assert_same(r, _jax_three_round())
    assert all(w % (2 * 2) == 0 for w in op.widths)
    assert op.widths == [28] * 6 + [20] * 6 + [16] * 8
    assert grew["krylov.steps_run"] == 28 // 2 * 6 + 10 * 6 + 8 * 8
    assert grew["scorer.members_dropped"] == 7


def test_broken_down_members_leave_the_carry():
    """Candidates on a path and a triangle cut off from the rest exhaust
    their Krylov space (lucky breakdown) in the first round: they are
    accepted there and dropped from the carry, the others run on, and all
    equal JAX's full-budget speculation."""
    n = 200
    Ad = random_graph(n, 0.05, seed=3).toarray()
    Ad[:6], Ad[:, :6] = 0.0, 0.0
    for i, j in ((0, 1), (1, 2), (3, 4), (4, 5), (5, 3)):
        Ad[i, j] = Ad[j, i] = 1.0
    A = sp.csr_matrix(Ad)
    M, T = _ops(A)
    C = sp.coo_matrix(sp.tril(A, -1))
    E = np.stack([C.row, C.col], axis=1)
    E = np.concatenate([E[:5], E[-4:]])
    assert (E[:5] < 6).all() and (E[5:] >= 6).all()
    tol = _tol(A, 1e-12)
    op = _Widths(T)
    U0 = tu.edge_start_blocks(n, E, torch.float64, "cpu")
    B = tu.edge_B(E, -1.0, 1.0, torch.float64, "cpu")
    before = tracing.counters().get("scorer.members_dropped", 0)
    r = tu._trace_update_host_eigh(op, U0, B, get_fun("exp"), tol, SCHED,
                                   lag=2)
    assert tracing.counters()["scorer.members_dropped"] - before == 5
    assert op.widths == [18] * 6 + [8] * 6
    _assert_same(r, ju._trace_update_host_eigh(
        M, ju.edge_start_blocks(n, jnp.asarray(E), jnp.float64),
        ju.edge_B(jnp.asarray(E), -1.0, 1.0, jnp.float64),
        jax_get_fun("exp"), tol, SCHED, lag=2, spec_rounds=None))


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
