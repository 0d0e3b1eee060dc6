"""Block Lanczos of the PyTorch port (krylov/lanczos.py) against the JAX
package in f64 on the CPU: coefficient blocks, breakdown steps and the
assembled projection agree to round-off (atol 1e-10)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.interop import (
    coo_from_arrays,
    lanczos_state_from_arrays,
)
from krylov_robustness_torch.krylov import lanczos as tl
from krylov_robustness_tpu.krylov import lanczos as jl
from krylov_robustness_tpu.ops.sparse import CooMatrix

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

ATOL = 1e-10


def _pair(A):
    """The same scipy matrix as a JAX and a port COO operator (the port's
    built from the JAX container's arrays)."""
    M = CooMatrix.from_scipy(sp.csr_matrix(A))
    T = coo_from_arrays(np.asarray(M.rows), np.asarray(M.cols),
                        np.asarray(M.vals), M.n, M.nnz, "cpu")
    return M, T


def _compare_run(A, U, m):
    M, T = _pair(A)
    bj, Rj, sj = jl.lanczos_run(M, jnp.asarray(U), m)
    bt, Rt, st = tl.lanczos_run(T, torch.as_tensor(U), m)
    np.testing.assert_allclose(bt.h.numpy(), np.asarray(bj.h), atol=ATOL)
    np.testing.assert_allclose(bt.beta.numpy(), np.asarray(bj.beta),
                               atol=ATOL)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=ATOL)
    np.testing.assert_array_equal(bt.lucky_step.numpy(),
                                  np.asarray(bj.lucky_step))
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(sj.alive))
    Gj = np.asarray(jl.assemble_tridiag(bj, bs=U.shape[-1], m=m))
    Gt = tl.assemble_tridiag(bt, bs=U.shape[-1], m=m).numpy()
    np.testing.assert_allclose(Gt, Gj, atol=ATOL)
    return bt, st


@pytest.mark.parametrize("bs", [1, 2])
def test_blocks_match_jax(bs):
    """The tests/test_krylov.py shape: n=150, batch of 3 random blocks."""
    A = random_graph(150, 0.05, seed=42, weighted=True)
    U = np.random.default_rng(0).standard_normal((3, 150, bs))
    _compare_run(A, U, 8)


def test_twin_nodes_deflate_like_jax():
    """Twin nodes make A·[e_i, e_j] rank 1 after one step: the dependent
    column deflates (zero row in R, zero column in Q) and the recurrence
    keeps going, in both packages alike."""
    n = 180
    A = random_graph(n, 0.05, seed=20).toarray()
    A[1, :] = A[0, :]
    A[:, 1] = A[:, 0]
    A[0, 1] = A[1, 0] = 1.0
    A[3, :] = A[2, :]
    A[:, 3] = A[:, 2]
    A[2, 3] = A[3, 2] = 0.0
    np.fill_diagonal(A, 0.0)
    U = np.zeros((2, n, 2))
    U[0, 0, 0] = U[0, 1, 1] = 1.0  # adjacent twins
    U[1, 2, 0] = U[1, 3, 1] = 1.0  # non-adjacent twins
    bt, st = _compare_run(sp.csr_matrix(A), U, 6)
    assert bool(st.alive.all())  # deflation is not a breakdown
    # the deflated direction contributes an exact zero coupling block column
    assert np.allclose(bt.beta[0].numpy()[:, 1, :], 0.0)


def test_breakdown_matches_jax():
    """A 3-dim invariant subspace reachable from U: lucky breakdown at the
    same step, zero blocks afterwards."""
    n = 64
    D = np.zeros((n, n))
    D[:3, :3] = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 0.5], [0.0, 0.5, 1.0]])
    D[3:, 3:] = np.diag(np.arange(1, n - 2, dtype=float))
    U = np.zeros((2, n, 1))
    U[0, 0, 0] = 1.0
    U[1] = np.random.default_rng(1).standard_normal((n, 1))
    bt, st = _compare_run(sp.csr_matrix(D), U, 6)
    lucky = int(bt.lucky_step[0])
    assert lucky <= 3 and not bool(st.alive[0]) and bool(st.alive[1])
    assert np.allclose(bt.beta.numpy()[lucky:, 0], 0.0)


def test_resume_jax_state_in_torch():
    """A JAX-started recurrence, handed over through interop after 4 steps
    and continued 4 more in torch, equals the JAX recurrence continued."""
    A = random_graph(100, 0.06, seed=5, weighted=True)
    M, T = _pair(A)
    U = jnp.asarray(np.random.default_rng(3).standard_normal((2, 100, 2)))
    state, _ = jl.lanczos_start(M, U)
    _, state = jl.lanczos_continue(M, state, 4)
    b_j, state_j = jl.lanczos_continue(M, state, 4)
    ts = lanczos_state_from_arrays(np.asarray(state.v_prev),
                                   np.asarray(state.v_cur),
                                   np.asarray(state.alive), "cpu")
    b_t, state_t = tl.lanczos_continue(T, ts, 4)
    np.testing.assert_allclose(b_t.h.numpy(), np.asarray(b_j.h), atol=ATOL)
    np.testing.assert_allclose(b_t.beta.numpy(), np.asarray(b_j.beta),
                               atol=ATOL)
    np.testing.assert_allclose(state_t.v_cur.numpy(),
                               np.asarray(state_j.v_cur), atol=ATOL)


def test_resume_equals_straight_run():
    """Port-internal: run 4 + continue 4 is bit-identical to one 8-step run
    (the incremental API contract, lanczos_krylov.m:60-67)."""
    A = random_graph(100, 0.06, seed=5, weighted=True)
    _, T = _pair(A)
    U = torch.as_tensor(np.random.default_rng(3).standard_normal((1, 100, 2)))
    b8, _, _ = tl.lanczos_run(T, U, 8)
    state, _ = tl.lanczos_start(T, U)
    b1, state = tl.lanczos_continue(T, state, 4)
    b2, state = tl.lanczos_continue(T, state, 4)
    torch.testing.assert_close(b8.h, torch.cat([b1.h, b2.h]), rtol=0, atol=0)
    torch.testing.assert_close(b8.beta, torch.cat([b1.beta, b2.beta]),
                               rtol=0, atol=0)
