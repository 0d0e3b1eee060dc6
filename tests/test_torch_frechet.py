"""Entries and Fréchet derivatives of f(A) from per-node Krylov spaces in the
PyTorch port (updates/entries.py::function_multiple_entries and
updates/frechet.py, with the Hessian assembly of its FrechetBatch) against
the JAX package in f64 on the CPU, on the shapes and seeds of
tests/test_continuous.py, and against dense scipy oracles. Bases agree to
ATOL = 1e-10, every other result to RTOL = 1e-9 of its largest magnitude;
the dense oracles hold the port to the tolerances tests/test_continuous.py
holds the JAX package to."""

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch

from helpers import random_graph
from krylov_robustness_torch.ops.sparse import CooMatrix as TCoo
from krylov_robustness_torch.updates import entries as tent
from krylov_robustness_torch.updates import frechet as tfr
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo
from krylov_robustness_tpu.updates import entries as jent
from krylov_robustness_tpu.updates import frechet as jfr

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

ATOL = 1e-10
RTOL = 1e-9


def weighted_graph(n, density, seed):
    A = random_graph(n, density, seed=seed, weighted=True)
    return A / np.abs(A).max()


def _pair(A):
    """The same scipy matrix as a JAX and a port COO operator."""
    return JCoo.from_scipy(sp.csr_matrix(A)), TCoo.from_scipy(A, device="cpu")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * float(
        np.abs(want).max())


# -- updates/entries.py::function_multiple_entries ----------------------------
def test_function_multiple_entries_matches_jax_and_expm():
    """Per-row Arnoldi entries (lag 3) of exp(A) at 8 random pairs, n = 300:
    the same values and rounds as JAX, and the dense expm's entries."""
    A = weighted_graph(300, 0.03, seed=5)
    M, T = _pair(A)
    rng = np.random.default_rng(1)
    omega = np.stack([rng.integers(0, 300, size=8),
                      rng.integers(0, 300, size=8)], axis=1)
    vj, ij = jent.function_multiple_entries(M, omega, fun="exp", tol=1e-10)
    vt, it = tent.function_multiple_entries(T, omega, fun="exp", tol=1e-10)
    assert it == ij
    _close(vt.numpy(), np.asarray(vj))
    F = scipy.linalg.expm(A.toarray())
    np.testing.assert_allclose(vt.numpy(), F[omega[:, 0], omega[:, 1]],
                               rtol=1e-6, atol=1e-10)


# -- updates/frechet.py -------------------------------------------------------
def test_multiple_frechet_eval_matches_jax_and_block_expm():
    """Df(A)(E_ij) ≈ U_i X_h U_jᵀ (n = 150, three pairs, one diagonal):
    bases, cores and rounds as JAX's, each factorization the top-right
    block of expm([[A, E_ij], [0, A]]) (multiple_frechet_eval.m:176-183) to
    1e-6, and the Hessian assembly at the pairs, exact and the reference's
    one-term form, as JAX's."""
    n = 150
    A = weighted_graph(n, 0.05, seed=7)
    M, T = _pair(A)
    omega = np.array([[3, 11], [40, 3], [7, 7]])
    fj = jfr.multiple_frechet_eval(M, omega, fun="exp", tol=1e-10)
    ft = tfr.multiple_frechet_eval(T, omega, fun="exp", tol=1e-10)
    assert ft.iters == fj.iters and ft.node_index == fj.node_index
    np.testing.assert_allclose(ft.bases.numpy(), np.asarray(fj.bases),
                               atol=ATOL)
    _close(ft.X.numpy(), np.asarray(fj.X))
    Ad = A.toarray()
    for h, (i, j) in enumerate(omega):
        C = np.zeros((n, n))
        C[i, j] = 1.0
        want = scipy.linalg.expm(np.block([[Ad, C],
                                           [np.zeros((n, n)), Ad]]))[:n, n:]
        Ui = ft.bases[ft.node_index[int(i)]]
        Uj = ft.bases[ft.node_index[int(j)]]
        got = (Ui @ ft.X[h] @ Uj.T).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6
    for exact in (True, False):
        _close(ft.hessian(omega, exact=exact).numpy(),
               np.asarray(fj.hessian(omega, exact=exact)))
