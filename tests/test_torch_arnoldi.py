"""The stored-basis block Arnoldi of the PyTorch port (krylov/arnoldi.py) and
what it carries — updates/fun_update.py, the expmv entries of
updates/entries.py and the Fréchet forms of funm/dense.py — against the JAX
package in f64 on the CPU, on the shapes and seeds of
tests/test_continuous.py, and against dense scipy oracles (the per-row
spaces of entries and Fréchet derivatives: tests/test_torch_frechet.py).
Basis and coefficients agree to ATOL = 1e-10; every function of A to
RTOL = 1e-9 of its largest magnitude; the dense oracles hold the port to
the tolerances tests/test_continuous.py holds the JAX package to."""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.funm import dense as tdense
from krylov_robustness_torch.interop import arnoldi_state_from_arrays
from krylov_robustness_torch.krylov import arnoldi as tarn
from krylov_robustness_torch.ops.sparse import CooMatrix as TCoo
from krylov_robustness_torch.updates import entries as tent
from krylov_robustness_torch.updates import fun_update as tfu
from krylov_robustness_torch.updates.low_rank import weights_to_low_rank
from krylov_robustness_tpu.funm import dense as jdense
from krylov_robustness_tpu.krylov import arnoldi as jarn
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo
from krylov_robustness_tpu.updates import entries as jent
from krylov_robustness_tpu.updates import fun_update as jfu
from krylov_robustness_tpu.updates.low_rank import (
    weights_to_low_rank as j_weights_to_low_rank,
)

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
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale


# -- krylov/arnoldi.py --------------------------------------------------------
@pytest.mark.parametrize("bs", [1, 3])
def test_arnoldi_run_matches_jax(bs):
    """Basis, coupling columns, β blocks, R0 and the assembled Hessenberg
    projection after 8 of 10 steps (batch of 2, weighted n = 300)."""
    A = weighted_graph(300, 0.03, seed=2)
    M, T = _pair(A)
    B0 = np.random.default_rng(0).standard_normal((2, 300, bs))
    bj, Rj, sj = jarn.arnoldi_run(M, jnp.asarray(B0), 8, max_steps=10)
    bt, Rt, st = tarn.arnoldi_run(T, torch.as_tensor(B0), 8, max_steps=10)
    assert st.step == int(sj.step) == 8
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(sj.alive))
    for got, want in ((st.V, sj.V), (bt.h, bj.h), (bt.beta, bj.beta),
                      (Rt, Rj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for m in (1, 5, 8):
        np.testing.assert_allclose(
            tarn.assemble_hessenberg(bt, bs, m).numpy(),
            np.asarray(jarn.assemble_hessenberg(bj, bs, m)), atol=ATOL)
    # the basis is orthonormal over its filled columns, zero past them
    V = st.V.numpy()
    Q = V[:, :, :9 * bs]
    np.testing.assert_allclose(np.einsum("bnk,bnl->bkl", Q, Q),
                               np.broadcast_to(np.eye(9 * bs), (2, 9 * bs,
                                                                 9 * bs)),
                               atol=1e-12)
    assert not V[:, :, 9 * bs:].any()


def test_arnoldi_resumes_from_jax_state():
    """A JAX recurrence stopped after 4 steps, carried across with
    ``arnoldi_state_from_arrays`` and extended by 4 steps in torch, equals
    JAX's own extension."""
    A = weighted_graph(300, 0.03, seed=2)
    M, T = _pair(A)
    B0 = np.random.default_rng(1).standard_normal((2, 300, 2))
    s0, _ = jarn.arnoldi_start(M, jnp.asarray(B0), max_steps=8)
    _, s4 = jarn.arnoldi_continue(M, s0, 4, 2)
    bj, sj = jarn.arnoldi_continue(M, s4, 4, 2)
    st4 = arnoldi_state_from_arrays(np.asarray(s4.V), np.asarray(s4.step),
                                    np.asarray(s4.alive), "cpu")
    bt, st = tarn.arnoldi_continue(T, st4, 4, 2)
    np.testing.assert_allclose(st.V.numpy(), np.asarray(sj.V), atol=ATOL)
    np.testing.assert_allclose(bt.h.numpy(), np.asarray(bj.h), atol=ATOL)
    np.testing.assert_allclose(bt.beta.numpy(), np.asarray(bj.beta),
                               atol=ATOL)
    assert st.step == 8


def test_arnoldi_lucky_breakdown_matches_jax():
    """A start block inside a 2-dimensional invariant subspace (a
    disconnected edge): the member dies after one step in both packages and
    emits zero blocks from there on."""
    A = sp.lil_matrix((40, 40))
    A[0, 1] = A[1, 0] = 0.5
    A[2:, 2:] = weighted_graph(38, 0.2, seed=4).toarray()
    A = sp.csr_matrix(A)
    M, T = _pair(A)
    B0 = np.zeros((2, 40, 1))
    B0[0, 0, 0] = 1.0
    B0[1, 5, 0] = 1.0
    bj, _, sj = jarn.arnoldi_run(M, jnp.asarray(B0), 4)
    bt, _, st = tarn.arnoldi_run(T, torch.as_tensor(B0), 4)
    assert st.alive.tolist() == np.asarray(sj.alive).tolist() == [False,
                                                                    True]
    np.testing.assert_allclose(bt.h.numpy(), np.asarray(bj.h), atol=ATOL)
    np.testing.assert_allclose(st.V.numpy(), np.asarray(sj.V), atol=ATOL)
    assert not bt.beta[1:, 0].any()


# -- funm/dense.py: Fréchet forms ---------------------------------------------
def _sym(rng, m):
    X = rng.standard_normal((m, m))
    return (X + X.T) / 4


@pytest.mark.parametrize("f", ["exp", "sinh", "cosh"])
def test_frechet_offdiag_matches_jax(f):
    """frechet_offdiag_sym on the same eigendecompositions, and
    frechet_offdiag on the same blocks, for a batch of 3 pairs of 12 × 12
    blocks: distinct spectra, the same block twice (every pair of
    eigenvalues within the 1e-8 midpoint rule on the diagonal), and
    eigenvalues 1e-10 apart."""
    rng = np.random.default_rng(3)
    M1 = np.stack([_sym(rng, 12) for _ in range(3)])
    M2 = np.stack([_sym(rng, 12), M1[1], M1[2] + 1e-10 * np.eye(12)])
    C = rng.standard_normal((3, 12, 12))
    w1, V1 = np.linalg.eigh(M1)
    w2, V2 = np.linalg.eigh(M2)
    want = np.asarray(jdense.frechet_offdiag_sym(
        *(jnp.asarray(a) for a in (w1, V1, w2, V2, C)), f))
    got = tdense.frechet_offdiag_sym(
        *(torch.as_tensor(a) for a in (w1, V1, w2, V2, C)), f).numpy()
    _close(got, want)
    got = tdense.frechet_offdiag(*(torch.as_tensor(a) for a in (M1, M2, C)),
                                 f).numpy()
    want = np.asarray(jdense.frechet_offdiag(
        *(jnp.asarray(a) for a in (M1, M2, C)), f))
    _close(got, want)


def test_frechet_offdiag_is_the_block_triangular_function():
    """For f = exp the top-right block of expm([[M1, C], [0, M2]])
    (multiple_frechet_eval.m:150-159), with M2 = M1 as the coincident
    case."""
    rng = np.random.default_rng(5)
    M1, M2, C = _sym(rng, 10), _sym(rng, 10), rng.standard_normal((10, 10))
    for B in (M2, M1):
        want = scipy.linalg.expm(np.block([[M1, C],
                                           [np.zeros((10, 10)), B]]))[:10, 10:]
        got = tdense.frechet_offdiag(torch.as_tensor(M1), torch.as_tensor(B),
                                     torch.as_tensor(C), "exp").numpy()
        _close(got, want, 1e-12)


def test_eigh_or_nan_marks_a_nonfinite_matrix():
    """torch.linalg.eigh raises on a non-finite matrix where JAX returns
    NaN: the port returns NaN for that member only, so fun_sym gives a NaN
    core and a NaN lag error, which never passes err < tol."""
    M = torch.stack([torch.eye(3) * 2.0, torch.full((3, 3), float("inf"))])
    w, V = tdense.eigh_or_nan(M.double())
    assert torch.isnan(w[1]).all() and torch.isnan(V[1]).all()
    np.testing.assert_allclose(w[0].numpy(), [2.0, 2.0, 2.0])
    F = tdense.fun_sym(M.double(), "exp")
    assert torch.isnan(F[1]).all()
    assert not bool(torch.linalg.matrix_norm(F[1] - F[1]) < 1.0)
    # float32 input is decomposed in float64 and rounded back
    w32, V32 = tdense.eigh_or_nan(M[:1])
    assert w32.dtype == V32.dtype == torch.float32


# -- updates/fun_update.py ----------------------------------------------------
def test_fun_update_krylov_matches_jax_and_expm():
    """The Krylov path (tests/test_continuous.py's n = 300, three weighted
    edges): the core factor, basis and rounds equal JAX's, the low-rank
    product is exp(A + UBUᵀ) − exp(A) to 1e-7 and its entries and trace
    read it."""
    n = 300
    A = weighted_graph(n, 0.03, seed=2)
    M, T = _pair(A)
    Omega = np.array([[5, 9], [40, 3], [100, 57]])
    X = np.random.default_rng(0).uniform(0.1, 1.0, size=3)
    U, B, _ = weights_to_low_rank(Omega, X, n)
    uj = jfu.fun_update(M, jnp.asarray(U)[None], jnp.asarray(B)[None],
                        tol=1e-10)
    ut = tfu.fun_update(T, torch.as_tensor(U)[None], torch.as_tensor(B)[None],
                        tol=1e-10)
    assert not ut.is_dense and ut.iters == uj.iters
    np.testing.assert_array_equal(ut.converged.numpy(),
                                  np.asarray(uj.converged))
    _close(ut.Xm.numpy(), np.asarray(uj.Xm))
    np.testing.assert_allclose(ut.Um.numpy(), np.asarray(uj.Um), atol=ATOL)
    got = (ut.Um[0] @ ut.Xm[0] @ ut.Um[0].T).numpy()
    Ad = A.toarray()
    want = scipy.linalg.expm(Ad + U @ B @ U.T) - scipy.linalg.expm(Ad)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-7
    rows, cols = np.array([5, 40, 7]), np.array([9, 3, 200])
    _close(ut.entries(rows, cols).numpy(),
           np.asarray(uj.entries(rows, cols)))
    np.testing.assert_allclose(ut.entries(rows, cols)[0].numpy(),
                               want[rows, cols], atol=1e-9)
    np.testing.assert_allclose(float(ut.trace()[0]), np.trace(want),
                               rtol=1e-7)


def test_fun_update_f32_stops_at_its_rounding_floor():
    """In f32 a tolerance set for f64 (1e-10) is out of reach: the lag test
    stops at 32 eps of ‖f(G)‖ (here after 12 steps, where f64 meets its
    tolerance after 20) instead of running the whole schedule trimmed to
    n/2 (80 steps) unconverged, as the JAX package does; the trace agrees
    with f64 to f32 precision."""
    n = 1000
    A = weighted_graph(n, 0.01, seed=2)
    Omega = np.array([[5, 9], [40, 3], [100, 57]])
    X = np.random.default_rng(0).uniform(0.1, 1.0, size=3)
    U, B, _ = weights_to_low_rank(Omega, X, n)
    runs = {dt: tfu.fun_update(TCoo.from_scipy(A, dtype=dt, device="cpu"),
                               torch.as_tensor(U, dtype=dt)[None],
                               torch.as_tensor(B, dtype=dt)[None], tol=1e-10)
            for dt in (torch.float64, torch.float32)}
    u64, u32 = runs[torch.float64], runs[torch.float32]
    assert bool(u64.converged.all()) and bool(u32.converged.all())
    assert u32.iters <= u64.iters < 80
    np.testing.assert_allclose(float(u32.trace()[0]), float(u64.trace()[0]),
                               rtol=1e-5)


def test_fun_update_dense_fallback_matches_jax_and_expm():
    """n = 60 ≤ 130 takes the exact dense difference, as in JAX, also from
    a given ``A_dense``; its entries accessor reads the dense matrix."""
    n = 60
    A = weighted_graph(n, 0.1, seed=3)
    M, T = _pair(A)
    U = np.zeros((n, 2))
    U[3, 0] = 1.0
    U[8, 1] = 1.0
    B = 0.3 * np.array([[0.0, 1.0], [1.0, 0.0]])
    uj = jfu.fun_update(M, jnp.asarray(U)[None], jnp.asarray(B)[None],
                        tol=1e-10)
    Ut, Bt = torch.as_tensor(U)[None], torch.as_tensor(B)[None]
    ut = tfu.fun_update(T, Ut, Bt, tol=1e-10)
    ud = tfu.fun_update(T, Ut, Bt, tol=1e-10,
                        A_dense=torch.as_tensor(A.toarray()))
    assert ut.is_dense and uj.is_dense and ut.iters == 0
    _close(ut.Xm.numpy(), np.asarray(uj.Xm))
    np.testing.assert_array_equal(ud.Xm.numpy(), ut.Xm.numpy())
    Ad = A.toarray()
    want = scipy.linalg.expm(Ad + U @ B @ U.T) - scipy.linalg.expm(Ad)
    np.testing.assert_allclose(ut.Xm[0].numpy(), want, atol=1e-9)
    e = ut.entries(np.array([3, 8]), np.array([8, 3]))[0].numpy()
    np.testing.assert_allclose(e, [want[3, 8], want[8, 3]], atol=1e-10)


# -- updates/entries.py -------------------------------------------------------
def _omega(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, size=8), rng.integers(0, n, size=8)],
                    axis=1)


@pytest.mark.parametrize("f", ["sinh", "cosh"])
def test_entries_of_f_expmv_matches_jax(f):
    """The expmv-action entries of f(A) for the exp family, n = 300 (sinh
    and cosh take both exp(A)·E and exp(−A)·E): as JAX's, and as the dense
    f(A)'s."""
    A = weighted_graph(300, 0.03, seed=5)
    M, T = _pair(A)
    omega = _omega(300, 2)
    vj, _ = jent.entries_of_f_expmv(M, omega, fun=f)
    vt, zero = tent.entries_of_f_expmv(T, omega, fun=f)
    assert zero == 0
    _close(vt.numpy(), np.asarray(vj))
    Ad = A.toarray()
    F = {"sinh": scipy.linalg.sinhm(Ad), "cosh": scipy.linalg.coshm(Ad)}[f]
    np.testing.assert_allclose(vt.numpy(), F[omega[:, 0], omega[:, 1]],
                               rtol=1e-6, atol=1e-10)
    # f = exp takes exp(A)·E alone; any other f is refused, as in JAX
    E = scipy.linalg.expm(Ad)[omega[:, 0], omega[:, 1]]
    np.testing.assert_allclose(tent.entries_of_f_expmv(T, omega)[0].numpy(),
                               E, rtol=1e-6, atol=1e-10)
    with pytest.raises(ValueError, match="exp/sinh/cosh"):
        tent.entries_of_f_expmv(T, omega, fun="identity")


def test_seed_blocks_match_jax():
    nodes = np.array([4, 0, 17])
    np.testing.assert_array_equal(
        tent.seed_blocks(20, nodes, torch.float64, "cpu").numpy(),
        np.asarray(jent.seed_blocks(20, nodes, jnp.float64)))
    assert tent._trim((6, 6, 8, 12), 20) == jent._trim((6, 6, 8, 12), 20)
    assert tent._trim((6, 6), 4) == jent._trim((6, 6), 4) == [4]


def test_low_rank_factors_reach_both_packages_alike():
    """weights_to_low_rank is carried over unchanged."""
    Omega = np.array([[5, 9], [40, 3], [9, 40]])
    X = np.array([0.5, -0.25, 1.0])
    for got, want in zip(weights_to_low_rank(Omega, X, 50),
                         j_weights_to_low_rank(Omega, X, 50)):
        np.testing.assert_array_equal(got, want)
