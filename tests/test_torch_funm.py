"""Normalizers and centralities of the PyTorch port (funm/normest.py,
funm/expmv.py, funm/trace.py, graphs/centrality.py) against the JAX package
in f64 on the CPU.

Deterministic functions agree to round-off (rtol 1e-12, power iterations
1e-9); the host lanes draw the same numpy probes and give JAX's numbers
exactly, except where ARPACK's random start vector enters (then within the
eigsh tolerance); the device stochastic trace draws from a torch.Generator,
so it is held to its own 1e-4 tolerance against a dense trace(expm(A))."""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.funm import expmv as texpmv
from krylov_robustness_torch.funm import normest as tnorm
from krylov_robustness_torch.funm import trace as ttrace
from krylov_robustness_torch.graphs import centrality as tcent
from krylov_robustness_torch.ops.sparse import CooMatrix as TCoo
from krylov_robustness_tpu.funm import expmv as jexpmv
from krylov_robustness_tpu.funm import normest as jnorm
from krylov_robustness_tpu.funm import trace as jtrace
from krylov_robustness_tpu.graphs import centrality as jcent
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _ops(A):
    return JCoo.from_scipy(A), TCoo.from_scipy(A, device="cpu")


def _signed(n=150, seed=2):
    """A symmetric graph with mixed-sign weights and a diagonal."""
    A = random_graph(n, 0.06, seed=seed, weighted=True).tolil()
    rng = np.random.default_rng(seed)
    A.setdiag(rng.uniform(-1, 1, n))
    A = sp.csr_matrix(A)
    S = sp.triu(A, 1)
    S.data *= rng.choice([-1.0, 1.0], S.nnz)
    return sp.csr_matrix(S + S.T + sp.diags(A.diagonal()))


def test_norms_match_jax():
    for A in (random_graph(200, 0.05, seed=1, weighted=True), _signed()):
        M, T = _ops(A)
        np.testing.assert_allclose(float(tnorm.norm1(T)),
                                   float(jnorm.norm1(M)), rtol=1e-14)
        np.testing.assert_allclose(float(tnorm.normest2(T, tol=1e-2)),
                                   float(jnorm.normest2(M, tol=1e-2)),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(tnorm.normest2(T, tol=1e-10)),
                                   float(jnorm.normest2(M, tol=1e-10)),
                                   rtol=1e-12)
        x = np.random.default_rng(0).standard_normal((A.shape[0], 3))
        assert float(tnorm.norm_inf_rowsum(torch.as_tensor(x))) == float(
            jnorm.norm_inf_rowsum(jnp.asarray(x)))
        # ARPACK starts from its own random vector: within the eigsh
        # tolerance both use (1e-2 · tol = 1e-4)
        np.testing.assert_allclose(tnorm.normest2_host(A),
                                   jnorm.normest2_host(A), rtol=1e-4)
    A = random_graph(200, 0.05, seed=1)
    M, T = _ops(A)
    np.testing.assert_allclose(float(tnorm.normAm_nonneg(T, 4)),
                               float(jnorm.normAm_nonneg(M, 4)), rtol=1e-12)


def test_normest1_power_matches_jax():
    A = _signed()
    for m, t in ((1, 2), (3, 2), (2, 1)):
        assert tnorm.normest1_power(lambda X: A @ X, A.shape[0], m=m, t=t) \
            == jnorm.normest1_power(lambda X: A @ X, A.shape[0], m=m, t=t)


@pytest.mark.parametrize("kind", ["nonneg", "signed"])
def test_taylor_plan_and_expmv_match_jax(kind):
    """Degree/stage plans are identical (both α estimators: |A| chained
    products and the normest1 block estimator), and exp(t(A−σI))·b agrees
    to rtol 1e-12, with and without the μ shift."""
    A = random_graph(150, 0.08, seed=7) if kind == "nonneg" else _signed()
    M, T = _ops(A)
    b = np.random.default_rng(3).standard_normal((A.shape[0], 4))
    for shift, force in ((True, False), (True, True), (False, True)):
        pj = jexpmv.select_taylor_degree(M, t=1.0, b_cols=4, shift=shift,
                                         force_estm=force)
        pt = texpmv.select_taylor_degree(T, t=1.0, b_cols=4, shift=shift,
                                         force_estm=force)
        assert (pt.m, pt.s, pt.shift) == (pj.m, pj.s, pj.shift)
        np.testing.assert_allclose(pt.mu, pj.mu, rtol=1e-14)
        for sigma in (0.0, 3.0):
            fj = np.asarray(jexpmv.expmv(M, jnp.asarray(b), plan=pj,
                                         sigma=sigma))
            ft = texpmv.expmv(T, torch.as_tensor(b), plan=pt,
                              sigma=sigma).numpy()
            np.testing.assert_allclose(ft, fj, rtol=1e-12,
                                       atol=1e-12 * np.abs(fj).max())
    np.testing.assert_allclose(
        float(texpmv.normAm_abs(T, 3, mu=0.5)),
        float(jexpmv.normAm_abs(M, 3, mu=0.5)), rtol=1e-12)
    ref = scipy.linalg.expm(A.toarray()) @ b
    got = texpmv.expmv(T, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10 *
                               np.abs(ref).max())


def test_host_trace_lanes_equal_jax():
    """mc_trace_host and trace_exp_host are numpy/scipy with the same seed:
    JAX's numbers exactly on the stochastic lane; on the σ-shifted top-k
    lane to rtol 1e-10 (ARPACK starts from its own random vector)."""
    A = random_graph(120, 0.06, seed=5)
    assert ttrace.trace_exp_host(A) == jtrace.trace_exp_host(A)
    hub = random_graph(200, 0.2, seed=6)
    lam = float(np.linalg.eigvalsh(hub.toarray()).max())
    assert lam > 20
    np.testing.assert_allclose(ttrace.trace_exp_host(hub, sigma=lam),
                               jtrace.trace_exp_host(hub, sigma=lam),
                               rtol=1e-10)
    op = (lambda x: A @ x)
    assert ttrace.mc_trace_host(op, 120, tol=1e-3, maxit=100) == \
        jtrace.mc_trace_host(op, 120, tol=1e-3, maxit=100)


@pytest.mark.parametrize("sigma", [0.0, 5.0])
def test_trace_exp_within_tolerance_of_dense(sigma):
    """The device lane (torch.Generator probes, not JAX's bits) within its
    1e-4 relative tolerance of a dense trace(expm(A − σI)); JAX's device
    lane lies within the same band."""
    A = random_graph(300, 0.03, seed=9)
    M, T = _ops(A)
    dense = float(np.sum(np.exp(np.linalg.eigvalsh(A.toarray()) - sigma)))
    got = ttrace.trace_exp(T, sigma=sigma)
    assert abs(got - dense) <= 1e-4 * dense
    assert abs(jtrace.trace_exp(M, sigma=sigma) - dense) <= 1e-4 * dense
    again = ttrace.trace_exp(T, sigma=sigma,
                             generator=torch.Generator().manual_seed(0))
    assert again == got  # the default generator is seed 0


def test_mc_trace_exact_once_deflation_spans():
    """A rank-5 operator: the first outer iteration's 10 probes span its
    range, so the estimate is exact, and the next iteration finds nothing
    left above the absolute rank guard and stops (exhaustion)."""
    rng = np.random.default_rng(8)
    U = np.linalg.qr(rng.standard_normal((40, 5)))[0]
    D = torch.as_tensor(U @ np.diag([5.0, 4.0, 3.0, 2.0, 1.0]) @ U.T)
    tr, res, its = ttrace.mc_trace(lambda x: D @ x, 40, tol=1e-12,
                                   maxit=300, device="cpu")
    np.testing.assert_allclose(tr, 15.0, rtol=1e-12)
    assert its == 2 and res < 1e-10


def test_mc_trace_takes_an_explicit_device():
    """No default device: omitting it is a TypeError, and a CUDA request on
    a machine without CUDA raises instead of running on the CPU."""
    D = torch.eye(20, dtype=torch.float64)
    with pytest.raises(TypeError, match="device"):
        ttrace.mc_trace(lambda x: D @ x, 20)
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrace.mc_trace(lambda x: D @ x, 20, device="cuda")


@pytest.mark.parametrize("kind", ["eig", "deg", "pr", "res", "exp"])
def test_device_centralities_match_jax(kind):
    A = random_graph(120, 0.07, seed=11)
    M, T = _ops(A)
    got = tcent.compute_centrality(T, kind)
    want = jcent.compute_centrality(M, kind)
    assert isinstance(got, np.ndarray) and got.shape == (120,)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
