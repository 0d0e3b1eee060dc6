"""Stochastic trace estimation: deflated Hutchinson (Hutch++-style) — port of
``krylov_robustness_tpu/funm/trace.py`` (reference ``functions/mc_trace.m``,
``functions/trace_exp.m``).

The reference's stack of deflation handles (``mc_trace.m:47-48``) collapses
to one projector ``P = I − Q_acc·Q_accᵀ`` over the accumulated basis, kept
as one padded (n, m·K) block on the device; each outer iteration is three
operator applications, and the relative-change stop (``mc_trace.m:50-57``)
is a host check between iterations. Probes come from an explicit
``torch.Generator``: they are not the JAX package's ``jax.random`` bits, so
the device lane agrees with JAX to the estimator's tolerance, not bit for
bit. ``mc_trace_host`` and ``trace_exp_host`` are numpy/scipy, carried over,
and give JAX's numbers exactly for the same seed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..utils.device import resolve_device
from .expmv import ExpmvPlan, expmv, select_taylor_degree


def _rademacher(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """±1 probes drawn on the generator's device, then moved."""
    bits = torch.randint(0, 2, shape, generator=gen, device=gen.device)
    return (2 * bits - 1).to(dtype=dtype, device=device)


def _project(Qacc, x):
    """x − Q (Qᵀ x) with a zero-padded accumulated basis."""
    return x - Qacc @ (Qacc.T @ x)


def _mc_trace_iteration(op: Callable, gen, Qacc, tr, t_idx: int, scale,
                        m_probe: int):
    """One outer iteration (``mc_trace.m:42-49``)."""
    n = Qacc.shape[0]
    dtype, dev = Qacc.dtype, Qacc.device
    S = _rademacher(gen, (n, m_probe), dtype, dev)
    G = _rademacher(gen, (n, m_probe), dtype, dev)

    def defl_op(x):
        return _project(Qacc, op(_project(Qacc, x)))

    # second cross-block orthogonalization pass: one projection leaves
    # O(eps·κ) components along Qacc in Y, which QR would bake into "new"
    # directions
    Y = _project(Qacc, defl_op(S))
    Q, R = torch.linalg.qr(Y)
    # rank guard, absolute against the running scale of the operator: once
    # deflation nearly spans the range, QR of the residual returns junk
    # columns (|R_ii| ≈ 0) that are not orthogonal to Qacc; zero them out
    rdiag = torch.diagonal(R).abs()
    scale = torch.maximum(scale, rdiag.max())
    keep = rdiag > 100 * torch.finfo(dtype).eps * torch.clamp(scale,
                                                              min=1e-300)
    kept = int(keep.sum())
    Q = Q * keep[None, :].to(dtype)
    tr = tr + torch.trace(Q.T @ defl_op(Q))
    Qacc = Qacc.clone()
    Qacc[:, t_idx * m_probe:t_idx * m_probe + Q.shape[1]] = Q
    tr_new = tr + torch.trace(G.T @ _project(Qacc, op(_project(Qacc, G)))) \
        / m_probe
    return tr, tr_new, Qacc, scale, kept


def mc_trace(
    op: Callable,
    n: int,
    tol: float = 1e-3,
    maxit: int = 10,
    is_real: bool = True,
    m_probe: int = 10,
    generator: torch.Generator | None = None,
    dtype=torch.float64,
    *,
    device,
    debug: bool = False,
):
    """Trace of the black-box symmetric operator ``op`` (x ↦ A·x) on
    ``device``, which has no default (a CUDA request without CUDA raises).
    Outer budget ``K = ceil(maxit/(3·m))`` (``mc_trace.m:41``), per
    iteration m exact deflation directions + an m-probe Hutchinson
    remainder, stop when the relative change of the estimate drops below
    tol. ``generator`` draws the probes (default: seed 0 on the CPU).

    Returns (trace_estimate, residual, iterations).
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    K = max(-(-maxit // (3 * m_probe)), 1)
    # deflation cannot usefully exceed the space dimension: cap the outer
    # budget at full span (the rank guard zeroes the overshoot columns)
    K = min(K, max(-(-n // m_probe), 1))
    Qacc = torch.zeros((n, m_probe * K), dtype=dtype, device=device)
    tr = torch.zeros((), dtype=dtype, device=device)
    scale = torch.zeros((), dtype=dtype, device=device)
    tr_old = 0.0
    tr_new = tr
    res = float("inf")
    hits = 0
    # below 1e-4 a single sub-tol change can be a stochastic fluke: require
    # two consecutive hits (the reference's single-hit rule at its own tol)
    need_hits = 1 if tol >= 1e-4 else 2
    for it in range(K):
        tr, tr_new, Qacc, scale, kept = _mc_trace_iteration(
            op, generator, Qacc, tr, it, scale, m_probe)
        if kept == 0:
            # deflation exhausted the operator's numerical range: the exact
            # accumulator is the trace up to the dropped remainder, bounded
            # at ~n·eps·scale (reported relative)
            tr_new = tr
            res = float(n * torch.finfo(dtype).eps * scale.abs()
                        / torch.clamp(tr.abs(), min=1e-300))
            if debug:
                print(f"mc_trace it={it + 1} deflation exhausted; "
                      f"tr={float(tr):.6e}")
            break
        tr_new_f = float(tr_new)
        res = abs(tr_new_f - tr_old) / max(abs(tr_new_f), abs(tr_old), 1e-300)
        if debug:
            print(f"mc_trace it={it + 1} pts={(it + 1) * 3 * m_probe} "
                  f"tr={tr_new_f:.6e} res={res:.3e}")
        hits = hits + 1 if res < tol else 0
        if hits >= need_hits:
            break
        tr_old = tr_new_f
    return (float(tr_new) if is_real else tr_new), res, it + 1


def mc_trace_host(op, n: int, tol: float = 1e-3, maxit: int = 10,
                  m_probe: int = 10, seed: int = 0):
    """Host (numpy f64) twin of :func:`mc_trace` — same deflated-Hutchinson
    protocol (``mc_trace.m:42-58``) and the same three guards
    (re-orthogonalization, absolute rank guard, exhaustion stop)."""
    rng = np.random.default_rng(seed)
    K = max(-(-maxit // (3 * m_probe)), 1)
    K = min(K, max(-(-n // m_probe), 1))
    Qacc = np.zeros((n, 0))
    tr = 0.0
    tr_old = 0.0
    res = np.inf
    hits = 0
    need_hits = 1 if tol >= 1e-4 else 2
    tr_new = 0.0
    scale = 0.0
    for it in range(K):
        S = rng.choice([-1.0, 1.0], size=(n, m_probe))
        G = rng.choice([-1.0, 1.0], size=(n, m_probe))

        def defl(x):
            x = x - Qacc @ (Qacc.T @ x)
            y = op(x)
            return y - Qacc @ (Qacc.T @ y)

        Y = defl(S)
        Y = Y - Qacc @ (Qacc.T @ Y)
        Q, R = np.linalg.qr(Y)
        rdiag = np.abs(np.diagonal(R))
        scale = max(scale, rdiag.max(initial=0.0))
        keep = rdiag > 100 * np.finfo(np.float64).eps * max(scale, 1e-300)
        if not keep.any():
            tr_new = tr
            res = (n * np.finfo(np.float64).eps * abs(scale)
                   / max(abs(tr), 1e-300))
            break
        Q = Q[:, keep]
        tr = tr + np.trace(Q.T @ defl(Q))
        Qacc = np.concatenate([Qacc, Q], axis=1)
        tr_new = tr + np.trace(G.T @ defl(G)) / m_probe
        res = abs(tr_new - tr_old) / max(abs(tr_new), abs(tr_old), 1e-300)
        hits = hits + 1 if res < tol else 0
        if hits >= need_hits:
            break
        tr_old = tr_new
    return float(tr_new), res, it + 1


def trace_exp_host(A_scipy, tol: float = 1e-4, maxit: int = 1000,
                   m_probe: int = 10, sigma: float = 0.0,
                   seed: int = 0) -> float:
    """Host-lane trace(exp(A − σI)) (reference ``trace_exp.m`` protocol) in
    f64.

    * σ-shifted hub graphs (σ ≈ λmax > 20): a top-k ``eigsh`` partial sum
      with the certified tail bound (n−k)·e^{λk−σ}, k escalating from 64;
      falls back to the stochastic lane if the bound does not certify.
    * otherwise: :func:`mc_trace_host` over scipy's Al-Mohy–Higham
      ``expm_multiply`` action (the reference protocol).
    """
    A = sp.csr_matrix(A_scipy).astype(float)
    n = A.shape[0]

    if sigma > 20.0 and n > 50:
        # ARPACK's tol is relative (δλ ≈ tol·λmax ≈ tol·σ): scaled by σ to
        # keep the trace error ≤ ~1e-7 at any spectral scale
        eig_tol = min(1e-8, 1e-7 / sigma)
        for k in (64, 256, min(400, n - 2)):
            k = min(k, n - 2)
            w = spla.eigsh(A, k=k, which="LA", return_eigenvectors=False,
                           tol=eig_tol)
            w = np.sort(w)[::-1]
            tr = float(np.sum(np.exp(w - sigma)))
            tail = (n - k) * float(np.exp(w[-1] - sigma))
            if tail < 1e-6 * tr:
                return tr
            if k >= n - 2:
                break

    if sigma:
        A = (A - sigma * sp.identity(n, format="csr")).tocsr()

    def op(x):
        return spla.expm_multiply(A, x)

    tr, _, _ = mc_trace_host(op, n, tol=tol, maxit=maxit, m_probe=m_probe,
                             seed=seed)
    return tr


def trace_exp(A, tol: float = 1e-4, maxit: int = 1000,
              generator: torch.Generator | None = None,
              plan: ExpmvPlan | None = None, m_probe: int = 10,
              sigma: float = 0.0):
    """Estimate trace(exp(A − σI)) on A's device — reference
    ``functions/trace_exp.m``: Hutchinson over the ``expmv`` action with tol
    1e-4. σ≈λmax keeps the f32 lane finite on hub graphs (ratios such as
    Δtrace/trexp are σ-invariant)."""
    if plan is None:
        plan = select_taylor_degree(A, t=1.0, b_cols=m_probe)

    def op(x):
        return expmv(A, x, t=1.0, plan=plan, sigma=sigma)

    tr, _, _ = mc_trace(op, A.n, tol=tol, maxit=maxit, is_real=True,
                        m_probe=m_probe, generator=generator, dtype=A.dtype,
                        device=A.device)
    return tr
