"""Dense matrix functions of small (projected) matrices — port of
``krylov_robustness_tpu/funm/dense.py`` (reference ``functions/fun_diag.m``,
``functions/trace_fun_update.m:37-51``, ``functions/multiple_frechet_eval.m``
:150-159)."""

from __future__ import annotations

import torch

from .scalar import derivative_of, get_fun


def _nonfinite(M: torch.Tensor) -> torch.Tensor:
    """Which matrices of a batch hold a non-finite entry."""
    return ~torch.isfinite(M).all(dim=-1).all(dim=-1)


def eigh_or_nan(M: torch.Tensor):
    """(w, V) of symmetric matrices, batched. A matrix with a non-finite
    entry gets NaN eigenvalues and eigenvectors, as JAX's eigh returns them,
    where ``torch.linalg.eigh`` would raise; a NaN core then never passes a
    convergence test (``err < tol`` is False). Float32 input is decomposed
    in float64 and rounded back: the f32 divide-and-conquer solver fails to
    converge on Arnoldi projections with many deflated (zero) rows."""
    bad = _nonfinite(M)
    w, V = torch.linalg.eigh(torch.where(bad[..., None, None], 0, M).to(
        torch.promote_types(M.dtype, torch.float64)))
    w, V = w.to(M.dtype), V.to(M.dtype)
    return (torch.where(bad[..., None], float("nan"), w),
            torch.where(bad[..., None, None], float("nan"), V))


def fun_sym(M: torch.Tensor, f) -> torch.Tensor:
    """f(M) for symmetric M via eigendecomposition; batched over leading
    dimensions (``functions/fun_diag.m``). A non-finite matrix gives NaN."""
    f = get_fun(f)
    M = (M + M.transpose(-1, -2)) / 2
    w, V = eigh_or_nan(M)
    return torch.einsum("...ij,...j,...kj->...ik", V, f(w), V)


def eigvalsh_or_nan(M: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric matrices, batched. A matrix with a
    non-finite entry gets NaN eigenvalues, as JAX's eigvalsh returns them,
    where ``torch.linalg.eigvalsh`` would raise; callers exclude non-finite
    scores downstream."""
    bad = _nonfinite(M)
    d = torch.linalg.eigvalsh(torch.where(bad[..., None, None], 0, M))
    return torch.where(bad[..., None], float("nan"), d)


def trace_fun_difference_eigs(d1: torch.Tensor, d2: torch.Tensor, f,
                              shift=0.0) -> torch.Tensor:
    """sum f(d1−σ) − f(d2−σ) over the trailing axis of sorted eigenvalue
    arrays, with the reference's cancellation-safe form for exp
    (``trace_fun_update.m:44-50``): ``sum(exp(d1−σ)·(1 − exp(d2 − d1)))``.
    σ (``shift``) keeps every exponential O(1) on hub graphs whose λmax
    would overflow f32; ratios Δtrace/trace(exp(A)) are σ-invariant."""
    f = get_fun(f)
    if f.name == "exp":
        return torch.sum(torch.exp(d1 - shift) * -torch.expm1(d2 - d1),
                         dim=-1)
    return torch.sum(f(d1 - shift) - f(d2 - shift), dim=-1)


def trace_fun_update_dense(A: torch.Tensor, U: torch.Tensor, B: torch.Tensor,
                           f, shift=0.0) -> torch.Tensor:
    """Exact trace(f(A + U B Uᵀ) − f(A)) via two eigvalsh — the reference's
    dense small-n path and debug oracle."""
    At = A + U @ B @ U.T
    At = (At + At.T) / 2
    d1 = eigvalsh_or_nan(At)
    d2 = eigvalsh_or_nan((A + A.T) / 2)
    return trace_fun_difference_eigs(d1, d2, f, shift=shift)


def frechet_offdiag_sym(w1, V1, w2, V2, C, f) -> torch.Tensor:
    """Top-right block of f([[M1, C], [0, M2]]) for symmetric M1, M2 given by
    their eigendecompositions: the Daleckii–Krein form of the
    block-triangular trick the reference evaluates with a dense ``expm`` of
    the stacked matrix (``functions/multiple_frechet_eval.m:150-159``).

    X = V1 (F ∘ (V1ᵀ C V2)) V2ᵀ with F_ij = (f(w1_i) − f(w2_j)) / (w1_i − w2_j),
    the first divided difference, and f' at the midpoint where
    |w1_i − w2_j| < 1e-8. Batched over leading dims.
    """
    f = get_fun(f)
    df = derivative_of(f)
    num = f(w1)[..., :, None] - f(w2)[..., None, :]
    den = w1[..., :, None] - w2[..., None, :]
    mid = (w1[..., :, None] + w2[..., None, :]) / 2
    small = den.abs() < 1e-8
    F = torch.where(small, df(mid), num / torch.where(small, 1.0, den))
    Ct = torch.einsum("...ij,...ik,...kl->...jl", V1, C, V2)
    return torch.einsum("...ij,...jk,...lk->...il", V1, F * Ct, V2)


def frechet_offdiag(M1: torch.Tensor, M2: torch.Tensor, C: torch.Tensor,
                    f) -> torch.Tensor:
    """:func:`frechet_offdiag_sym` of two symmetric blocks, each
    symmetrized and decomposed first."""
    w1, V1 = eigh_or_nan((M1 + M1.transpose(-1, -2)) / 2)
    w2, V2 = eigh_or_nan((M2 + M2.transpose(-1, -2)) / 2)
    return frechet_offdiag_sym(w1, V1, w2, V2, C, f)
