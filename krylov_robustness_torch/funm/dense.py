"""Dense matrix functions of small (projected) matrices — port of
``krylov_robustness_tpu/funm/dense.py`` (reference ``functions/fun_diag.m``,
``functions/trace_fun_update.m:37-51``)."""

from __future__ import annotations

import torch

from .scalar import get_fun


def fun_sym(M: torch.Tensor, f) -> torch.Tensor:
    """f(M) for symmetric M via eigendecomposition; batched over leading
    dimensions (``functions/fun_diag.m``)."""
    f = get_fun(f)
    M = (M + M.transpose(-1, -2)) / 2
    w, V = torch.linalg.eigh(M)
    return torch.einsum("...ij,...j,...kj->...ik", V, f(w), V)


def eigvalsh_or_nan(M: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric matrices, batched. A matrix with a
    non-finite entry gets NaN eigenvalues, as JAX's eigvalsh returns them,
    where ``torch.linalg.eigvalsh`` would raise; callers exclude non-finite
    scores downstream."""
    bad = ~torch.isfinite(M).all(dim=-1).all(dim=-1)
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
