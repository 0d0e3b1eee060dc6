"""Low-rank factors of f(A + U·B·Uᵀ) − f(A) ≈ Um·Xm·Umᵀ — port of
``krylov_robustness_tpu/updates/fun_update.py`` (reference
``functions/fun_update.m``).

Block Arnoldi with stored basis (the gradient assembly of the continuous
path reads the basis, ``fun_and_grad_krylov_exp.m:83-88``), the core factor
Xm = f(Gm+Cm) − f(Gm) from batched ``eigh`` on the operator's device, lag-2
Frobenius stopping (``fun_update.m:62-64,108-126``) checked once per round
on the host, with a floor at the dtype's rounding that the JAX package
lacks (so that f32 stops where it converges), and the exact dense
difference when the Krylov space would saturate half the dimension
(``fun_update.m:85-90``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..funm.dense import fun_sym
from ..funm.scalar import get_fun
from ..krylov.arnoldi import (
    ArnoldiBlocks,
    arnoldi_continue,
    arnoldi_start,
    assemble_hessenberg,
)
from .entries import DEFAULT_SCHEDULE, _trim


@dataclasses.dataclass
class FunUpdateResult:
    """Low-rank (or dense-fallback) representation of f(A+UBUᵀ) − f(A)."""

    Xm: torch.Tensor  # (batch, M, M) core factor (dense: (batch, n, n))
    Um: torch.Tensor  # (batch, n, M) basis (dense: the identity, expanded)
    converged: torch.Tensor  # (batch,)
    iters: int
    is_dense: bool

    def trace(self) -> torch.Tensor:
        return torch.diagonal(self.Xm, dim1=-2, dim2=-1).sum(-1)

    def entries(self, rows, cols) -> torch.Tensor:
        """delta f(A)_{rows[h], cols[h]} = (Um Xm Umᵀ)[rows[h], cols[h]]
        batched over the trailing entry list
        (``fun_and_grad_krylov_exp.m:85-87``)."""
        dev = self.Xm.device
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        cols = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
        if self.is_dense:
            return self.Xm[:, rows, cols]
        L = self.Um[:, rows, :]  # (batch, e, M)
        R = self.Um[:, cols, :]
        return torch.einsum("bem,bmp,bep->be", L, self.Xm, R)


def fun_update(
    A,
    U0: torch.Tensor,
    B: torch.Tensor,
    fun="exp",
    tol: float = 1e-12,
    schedule: Sequence[int] = DEFAULT_SCHEDULE,
    lag: int = 2,
    dense_cutoff: int = 130,
    A_dense: torch.Tensor | None = None,
) -> FunUpdateResult:
    """U0: (batch, n, bs); B: (batch, bs, bs) symmetric, both in A's dtype
    on A's device.

    Saturation rule: the Krylov dimension never exceeds n/2; if the schedule
    cannot fit a single round under that cap (or n ≤ dense_cutoff), the exact
    dense difference is computed instead (``fun_update.m:85-90``), from
    ``A_dense`` when given (so that a caller evaluating many updates
    densifies A once).
    """
    fun = get_fun(fun)
    batch, n, bs = U0.shape

    # --- dense fallback ---------------------------------------------------
    max_steps_cap = max(int(n // (2 * bs)) - 1, 0)
    if n <= dense_cutoff or max_steps_cap < schedule[0]:
        Ad = A.todense() if A_dense is None else A_dense
        At = Ad[None] + torch.einsum("bnk,bkl,bml->bnm", U0, B, U0)
        X = fun_sym(At, fun) - fun_sym(Ad, fun)[None]
        eye = torch.eye(n, dtype=U0.dtype, device=U0.device)
        return FunUpdateResult(
            Xm=X,
            Um=eye.expand(batch, n, n),
            converged=torch.ones((batch,), dtype=torch.bool,
                                 device=U0.device),
            iters=0,
            is_dense=True,
        )

    sched = _trim(schedule, max_steps_cap)
    state, R0 = arnoldi_start(A, U0, max_steps=sum(sched))
    Cm_small = torch.einsum("bkl,blm,bpm->bkp", R0, B, R0)

    h_all, beta_all = [], []
    m_done = 0
    converged = torch.zeros((batch,), dtype=torch.bool, device=U0.device)
    eps_m = torch.finfo(U0.dtype).eps
    for round_steps in sched:
        blocks, state = arnoldi_continue(A, state, round_steps, bs)
        h_all.append(blocks.h)
        beta_all.append(blocks.beta)
        m_done += round_steps
        all_blocks = ArnoldiBlocks(h=torch.cat(h_all), beta=torch.cat(beta_all))
        X_now, scale = _core_factor(all_blocks, Cm_small, bs, m_done,
                                    fun.name)
        X_lag, _ = _core_factor(all_blocks, Cm_small, bs, m_done - lag,
                                fun.name)
        # lag comparison zero-pads the smaller iterate (fun_update.m:110-112)
        X_lag_pad = torch.zeros_like(X_now)
        X_lag_pad[:, :X_lag.shape[-1], :X_lag.shape[-1]] = X_lag
        err = torch.linalg.matrix_norm(X_now - X_lag_pad)
        # dtype-aware floor, as the Lanczos scorer has one: X is a difference
        # of two f(G), so the lag error cannot fall far below eps·‖f(G)‖, and
        # in f32 a tolerance set for f64 is never met. The JAX package then
        # runs the whole schedule, and the rounds past convergence add
        # rounding ghosts to the projection that moved an f32 objective by
        # ~10% on the card.
        tol_eff = torch.clamp(32.0 * eps_m * scale, min=tol)
        converged = converged | (err < tol_eff) | ~state.alive
        if bool(converged.all()):  # one host sync a round
            break

    return FunUpdateResult(
        Xm=X_now, Um=state.V[:, :, :m_done * bs], converged=converged,
        iters=m_done, is_dense=False)


def _core_factor(blocks, Cm_small, bs: int, m: int, fun_name: str):
    """Xm = f(Gm + Cm) − f(Gm) on the m-step projection (batched eigh), and
    ‖f(Gm)‖_F, the scale of the difference's rounding."""
    G = assemble_hessenberg(blocks, bs, m)
    G = (G + G.transpose(-1, -2)) / 2  # fun_update.m:94
    k = Cm_small.shape[-1]
    tG = G.clone()
    tG[:, :k, :k] += (Cm_small + Cm_small.transpose(-1, -2)) / 2
    fG = fun_sym(G, fun_name)
    return fun_sym(tG, fun_name) - fG, torch.linalg.matrix_norm(fG)
