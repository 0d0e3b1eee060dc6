"""Batched block Arnoldi with stored basis and full reorthogonalization —
port of ``krylov_robustness_tpu/krylov/arnoldi.py`` (reference
``functions/arnoldi_krylov.m``, internally ``poly_krylov``).

The same incremental block recurrence as Lanczos, but each new block is
orthogonalized against the *entire* basis (double MGS and one pass after the
QR, ``arnoldi_krylov.m:89-110``), and V is kept: the gradient and Fréchet
paths read it. The basis is one preallocated (batch, n, (max_steps+1)·bs)
tensor whose unfilled columns are zero; each step writes its block into it
in place, so a state's V is the same tensor as its successor's. The MGS
products run over the filled columns only (the zero columns would add exact
zeros), and each step's coupling column h is padded with zeros to the full
height, as the JAX package's static shapes return it. The ``lax.scan`` of the
JAX package is a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .lanczos import _chol_qr as _chol_qr_n_major

LUCKY_TOL = 1e-12  # reference arnoldi_krylov.m:79


class ArnoldiState(NamedTuple):
    V: torch.Tensor  # (batch, n, max_cols) basis; zero beyond filled blocks
    step: int  # number of completed steps
    alive: torch.Tensor  # (batch,) bool


class ArnoldiBlocks(NamedTuple):
    h: torch.Tensor  # (steps, batch, max_cols, bs) full coupling columns
    beta: torch.Tensor  # (steps, batch, bs, bs)


def _chol_qr(w: torch.Tensor, eps: float):
    """Batch-major (batch, n, bs) adapter over the n-major Lanczos CholQR."""
    Q, R, ok = _chol_qr_n_major(w.transpose(0, 1), eps)
    return Q.transpose(0, 1), R, ok


def _spmm_batch(A, v: torch.Tensor) -> torch.Tensor:
    """A @ v for batch-major v (batch, n, bs): one SpMM of width batch·bs."""
    batch, n, bs = v.shape
    y = A @ v.transpose(0, 1).reshape(n, batch * bs)
    return y.reshape(n, batch, bs).transpose(0, 1)


def arnoldi_start(A, B0: torch.Tensor, max_steps: int,
                  lucky_tol: float = LUCKY_TOL):
    """Orthonormalize B0 into block 0 of the padded basis.

    Returns (state, R0) with B0 = V₀·R0.
    """
    batch, n, bs = B0.shape
    Q, R, ok = _chol_qr(B0, lucky_tol)
    V = torch.zeros((batch, n, (max_steps + 1) * bs), dtype=B0.dtype,
                    device=B0.device)
    V[:, :, :bs] = Q
    return ArnoldiState(V=V, step=0, alive=ok), R


def arnoldi_step(A, state: ArnoldiState, bs: int,
                 lucky_tol: float = LUCKY_TOL):
    """One Arnoldi block step (``arnoldi_krylov.m:78-111``); writes block
    step + 1 of ``state.V`` in place. Returns (state, h, beta)."""
    V, step, alive = state
    batch, n, max_cols = V.shape
    filled = (step + 1) * bs
    if filled + bs > max_cols:
        raise ValueError(f"the basis holds {max_cols // bs - 1} steps; "
                         f"step {step + 1} does not fit")
    Vf = V[:, :, :filled]
    w = _spmm_batch(A, V[:, :, step * bs:filled])

    def mgs(w):
        h = Vf.transpose(1, 2) @ w
        return w - Vf @ h, h

    w, h1 = mgs(w)
    w, h2 = mgs(w)
    h = h1 + h2
    Q, R, ok = _chol_qr(w, lucky_tol)
    # post-QR reorthogonalization pass (arnoldi_krylov.m:104-107)
    hh = Vf.transpose(1, 2) @ Q
    Q = Q - Vf @ hh
    h = h + hh @ R

    alive_next = alive & ok
    h = torch.where(alive[:, None, None], h, 0)
    beta = torch.where(alive_next[:, None, None], R, 0)
    V[:, :, filled:filled + bs] = torch.where(alive_next[:, None, None], Q, 0)
    h_full = torch.zeros((batch, max_cols, bs), dtype=h.dtype, device=h.device)
    h_full[:, :filled] = h
    return ArnoldiState(V=V, step=step + 1, alive=alive_next), h_full, beta


def arnoldi_continue(A, state: ArnoldiState, num_steps: int, bs: int,
                     lucky_tol: float = LUCKY_TOL):
    """Extend the recurrence by ``num_steps``; returns (blocks, state)."""
    hs, betas = [], []
    for _ in range(num_steps):
        state, h, beta = arnoldi_step(A, state, bs, lucky_tol)
        hs.append(h)
        betas.append(beta)
    if not num_steps:
        batch, _, max_cols = state.V.shape
        kw = dict(dtype=state.V.dtype, device=state.V.device)
        return ArnoldiBlocks(h=torch.zeros((0, batch, max_cols, bs), **kw),
                             beta=torch.zeros((0, batch, bs, bs), **kw)), state
    return ArnoldiBlocks(h=torch.stack(hs), beta=torch.stack(betas)), state


def arnoldi_run(A, B0: torch.Tensor, num_steps: int,
                max_steps: int | None = None, lucky_tol: float = LUCKY_TOL):
    """``num_steps`` block steps from B0 in a basis sized for ``max_steps``
    (default ``num_steps``); returns (blocks, R0, state)."""
    max_steps = num_steps if max_steps is None else max_steps
    state, R0 = arnoldi_start(A, B0, max_steps, lucky_tol)
    blocks, state = arnoldi_continue(A, state, num_steps, B0.shape[-1],
                                     lucky_tol)
    return blocks, R0, state


def assemble_hessenberg(blocks: ArnoldiBlocks, bs: int, m: int):
    """Square projection Gm = H[: m·bs, : m·bs] (batch, m·bs, m·bs): the
    coupling columns h (already full height: a transpose and a reshape) plus
    the subdiagonal beta blocks through one precomputed-index scatter."""
    h, beta = blocks.h, blocks.beta
    batch = h.shape[1]
    M = m * bs
    # h[:m, :, :M]: (m, batch, M, bs) → (batch, M, m, bs) → (batch, M, M)
    G = h[:m, :, :M, :].permute(1, 2, 0, 3).reshape(batch, M, M)
    if m > 1:
        j = np.arange(m - 1)[:, None, None]
        r = np.arange(bs)[None, :, None]
        c = np.arange(bs)[None, None, :]
        ridx = torch.as_tensor(np.broadcast_to((j + 1) * bs + r,
                                               (m - 1, bs, bs)).copy(),
                               device=h.device)
        cidx = torch.as_tensor(np.broadcast_to(j * bs + c,
                                               (m - 1, bs, bs)).copy(),
                               device=h.device)
        G[:, ridx, cidx] = beta[:m - 1].transpose(0, 1)
    return G
