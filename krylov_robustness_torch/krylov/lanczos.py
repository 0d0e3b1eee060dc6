"""Batched block Lanczos with O(1) basis memory — port of
``krylov_robustness_tpu/krylov/lanczos.py`` (reference
``functions/lanczos_krylov.m``).

A leading batch axis runs many independent Krylov spaces over the same
operator; their A-products fuse into one SpMM of width ``batch·bs``. The
three-term recurrence keeps the last two block columns and orthogonalizes
against them with a twice-applied block MGS (``lanczos_krylov.m:109-115``);
block QR is Cholesky-QR with per-column deflation. Lucky breakdown
(``lanczos_krylov.m:91-93``) becomes a per-member mask: dead members emit
zero blocks, which add decoupled zero eigenvalues that cancel downstream.
All of a step but its SpMM is ``ops/block_mgs.py``: a hand-written kernel
chain for CUDA blocks, the torch einsum step for CPU ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.block_mgs import block_mgs
from ..ops.block_mgs import chol_qr as _chol_qr
from ..utils import tracing

LUCKY_TOL = 1e-8  # reference lanczos_krylov.m:74


class LanczosState(NamedTuple):
    """Resumable carry. Basis blocks are n-major — (n, batch, bs) — so the
    fused SpMM is a reshape to (n, batch·bs) with no transpose."""

    v_prev: torch.Tensor  # (n, batch, bs)
    v_cur: torch.Tensor  # (n, batch, bs)
    alive: torch.Tensor  # (batch,) bool — False after lucky breakdown


class LanczosBlocks(NamedTuple):
    """Per-step coefficients: ``h[j]`` (2bs, bs) is the MGS column (rows
    0:bs couple to V_{j-1}, rows bs:2bs are alpha_j); ``beta[j]`` the QR
    subdiagonal block."""

    h: torch.Tensor  # (steps, batch, 2*bs, bs)
    beta: torch.Tensor  # (steps, batch, bs, bs)
    lucky_step: torch.Tensor  # (batch,) int32: first breakdown step or steps


def _spmm_nb(A, x: torch.Tensor) -> torch.Tensor:
    """A @ x for n-major x (n, batch, bs)."""
    n, b, bs = x.shape
    return (A @ x.reshape(n, b * bs)).reshape(n, b, bs)


def lanczos_start(A, B0: torch.Tensor, lucky_tol: float = LUCKY_TOL):
    """Orthonormalize the start block (``lanczos_krylov.m:49``). B0 is
    (batch, n, bs), transposed once into the n-major layout. Returns
    (state, R0) with B0 = V1·R0. The blocks of the state are contiguous,
    as the step's kernel takes them."""
    Q, R, ok = _chol_qr(B0.permute(1, 0, 2).contiguous(), lucky_tol)
    Q = Q.contiguous()
    return LanczosState(v_prev=torch.zeros_like(Q), v_cur=Q, alive=ok), R


def lanczos_step(A, state: LanczosState, lucky_tol: float = LUCKY_TOL):
    """One block step: SpMM + double MGS against the 2-block window + CholQR
    (``add_inf_pole``, ``lanczos_krylov.m:73-101``); all but the SpMM in
    ``ops/block_mgs.py``."""
    vp, vc, alive = state
    with tracing.span("krylov", vc):
        w = _spmm_nb(A, vc)
        Q, h, beta, alive_next = block_mgs(vp, vc, w, alive, lucky_tol)
    return LanczosState(v_prev=vc, v_cur=Q, alive=alive_next), h, beta


def lanczos_run(A, B0: torch.Tensor, num_steps: int,
                lucky_tol: float = LUCKY_TOL):
    """``num_steps`` block steps from B0; returns (blocks, R0, state)."""
    state, R0 = lanczos_start(A, B0, lucky_tol)
    blocks, state = lanczos_continue(A, state, num_steps, lucky_tol)
    return blocks, R0, state


def lanczos_continue(A, state: LanczosState, num_steps: int,
                     lucky_tol: float = LUCKY_TOL):
    """Extend a recurrence by ``num_steps`` (the incremental API of
    ``lanczos_krylov.m:60-67`` as "resume from carry")."""
    hs, betas, died = [], [], []
    for _ in range(num_steps):
        alive_before = state.alive
        state, h, beta = lanczos_step(A, state, lucky_tol)
        hs.append(h)
        betas.append(beta)
        died.append(alive_before & ~state.alive)
    batch = state.alive.shape[0]
    tracing.count("krylov.steps_run", batch * num_steps)
    if num_steps:
        died = torch.stack(died)
        lucky_step = torch.where(
            died.any(dim=0), died.to(torch.int32).argmax(dim=0).to(
                torch.int32),
            torch.full((batch,), num_steps, dtype=torch.int32,
                       device=died.device))
        h, beta = torch.stack(hs), torch.stack(betas)
    else:
        bs = state.v_cur.shape[-1]
        dev, dt = state.v_cur.device, state.v_cur.dtype
        h = torch.zeros((0, batch, 2 * bs, bs), dtype=dt, device=dev)
        beta = torch.zeros((0, batch, bs, bs), dtype=dt, device=dev)
        lucky_step = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return LanczosBlocks(h=h, beta=beta, lucky_step=lucky_step), state


def assemble_tridiag(blocks: LanczosBlocks, bs: int, m: int | None = None):
    """Dense square projection Gm (batch, m·bs, m·bs) from per-step blocks
    (``Gm = HA(1:end-rk, :)``, ``trace_fun_update.m:71``): alpha blocks on
    the diagonal, MGS coupling blocks above, QR beta blocks below, written
    with one scatter."""
    h, beta = blocks.h, blocks.beta
    batch = h.shape[1]
    m = h.shape[0] if m is None else m
    M = m * bs
    # column block j receives rows (j−1)bs..(j+2)bs: [coupling; alpha; beta]
    contrib = torch.cat([h[:m], beta[:m]], dim=2)  # (m, batch, 3bs, bs)
    j = np.arange(m)[:, None, None]
    r = np.arange(3 * bs)[None, :, None]
    c = np.arange(bs)[None, None, :]
    ridx = np.broadcast_to((j - 1) * bs + r + bs, (m, 3 * bs, bs)).copy()
    cidx = np.broadcast_to(j * bs + c, (m, 3 * bs, bs)).copy()
    # +bs row shift into a padded buffer: the j=0 coupling and j=m−1 beta
    # rows land in the pad bands and are sliced away
    Gp = torch.zeros((batch, M + 2 * bs, M), dtype=h.dtype, device=h.device)
    Gp[:, torch.as_tensor(ridx, device=h.device),
       torch.as_tensor(cidx, device=h.device)] = contrib.permute(1, 0, 2, 3)
    return Gp[:, bs:bs + M, :]
