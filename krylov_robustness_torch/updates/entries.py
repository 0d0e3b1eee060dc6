"""Selected entries of f(A) via per-row Krylov spaces — port of
``krylov_robustness_tpu/updates/entries.py`` (reference
``functions/function_multiple_entries.m``).

One Arnoldi space per *unique row index* of the requested (i, j) pairs,
seeded with e_i (``function_multiple_entries.m:84-110``), f applied to the
projected matrix, the entry read from the basis row. The reference's
per-entry active-set convergence (lag d = 3, ``:121-151``) becomes a round
loop over the whole batch, with one host check a round; rounds stop when
every entry's first-column lag difference is below tol. All unique seeds
advance together: one batched Arnoldi whose SpMM width is the number of
unique rows. :func:`entries_of_f_expmv` is the exp-family alternative
through batched ``expmv`` actions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..funm.dense import fun_sym
from ..funm.expmv import expmv, select_taylor_degree
from ..funm.scalar import get_fun
from ..krylov.arnoldi import (
    ArnoldiBlocks,
    arnoldi_continue,
    arnoldi_start,
    assemble_hessenberg,
)

DEFAULT_SCHEDULE = (6, 6, 8, 12, 20, 28, 20)


def seed_blocks(n: int, nodes: np.ndarray, dtype, device) -> torch.Tensor:
    """(u, n, 1) one-hot start blocks e_{nodes[k]}."""
    nodes = torch.as_tensor(np.asarray(nodes, np.int64), device=device)
    u = len(nodes)
    U = torch.zeros((u, n, 1), dtype=dtype, device=device)
    U[torch.arange(u, device=device), nodes, 0] = 1.0
    return U


def function_multiple_entries(
    A,
    omega: np.ndarray,
    fun="exp",
    tol: float = 1e-12,
    schedule: Sequence[int] = DEFAULT_SCHEDULE,
    lag: int = 3,
):
    """f(A)_{i,j} for each (i, j) in omega. Returns (values, iters).

    Entry formula (``function_multiple_entries.m:162-165``):
    X(h) = Um_{row(i)}[j, :m] · f(Gm)[:, 0] · (first-seed sign); with CholQR
    the first basis vector is exactly +e_i, so the sign is 1.
    """
    fun = get_fun(fun)
    omega = np.asarray(omega, dtype=np.int64)
    rows_u, row_of = np.unique(omega[:, 0], return_inverse=True)
    n = A.n
    U0 = seed_blocks(n, rows_u, A.dtype, A.device)
    sched = _trim(schedule, max(int(n // 2) - 1, 1))

    state, _ = arnoldi_start(A, U0, max_steps=sum(sched))
    h_all, beta_all = [], []
    m_done = 0
    for round_steps in sched:
        blocks, state = arnoldi_continue(A, state, round_steps, 1)
        h_all.append(blocks.h)
        beta_all.append(blocks.beta)
        m_done += round_steps
        ab = ArnoldiBlocks(h=torch.cat(h_all), beta=torch.cat(beta_all))
        col_now = _first_column(ab, m_done, fun.name)  # (u, m)
        col_lag = _first_column(ab, m_done - lag, fun.name)
        pad = torch.zeros_like(col_now)
        pad[:, :col_lag.shape[1]] = col_lag
        err = torch.linalg.vector_norm(col_now - pad, dim=1)
        if bool(((err < tol) | ~state.alive).all()):  # one host sync a round
            break

    # value = V_basis[row(i)][j, :m] @ f(Gm)[:, 0]
    dev = A.device
    r = torch.as_tensor(row_of.reshape(-1), device=dev)
    j = torch.as_tensor(omega[:, 1], device=dev)
    vals = (state.V[r, j, :m_done] * col_now[r]).sum(-1)
    return vals, m_done


def entries_of_f_expmv(A, omega: np.ndarray, fun="exp", m_probe_cols=None):
    """f(A)_{i,j} for the exp family via batched ``expmv`` actions.

    f(A)·E for one-hot columns E over the unique column indices is one
    Taylor recurrence (two for sinh/cosh via (exp(A) ∓ exp(−A))/2). Exact up
    to the expmv truncation tolerance. Returns (values, 0), matching the
    ``function_multiple_entries`` tuple.
    """
    fun = get_fun(fun)
    if fun.name not in ("exp", "sinh", "cosh"):
        raise ValueError("entries_of_f_expmv supports exp/sinh/cosh only")
    omega = np.asarray(omega, dtype=np.int64)
    cols_u, col_of = np.unique(omega[:, 1], return_inverse=True)
    n, dev = A.n, A.device
    E = torch.zeros((n, len(cols_u)), dtype=A.dtype, device=dev)
    E[torch.as_tensor(cols_u, device=dev),
      torch.arange(len(cols_u), device=dev)] = 1.0
    plan = select_taylor_degree(A, t=1.0, b_cols=len(cols_u))
    Yp = expmv(A, E, t=1.0, plan=plan)
    if fun.name == "exp":
        Y = Yp
    else:
        plan_m = select_taylor_degree(A, t=-1.0, b_cols=len(cols_u))
        Ym = expmv(A, E, t=-1.0, plan=plan_m)
        Y = (Yp - Ym) / 2 if fun.name == "sinh" else (Yp + Ym) / 2
    vals = Y[torch.as_tensor(omega[:, 0], device=dev),
             torch.as_tensor(col_of.reshape(-1), device=dev)]
    return vals, 0


def _trim(schedule, cap):
    """The leading rounds of ``schedule`` whose sum stays within ``cap``
    (``[cap]`` if not even the first fits)."""
    out, tot = [], 0
    for s in schedule:
        if tot + s > cap:
            break
        out.append(s)
        tot += s
    return out or [cap]


def _first_column(blocks, m: int, fun_name: str):
    G = assemble_hessenberg(blocks, 1, m)
    G = (G + G.transpose(-1, -2)) / 2
    return fun_sym(G, fun_name)[:, :, 0]
