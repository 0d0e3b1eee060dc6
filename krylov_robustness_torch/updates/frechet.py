"""Batched Fréchet derivatives Df(A)(e_i·e_jᵀ) ≈ U_i · X_h · U_jᵀ — port of
``krylov_robustness_tpu/updates/frechet.py`` (reference
``functions/multiple_frechet_eval.m``).

Row spaces from Arnoldi seeded e_i, column spaces from Arnoldi on Aᵀ seeded
e_j (``multiple_frechet_eval.m:99-147``), a core factor per pair from the
block-triangular trick f([Gm Cm; 0 Hmᵀ]) (``:150-159``). As in the JAX
package: every operator here is symmetric, so row and column spaces coincide
and ONE batched Arnoldi over the unique touched nodes serves every pair; the
dense expm of the stacked 2m×2m matrix becomes the Daleckii–Krein divided
differences over the two small eighs (:func:`..funm.dense.frechet_offdiag_sym`),
batched over pairs; with CholQR the first basis vector is exactly +e_i, so
the reference's start-vector sign bookkeeping (``:95-96``) is 1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..funm.dense import eigh_or_nan, frechet_offdiag_sym
from ..funm.scalar import get_fun
from ..krylov.arnoldi import (
    ArnoldiBlocks,
    arnoldi_continue,
    arnoldi_start,
    assemble_hessenberg,
)
from .entries import DEFAULT_SCHEDULE, _trim, seed_blocks


@dataclasses.dataclass
class FrechetBatch:
    """Low-rank Fréchet factorizations sharing a node-indexed basis pool."""

    bases: torch.Tensor  # (u, n, m) Arnoldi bases, one per unique node
    X: torch.Tensor  # (npairs, m, m) core factors
    node_index: dict  # node id -> basis slot
    omega: np.ndarray  # (npairs, 2)
    iters: int

    def hessian(self, at_edges: np.ndarray, exact: bool = True) -> torch.Tensor:
        """Hessian contributions from the Fréchet factorizations.

        ``exact=False`` reproduces the reference's assembly
        (``functions/hessianfcn_exp.m:9-15``):
        Hes[h, l] = [U_{i_h} X_h U_{j_h}ᵀ]_{(i_l, j_l)}.

        ``exact=True`` (default) adds the transpose-probe term the reference
        omits: the symmetric perturbation direction is E_l + E_lᵀ, so the
        true mixed partial of trace f(A+Δ(x)) needs
        [Df'(E_h)]_{(i_l, j_l)} + [Df'(E_h)]_{(j_l, i_l)}.
        """
        at_edges = np.asarray(at_edges, dtype=np.int64)
        dev = self.X.device
        rs, cs = _slots(self.node_index, self.omega, dev)
        li = torch.as_tensor(at_edges[:, 0], device=dev)
        lj = torch.as_tensor(at_edges[:, 1], device=dev)

        def rows(slots, nodes):
            # rows ``nodes`` of each pair's basis: (npairs, probes, m)
            return self.bases[slots[:, None], nodes[None, :], :]

        H = torch.einsum("hlm,hmp,hlp->hl", rows(rs, li), self.X,
                         rows(cs, lj))
        if exact:
            H = H + torch.einsum("hlm,hmp,hlp->hl", rows(rs, lj), self.X,
                                 rows(cs, li))
        return H


def _slots(node_index: dict, omega: np.ndarray, device):
    """Basis slots of each pair's row and column node."""
    return tuple(torch.as_tensor([node_index[int(v)] for v in omega[:, k]],
                                 dtype=torch.int64, device=device)
                 for k in (0, 1))


def multiple_frechet_eval(
    A,
    omega: np.ndarray,
    fun="exp",
    tol: float = 1e-12,
    schedule: Sequence[int] = DEFAULT_SCHEDULE,
    lag: int = 3,
) -> FrechetBatch:
    fun = get_fun(fun)
    omega = np.asarray(omega, dtype=np.int64)
    nodes = np.unique(omega.ravel())
    node_index = {int(v): i for i, v in enumerate(nodes)}
    n = A.n
    U0 = seed_blocks(n, nodes, A.dtype, A.device)
    sched = _trim(schedule, max(int(n // 2) - 1, 1))

    state, _ = arnoldi_start(A, U0, max_steps=sum(sched))
    h_all, beta_all = [], []
    m_done = 0
    row_slots, col_slots = _slots(node_index, omega, A.device)
    X_now = None
    for round_steps in sched:
        blocks, state = arnoldi_continue(A, state, round_steps, 1)
        h_all.append(blocks.h)
        beta_all.append(blocks.beta)
        m_done += round_steps
        ab = ArnoldiBlocks(h=torch.cat(h_all), beta=torch.cat(beta_all))
        X_now = _pair_cores(ab, row_slots, col_slots, m_done, fun.name)
        X_lag = _pair_cores(ab, row_slots, col_slots, m_done - lag, fun.name)
        pad = torch.zeros_like(X_now)
        pad[:, :X_lag.shape[1], :X_lag.shape[2]] = X_lag
        err = torch.linalg.matrix_norm(X_now - pad)
        # one host sync a round
        if bool((err < tol).all()) or not bool(state.alive.any()):
            break

    return FrechetBatch(bases=state.V[:, :, :m_done], X=X_now,
                        node_index=node_index, omega=omega, iters=m_done)


def _pair_cores(blocks, row_slots, col_slots, m: int, fun_name: str):
    """Core factors for all pairs: top-right block of f([[G_i, C],[0, G_j]])
    with C = e₁e₁ᵀ, via divided differences on the batched eighs."""
    G = assemble_hessenberg(blocks, 1, m)  # (u, m, m)
    w, V = eigh_or_nan((G + G.transpose(-1, -2)) / 2)
    C = torch.zeros((row_slots.shape[0], m, m), dtype=G.dtype, device=G.device)
    C[:, 0, 0] = 1.0  # C = e1 e1ᵀ in the Krylov coordinates of each pair
    return frechet_offdiag_sym(w[row_slots], V[row_slots], w[col_slots],
                               V[col_slots], C, fun_name)
