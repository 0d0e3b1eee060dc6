"""Fused multi-step greedy: R budget steps per block — port of
``krylov_robustness_tpu/optimize/fused.py``.

Per step: score all candidates (block Lanczos + batched spectra over
uniform rounds with early exit) → in-window mask (first Q alive,
``greedy_krylov.m:64-93``) → arg-best → value-scatter commit → alive-mask
update. The reference's hot loop ``krylov_miobi.m:112-137`` is arg-best
then edit, and the frozen-structure operators make the edit a device value
scatter, so R steps run without a host round trip beyond one convergence
check per round. The JAX ``lax.while_loop``/``lax.scan`` become Python
loops.

A step whose in-window candidates did not all converge within the fused
budget — or that has no finite in-window score — reports ok=False; the host
loop truncates the block there and replays that step through the
accurate per-step lane.
"""

from __future__ import annotations

import dataclasses

import torch

from ..funm.dense import eigvalsh_or_nan, trace_fun_difference_eigs
from ..funm.scalar import get_fun
from ..krylov.lanczos import (
    LanczosBlocks,
    assemble_tridiag,
    lanczos_continue,
    lanczos_start,
)
from ..ops.banded_eig import eigvalsh_banded
from ..updates.trace_update import edge_B, edge_start_blocks

FUSED_ROUND_LEN = 6  # uniform round size (lag boundaries every 6 steps)
FUSED_ROUNDS = 5  # fused Krylov budget = 30 steps

# f32 eigenvalue-noise floor: the lag difference of two independently
# computed trace values cannot resolve below ~C·eps·gnorm·Σ|f(d−σ)| whichever
# solver computes the spectra (value calibrated by the JAX package; see
# krylov_robustness_tpu/optimize/fused.py). The f64 lane needs no floor.
F32_FLOOR_REL = 6.0


def coo_rebuild(op, vals):
    """Frozen-structure COO / row-sharded operator over replaced values (no
    copy)."""
    return dataclasses.replace(op, vals=vals)


def bsr_rebuild(op, flat_vals):
    """SuperBsrOperator over replacement tile storage (a view, no copy)."""
    return op.with_tiles(flat_vals.view(op.atiles.shape))


def sharded_bsr_rebuild(op, flat_vals):
    """BsrRowShardedMatrix over replacement storage (this rank's flattened
    tiles and their scratch element; a view, no copy)."""
    return op.with_storage(flat_vals)


def _spectra(stacked: torch.Tensor, bs: int) -> torch.Tensor:
    """Ascending eigenvalues of the stacked projections: Sturm bisection in
    f32 (as the JAX f32 lane), eigvalsh in f64. Measured on an H100, the
    f32 eigvalsh spectra are too noisy for the f32 acceptance floor: no fused
    step is accepted (PERF.md)."""
    if stacked.dtype == torch.float32:
        return eigvalsh_banded(stacked, w=2 * bs - 1)
    return eigvalsh_or_nan(stacked)


def _score_all(A, state0, Cm, tol, shift, *, rounds: int, round_len: int,
               lag: int, bs: int, fun_name: str):
    """Score every candidate over uniform rounds with early exit; the host
    lane's bookkeeping (lag test, dtype floor, best iterate, dead flag).
    Returns (delta, iters, converged). One host sync per round (the
    all-converged test)."""
    batch = Cm.shape[0]
    dtype, dev = Cm.dtype, Cm.device
    S = rounds * round_len
    k = Cm.shape[-1]
    Cs = (Cm + Cm.transpose(-1, -2)) / 2
    eps_m = torch.finfo(dtype).eps
    f32 = dtype == torch.float32
    step_iota = torch.arange(S, device=dev)
    zero_lucky = torch.zeros((batch,), dtype=torch.int32, device=dev)

    def G_at(Hbuf, Bbuf, m_used):
        # fixed-size assembly: blocks at steps ≥ m_used masked to zero, so the
        # projection is G_{m_used} ⊕ 0-pad (the last kept beta is excluded —
        # it would couple the real block into the pad)
        h_eff = torch.where((step_iota < m_used)[:, None, None, None], Hbuf, 0)
        b_eff = torch.where((step_iota < m_used - 1)[:, None, None, None],
                            Bbuf, 0)
        G = assemble_tridiag(
            LanczosBlocks(h=h_eff, beta=b_eff, lucky_step=zero_lucky),
            bs=bs, m=S)
        return (G + G.transpose(-1, -2)) / 2  # trace_fun_update.m:78-81

    state = state0
    Hbuf = torch.zeros((S, batch, 2 * bs, bs), dtype=dtype, device=dev)
    Bbuf = torch.zeros((S, batch, bs, bs), dtype=dtype, device=dev)
    delta = torch.zeros((batch,), dtype=dtype, device=dev)
    iters = torch.zeros((batch,), dtype=torch.int32, device=dev)
    conv = torch.zeros((batch,), dtype=torch.bool, device=dev)
    best_err = torch.full((batch,), float("inf"), dtype=dtype, device=dev)
    r_idx = 0
    while r_idx < rounds and not bool(conv.all()):
        blocks, state = lanczos_continue(A, state, round_len)
        Hbuf[r_idx * round_len:(r_idx + 1) * round_len] = blocks.h
        Bbuf[r_idx * round_len:(r_idx + 1) * round_len] = blocks.beta
        m_done = (r_idx + 1) * round_len
        G_now = G_at(Hbuf, Bbuf, m_done)
        G_lag = G_at(Hbuf, Bbuf, m_done - lag)
        tG_now = G_now.clone()
        tG_now[:, :k, :k] += Cs
        tG_lag = G_lag.clone()
        tG_lag[:, :k, :k] += Cs
        d = _spectra(torch.cat([tG_now, G_now, tG_lag, G_lag]), bs)
        d1n, d2n = d[:batch], d[batch:2 * batch]
        d1l, d2l = d[2 * batch:3 * batch], d[3 * batch:]
        x_now = trace_fun_difference_eigs(d1n, d2n, fun_name, shift=shift)
        x_lag = trace_fun_difference_eigs(d1l, d2l, fun_name, shift=shift)
        err = (x_now - x_lag).abs()
        dead = ~state.alive
        tol_eff = torch.clamp(32.0 * eps_m * x_now.abs(), min=tol)
        if f32:  # the eigenvalue-noise floor of the f32 spectra
            fscale = get_fun(fun_name)(d1n - shift).abs().sum(-1)
            gnorm = d1n.abs().max(-1).values
            tol_eff = torch.maximum(tol_eff,
                                    F32_FLOOR_REL * eps_m * gnorm * fscale)
        act = ~conv
        newly = act & ((err < tol_eff) | dead)
        upd = act & ((err <= best_err) | newly)
        delta = torch.where(upd, x_now, delta)
        iters = torch.where(upd, m_done, iters)
        best_err = torch.where(act, torch.minimum(best_err, err), best_err)
        conv = conv | newly
        r_idx += 1
    return delta, iters, conv


def fused_greedy_block(op, vals, edges, slots, alive, commit_value, tol,
                       shift, sign, rescale, *, rebuild, Q: int, R: int,
                       mode: str, fun_name: str, rounds: int = FUSED_ROUNDS,
                       round_len: int = FUSED_ROUND_LEN, lag: int = 2):
    """R budget steps over a fixed candidate table.

    edges (nC, 2) candidate table in the operator's node space; slots (nC, 2)
    flat positions of each edge's two value slots in ``vals`` (self-loops
    repeat one slot); alive (nC,) bool. A candidate is scoreable at a step
    iff it is alive and fewer than Q alive candidates precede it. Works on
    copies: ``vals`` and ``alive`` as passed are left as they were, so a
    partially accepted block can be rebuilt from them. Returns (vals, alive,
    per-step (winner, delta, iters, ok, nonfinite_count)) as device tensors.
    """
    dev = vals.device
    dtype = vals.dtype if vals.dtype in (torch.float32, torch.float64) \
        else torch.float32
    U0 = edge_start_blocks(op.n, edges, dtype, dev)
    B = edge_B(edges, sign, rescale, dtype, dev)
    state0, R0 = lanczos_start(None, U0)  # A unused by the start block QR
    Cm = torch.einsum("bkl,blm,bpm->bkp", R0, B, R0)
    bs = U0.shape[-1]
    slots = torch.as_tensor(slots, device=dev)
    vals = vals.clone()
    alive = torch.as_tensor(alive, device=dev).clone()
    commit = torch.tensor(commit_value, dtype=vals.dtype, device=dev)
    outs = []
    for _ in range(R):
        A = rebuild(op, vals)
        delta, iters, conv = _score_all(
            A, state0, Cm, tol, shift, rounds=rounds, round_len=round_len,
            lag=lag, bs=bs, fun_name=fun_name)
        in_win = alive & (torch.cumsum(alive.to(torch.int32), 0) <= Q)
        finite = torch.isfinite(delta)
        key = delta if mode == "break" else -delta
        key = torch.where(in_win & finite, key, float("inf"))
        h = torch.argmin(key)
        # a step with no finite in-window score has no winner: replay it
        ok = (~in_win | conv).all() & (in_win & finite).any()
        nonfin = (in_win & ~finite).sum()
        vals[slots[h]] = commit
        alive[h] = False
        outs.append((h, delta[h], iters[h], ok, nonfin))
    hs, dls, its, oks, nfs = (torch.stack(t) for t in zip(*outs))
    return vals, alive, (hs, dls, its, oks, nfs)
