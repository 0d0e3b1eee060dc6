"""Batched trace(f(A + U·B·Uᵀ) − f(A)) via block Lanczos — port of
``krylov_robustness_tpu/updates/trace_update.py``.

The reference calls ``trace_fun_update`` once per candidate edge per greedy
step (``krylov_miobi.m:99``). Here every candidate's block recurrence
advances together (one SpMM of width candidates·2 per step), the device
runs the recurrence, and at the round boundaries of a checkpoint schedule
the projected spectra are computed — on the card by one kernel launch a
round (``ops/banded_sturm.py``) for CUDA blocks of at most four columns,
else on the host by LAPACK's banded eigensolver, threaded — and the host
applies the lag-2 stopping rule (``trace_fun_update.m:57-59,103-118``).
Small graphs (n ≤ 130) take the exact dense path
(``trace_fun_update.m:37-51``) where the operator has ``todense``, and
otherwise the phase lane (``host_eigh=False``): rounds grouped into phases,
dense spectra and the lag test on the device, one host check per phase.

Zero padding is exact: dead/converged members emit zero blocks, which add
identical decoupled zero eigenvalues to both projections; their f
contributions cancel in the difference.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from ..funm.dense import (
    eigvalsh_or_nan,
    trace_fun_difference_eigs,
    trace_fun_update_dense,
)
from ..funm.scalar import get_fun
from ..krylov.lanczos import (
    LanczosBlocks,
    LanczosState,
    assemble_tridiag,
    lanczos_continue,
    lanczos_start,
)
from ..ops import banded_sturm
from ..utils import tracing

DEFAULT_SCHEDULE = (6, 6, 8, 12, 20, 28, 20)  # cumulative 100 = reference max it
DENSE_N_CUTOFF = 130  # reference trace_fun_update.m:37
# rounds per phase of the phase lane (the first phase covers the common
# convergence range; later phases run only for stragglers)
DEFAULT_PHASES = (3, 2, 2)

# Ceiling for one scoring call, in candidate·row cells (the Lanczos carry and
# SpMM buffers are O(batch·n)). Kept at the JAX package's value so lane and
# chunking decisions match it; re-sizing for the H100's 80 GB is ROADMAP work.
MAX_SCORE_CELLS = 32_000_000


def edge_start_blocks(n: int, edges, dtype, device) -> torch.Tensor:
    """U = [e_i, e_j] per candidate edge: (batch, n, 2) one-hot blocks
    (``krylov_miobi.m:91-94``)."""
    e = torch.as_tensor(np.asarray(edges, np.int64), device=device)
    batch = e.shape[0]
    U = torch.zeros((batch, n, 2), dtype=dtype, device=device)
    b_idx = torch.arange(batch, device=device)
    U[b_idx, e[:, 0], 0] = 1.0
    U[b_idx, e[:, 1], 1] = 1.0
    return U


def edge_B(edges, sign: float, rescale: float, dtype, device) -> torch.Tensor:
    """Rank-2 core factor ∓[[0,1],[1,0]]/rescale, rank-1 for self-loop rows
    (``krylov_miobi.m:76-98``)."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    off = sign / rescale
    B = np.tile(np.array([[0.0, 1.0], [1.0, 0.0]]) * off, (len(e), 1, 1))
    B[e[:, 0] == e[:, 1]] = np.array([[1.0, 0.0], [0.0, 0.0]]) * off
    return torch.as_tensor(B, device=device).to(dtype)


@dataclasses.dataclass
class TraceUpdateResult:
    delta: torch.Tensor  # (batch,) trace differences
    iters: torch.Tensor  # (batch,) steps used at acceptance
    converged: torch.Tensor  # (batch,) bool


def _spectra_on_card(h: torch.Tensor) -> bool:
    """The spectra layer's path rule, on the recurrence's observed device
    and width: CUDA blocks of at most ``banded_sturm.MAX_BS`` columns (every
    greedy scoring call's bs = 2, batch up to a few hundred) take the card's
    spectra kernel; CPU blocks, and CUDA blocks wider than that (a joint
    edit's rescoring, the weighted objective: one large band a call, where
    LAPACK's cost a call is small beside the band's and the kernel's chains
    grow with the bandwidth), take host LAPACK."""
    return h.device.type == "cuda" and h.shape[-1] <= banded_sturm.MAX_BS


def _eigvals_lapack(band: np.ndarray, pool) -> np.ndarray:
    """Eigenvalues of a batch of symmetric matrices in lower-banded storage
    (batch, nband, M) via LAPACK dsbev, threaded across the batch (scipy
    releases the GIL inside the Fortran call)."""
    import scipy.linalg

    batch, _, M = band.shape
    out = np.empty((batch, M), band.dtype)

    def one(c):
        out[c] = scipy.linalg.eigvals_banded(band[c], lower=True,
                                             check_finite=False)

    with tracing.span("spectra.eig", batch, M):
        for fut in [pool.submit(one, c) for c in range(batch)]:
            fut.result()
    return out


def _eigvals_banded_batch(h: torch.Tensor, beta: torch.Tensor,
                          Cm: torch.Tensor, act: np.ndarray, m: int,
                          m_lag: int, pool):
    """The spectra layer's one entry: the ascending eigenvalues of a round's
    four projections of the candidates ``act`` after m steps — tG and G at
    m_lag·bs columns and at m·bs — as f64 arrays (tG_lag, G_lag, tG, G).
    Where :func:`_spectra_on_card` holds, ``h``/``beta`` are the recurrence
    as it lies on the card and ``Cm`` is there too: one kernel launch and
    the wait for its results. Otherwise they are f64 on the host: the bands
    (``_band_from_blocks``) and four threaded LAPACK calls on ``pool``."""
    bs = h.shape[-1]
    M, ML = m * bs, m_lag * bs
    if _spectra_on_card(h):
        with tracing.span("spectra.kernel", len(act), M):
            act_d = torch.as_tensor(act.astype(np.int32), device=h.device)
            eig = banded_sturm.spectra(h, beta, Cm, act_d, m, m_lag)
            eig = eig.cpu().numpy()
        return (np.sort(eig[:, 2 * M:2 * M + ML], axis=1),
                np.sort(eig[:, 2 * M + ML:], axis=1),
                np.sort(eig[:, :M], axis=1), np.sort(eig[:, M:2 * M], axis=1))
    tracing.count("spectra.members_host", 4 * len(act))
    with tracing.span("spectra.band", len(act), M):
        band_t, band_g = _band_from_blocks(h[:m].numpy()[:, act],
                                           beta[:m].numpy()[:, act],
                                           Cm.numpy()[act], m, bs)
    return (_eigvals_lapack(band_t[:, :, :ML], pool),
            _eigvals_lapack(band_g[:, :, :ML], pool),
            _eigvals_lapack(band_t, pool), _eigvals_lapack(band_g, pool))


_NP_FUNS = {"exp": np.exp, "sinh": np.sinh, "cosh": np.cosh,
            "identity": lambda x: x}


def _trace_fun_difference_np(d1, d2, fun_name: str, shift: float = 0.0):
    """numpy twin of :func:`..funm.dense.trace_fun_difference_eigs` for the
    host spectra."""
    if fun_name == "exp":
        return np.sum(np.exp(d1 - shift) * -np.expm1(d2 - d1), axis=-1)
    f = _NP_FUNS[fun_name]
    return np.sum(f(d1 - shift) - f(d2 - shift), axis=-1)


def _band_from_blocks(h_np, beta_np, Cm_np, m: int, bs: int):
    """Lower-banded storage (batch, max(2bs, k), m·bs) of the symmetrized
    projections, built straight from the recurrence blocks: diagonal blocks
    alpha_j = h[j][bs:2bs], couplings (beta_j + h[j+1][0:bs]ᵀ)/2 below.
    Returns (band_tG, band_G); tG adds the symmetrized Cm = R0·B·R0ᵀ in the
    top-left (``trace_fun_update.m:71-81``). Truncations to fewer steps are
    column slices of the same arrays."""
    batch = h_np.shape[1]
    M = m * bs
    alpha = h_np[:m, :, bs:2 * bs, :]  # (m, batch, bs, bs)
    Dsym = (alpha + alpha.transpose(0, 1, 3, 2)) / 2
    k = Cm_np.shape[-1]
    nb = min(max(2 * bs, k), M)
    band = np.zeros((batch, nb, M), h_np.dtype)
    rl, c = np.tril_indices(bs)
    d_idx = np.broadcast_to(rl - c, (m, len(rl))).ravel()
    col_idx = (np.arange(m)[:, None] * bs + c).ravel()
    band[:, d_idx, col_idx] = np.moveaxis(Dsym[:, :, rl, c], 1, 0).reshape(
        batch, -1)
    if m > 1:
        coup_next = h_np[1:m, :, 0:bs, :]  # h[j+1][0:bs]
        Lsym = (beta_np[:m - 1] + coup_next.transpose(0, 1, 3, 2)) / 2
        rr, cc = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
        rr, cc = rr.ravel(), cc.ravel()
        d2_idx = np.broadcast_to(bs + rr - cc, (m - 1, bs * bs)).ravel()
        col2 = (np.arange(m - 1)[:, None] * bs + cc).ravel()
        band[:, d2_idx, col2] = np.moveaxis(
            Lsym[:, :, rr, cc], 1, 0).reshape(batch, -1)
    band_t = band.copy()
    rl2, c2 = np.tril_indices(k)
    Cs = (Cm_np + Cm_np.transpose(0, 2, 1)) / 2
    band_t[:, rl2 - c2, c2] += Cs[:, rl2, c2]
    return band_t, band


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float64).cpu().numpy()


def _for_spectra(t: torch.Tensor, on_card: bool) -> torch.Tensor:
    """A recurrence block where the spectra read it: as it lies on the
    card, or in f64 on the host."""
    return t if on_card else t.detach().to(torch.float64).cpu()


def _delta_trace_at(h, beta, Cm, m_total: int, bs: int, fun_name: str,
                    shift=0.0) -> torch.Tensor:
    """Δtrace from the first ``m_total`` recurrence steps, with dense
    spectra of the symmetrized projections (``trace_fun_update.m:71-81``)."""
    blocks = LanczosBlocks(h=h[:m_total], beta=beta[:m_total],
                           lucky_step=torch.zeros(h.shape[1],
                                                  dtype=torch.int32))
    G = assemble_tridiag(blocks, bs=bs, m=m_total)
    G = (G + G.transpose(-1, -2)) / 2
    k = Cm.shape[-1]
    tG = G.clone()
    tG[:, :k, :k] += (Cm + Cm.transpose(-1, -2)) / 2
    return trace_fun_difference_eigs(eigvalsh_or_nan(tG), eigvalsh_or_nan(G),
                                     fun_name, shift=shift)


def _phase(A, state, h_prev, beta_prev, Cm, tol, shift, delta, iters,
           converged, best_err, rounds, m_prev: int, bs: int, fun_name: str,
           lag: int):
    """One phase: extend the recurrence by each round's steps and, at every
    round boundary, run the lag test on the device and freeze the newly
    converged candidates. Keeps the minimum-lag-error iterate of each
    candidate (the f32 Lanczos-ghost drift makes later iterates worse)."""
    h_all = [h_prev] if m_prev else []
    beta_all = [beta_prev] if m_prev else []
    m_done = m_prev
    for steps in rounds:
        blocks, state = lanczos_continue(A, state, steps)
        h_all.append(blocks.h)
        beta_all.append(blocks.beta)
        m_done += steps
        H, Bt = torch.cat(h_all), torch.cat(beta_all)
        x_lag = _delta_trace_at(H, Bt, Cm, m_done - lag, bs, fun_name, shift)
        x_now = _delta_trace_at(H, Bt, Cm, m_done, bs, fun_name, shift)
        err = (x_now - x_lag).abs()
        newly = ~converged & ((err < tol) | ~state.alive)
        improved = ~converged & ((err <= best_err) | newly)
        delta = torch.where(improved, x_now, delta)
        iters = torch.where(improved, m_done, iters)
        best_err = torch.where(improved, err, best_err)
        converged = converged | newly
    return (state, torch.cat(h_all), torch.cat(beta_all), delta, iters,
            converged, best_err)


def _trace_update_phases(A, U0, B, fun, tol, schedule, lag, phases,
                         shift: float = 0.0) -> TraceUpdateResult:
    """The phase lane: the schedule's rounds grouped into phases, spectra
    and the lag test on the device; the host only checks between phases
    whether stragglers remain."""
    batch, _, bs = U0.shape
    dtype, dev = U0.dtype, U0.device
    state, R0 = lanczos_start(A, U0)
    Cm = torch.einsum("bkl,blm,bpm->bkp", R0, B, R0)
    phase_rounds = []
    idx = 0
    for p in phases:
        if schedule[idx:idx + p]:
            phase_rounds.append(tuple(schedule[idx:idx + p]))
        idx += p
    if schedule[idx:]:
        phase_rounds.append(tuple(schedule[idx:]))
    delta = torch.zeros((batch,), dtype=dtype, device=dev)
    iters = torch.zeros((batch,), dtype=torch.int32, device=dev)
    converged = torch.zeros((batch,), dtype=torch.bool, device=dev)
    best_err = torch.full((batch,), float("inf"), dtype=dtype, device=dev)
    h = torch.zeros((0, batch, 2 * bs, bs), dtype=dtype, device=dev)
    beta = torch.zeros((0, batch, bs, bs), dtype=dtype, device=dev)
    m_prev = 0
    for rounds in phase_rounds:
        state, h, beta, delta, iters, converged, best_err = _phase(
            A, state, h, beta, Cm, tol, shift, delta, iters, converged,
            best_err, rounds, m_prev, bs, fun.name, lag)
        m_prev += sum(rounds)
        if bool(converged.all()):
            break
    return TraceUpdateResult(delta=delta, iters=iters, converged=converged)


def _batch_multiple(A) -> int:
    """The multiple of which an operator takes its batch: the size of the
    'cands' mesh axis its product shards columns over
    (parallel/spmm_sharded.py), else 1."""
    ba = getattr(A, "batch_axis", None)
    return int(A.mesh.shape[ba]) if ba else 1


def _trace_update_host_eigh(A, U0, B, fun, tol, schedule, lag,
                            shift: float = 0.0):
    """Device recurrence round by round for the candidates still running,
    round-boundary spectra, host bookkeeping. Every candidate runs the
    first round; at each round boundary the spectra of the stragglers come
    from :func:`_eigvals_banded_batch` (on the card where
    :func:`_spectra_on_card` holds, else on the host), the host runs the
    lag-d bookkeeping, and the carry is cut down to the candidates not yet
    accepted (padded with repeats of one of them to the operator's
    :func:`_batch_multiple`): the next round's steps run for those only.
    The blocks land in one buffer indexed by the original candidate, so
    each round's spectra read what a full-width recurrence would give (a
    member's steps do not depend on the others')."""
    batch, _, bs = U0.shape
    dtype = U0.dtype
    total = int(sum(schedule))

    state, R0 = lanczos_start(A, U0)
    alive0_d = state.alive
    on_card = _spectra_on_card(U0)  # the recurrence's device and width
    h = torch.zeros((total, batch, 2 * bs, bs),
                    dtype=dtype if on_card else torch.float64,
                    device=U0.device if on_card else "cpu")
    beta = h.new_zeros((total, batch, bs, bs))
    Cm = None

    delta = np.zeros((batch,), np.float64)
    iters = np.zeros((batch,), np.int32)
    converged = np.zeros((batch,), bool)
    used = np.zeros((batch,), np.int64)  # steps to acceptance or the end
    # In f32 the lag error reaches a floor and then drifts back up (Lanczos
    # ghosts once a Ritz pair converges): keep the minimum-lag-error iterate
    # per candidate and return it when the tolerance is never met.
    best_err = np.full((batch,), np.inf)
    eps_m = torch.finfo(dtype).eps
    mult = _batch_multiple(A)
    members = np.arange(batch)  # the candidate of each carry column
    k = batch  # carry columns that are not padding
    cols = torch.arange(batch, device=h.device)  # members[:k], on h.device
    m_done = 0
    # the pool starts its threads at the first LAPACK call, so the card's
    # path starts none
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 2)) as pool:
        for steps in schedule:
            act = np.nonzero(~converged)[0]  # only the stragglers run on
            if len(act) == 0:
                break
            if len(act) < k:
                pos = np.searchsorted(members[:k], act)
                pos = np.concatenate([pos, np.repeat(pos[:1],
                                                     -len(act) % mult)])
                idx = torch.as_tensor(pos, device=state.alive.device)
                state = LanczosState(
                    v_prev=state.v_prev.index_select(1, idx),
                    v_cur=state.v_cur.index_select(1, idx),
                    alive=state.alive[idx])
                tracing.count("scorer.members_dropped", k - len(act))
                members, k = members[pos], len(act)
                cols = torch.as_tensor(act, device=h.device)
            blocks, state = lanczos_continue(A, state, int(steps))
            # read after the spectra's wait, which it rides
            lucky_seg = blocks.lucky_step[:k].to("cpu", non_blocking=True)
            m0, m_done = m_done, m_done + int(steps)
            hb = _for_spectra(blocks.h[:, :k], on_card)
            bb = _for_spectra(blocks.beta[:, :k], on_card)
            h[m0:m_done].index_copy_(1, cols, hb)
            beta[m0:m_done].index_copy_(1, cols, bb)
            if Cm is None:  # once the first round is queued
                R0_np = _to_host(R0)
                Cm = torch.from_numpy(np.einsum(
                    "bkl,blm,bpm->bkp", R0_np, _to_host(B),
                    R0_np)).to(h.device)
                alive0 = alive0_d.cpu().numpy()
            t_lag, g_lag, t_now, g_now = _eigvals_banded_batch(
                h, beta, Cm, act, m_done, m_done - lag, pool)
            x_lag = _trace_fun_difference_np(t_lag, g_lag, fun.name,
                                             shift=shift)
            x_now = _trace_fun_difference_np(t_now, g_now, fun.name,
                                             shift=shift)
            err = np.abs(x_now - x_lag)
            # a member in the carry had not broken down before this round
            dead = ~alive0[act] | (lucky_seg.numpy() < steps)
            # dtype-aware floor: an f32 recurrence cannot resolve below
            # ~32 eps relative
            tol_eff = np.maximum(tol, 32.0 * eps_m * np.abs(x_now))
            newly = (err < tol_eff) | dead
            improved = err <= best_err[act]
            upd = act[improved | newly]
            delta[upd] = x_now[improved | newly]
            iters[upd] = m_done
            best_err[act] = np.minimum(best_err[act], err)
            converged[act] = newly
            used[act] = m_done  # accepted here, or still running
    tracing.count("krylov.steps_used", int(used.sum()))
    return TraceUpdateResult(
        delta=torch.from_numpy(delta).to(dtype),
        iters=torch.from_numpy(iters),
        converged=torch.from_numpy(converged),
    )


def trace_fun_update_batched(
    A,
    U0: torch.Tensor,
    B: torch.Tensor,
    fun="exp",
    tol: float = 1e-12,
    schedule: Sequence[int] = DEFAULT_SCHEDULE,
    lag: int = 2,
    phases: Sequence[int] = DEFAULT_PHASES,
    host_eigh: bool | None = None,
    shift: float = 0.0,
) -> TraceUpdateResult:
    """Batched trace(f(A + U B Uᵀ) − f(A)); U0 (batch, n, bs), B (batch, bs,
    bs). Parameters mirror ``functions/trace_fun_update.m``; ``schedule`` is
    the round structure (its sum is the reference's ``it`` cap)."""
    fun = get_fun(fun)
    batch, n, bs = U0.shape
    dtype = U0.dtype
    if host_eigh is None:
        host_eigh = n > DENSE_N_CUTOFF

    # exact dense path for small n (trace_fun_update.m:37)
    if n <= DENSE_N_CUTOFF and hasattr(A, "todense"):
        Ad = A.todense()[:n, :n].to(dtype)
        Ad = (Ad + Ad.T) / 2
        d2 = eigvalsh_or_nan(Ad)
        At = Ad[None] + torch.einsum("bnk,bkl,bml->bnm", U0, B, U0)
        At = (At + At.transpose(-1, -2)) / 2
        d1 = eigvalsh_or_nan(At)
        return TraceUpdateResult(
            delta=trace_fun_difference_eigs(d1, d2[None], fun.name,
                                            shift=shift),
            iters=torch.zeros((batch,), dtype=torch.int32),
            converged=torch.ones((batch,), dtype=torch.bool),
        )
    if not host_eigh:
        return _trace_update_phases(A, U0, B, fun, tol, schedule, lag,
                                    phases, shift=shift)
    return _trace_update_host_eigh(A, U0, B, fun, tol, schedule, lag,
                                   shift=shift)


def trace_fun_update_edges(
    A,
    edges,
    sign: float,
    fun="exp",
    tol: float = 1e-12,
    rescale: float = 1.0,
    schedule: Sequence[int] = DEFAULT_SCHEDULE,
    phases: Sequence[int] = DEFAULT_PHASES,
    shift: float = 0.0,
) -> TraceUpdateResult:
    """Δtrace for removing (sign=-1) or adding (sign=+1) each candidate edge
    independently (the loop at ``krylov_miobi.m:76-125``). Batches above
    ``MAX_SCORE_CELLS`` run as fixed-width chunks, the last padded with a
    repeated edge."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    with tracing.span("scorer", len(edges)):
        return _score_edges(A, edges, sign, fun, tol, rescale, schedule,
                            phases, shift)


def _score_edges(A, edges: np.ndarray, sign: float, fun, tol: float,
                 rescale: float, schedule, phases,
                 shift: float) -> TraceUpdateResult:
    """:func:`trace_fun_update_edges` inside its span: the padding and
    chunks recurse here."""
    batch = len(edges)
    # an operator whose product shards its columns over a 'cands' mesh axis
    # (parallel/spmm_sharded.py) needs the batch divisible by that axis: pad
    # with a repeated edge and slice the results back
    pad_mult = _batch_multiple(A)
    if batch % pad_mult:
        padded = -(-batch // pad_mult) * pad_mult
        r = _score_edges(
            A, np.concatenate([edges, np.repeat(edges[:1], padded - batch,
                                                0)]),
            sign, fun, tol, rescale, schedule, phases, shift)
        return TraceUpdateResult(delta=r.delta[:batch], iters=r.iters[:batch],
                                 converged=r.converged[:batch])
    chunk = max(64, (int(MAX_SCORE_CELLS) // max(int(A.n), 1)) // 64 * 64)
    chunk = max(pad_mult, chunk - chunk % pad_mult)
    if batch > chunk:
        parts = []
        for s in range(0, batch, chunk):
            e = edges[s:s + chunk]
            keep = len(e)
            if keep < chunk:
                e = np.concatenate([e, np.repeat(e[:1], chunk - keep, 0)])
            r = _score_edges(A, e, sign, fun, tol, rescale, schedule,
                             phases, shift)
            parts.append((r, keep))
        return TraceUpdateResult(
            delta=torch.cat([r.delta[:k].cpu() for r, k in parts]),
            iters=torch.cat([r.iters[:k].cpu() for r, k in parts]),
            converged=torch.cat([r.converged[:k].cpu() for r, k in parts]),
        )
    U0 = edge_start_blocks(A.n, edges, A.dtype, A.device)
    B = edge_B(edges, sign, rescale, A.dtype, A.device)
    return trace_fun_update_batched(A, U0, B, fun=fun, tol=tol,
                                    schedule=schedule, phases=phases,
                                    shift=shift)


def trace_fun_update_single(A_dense: torch.Tensor, U: torch.Tensor,
                            B: torch.Tensor, fun="exp") -> torch.Tensor:
    """Dense exact path (reference ``trace_fun_update.m:37-51``) for small n
    or oracle checks: trace(f(A + U B Uᵀ) − f(A)) from two eigvalsh."""
    return trace_fun_update_dense(A_dense, U, B, fun)
