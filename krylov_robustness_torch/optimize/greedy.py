"""Greedy break/make robustness optimization — port of
``krylov_robustness_tpu/optimize/greedy.py`` (reference
``functions/greedy_krylov.m`` driving ``functions/krylov_miobi.m``).

The outer loop (budget steps, candidate bookkeeping, edge commits) is host
Python, as in the reference; the inner candidate loop is one batched scoring
call (:func:`..updates.trace_update.trace_fun_update_edges`) or, on the
fused lane, R steps per block (:mod:`.fused`). The sparsity structure is
frozen for the whole sweep: deletions zero value slots, additions write
pre-allocated explicit-zero slots, so the scored operator never changes
shape. Edits are in-place writes into the operator's value storage.

Defaults mirror ``krylov_miobi.m:29-64`` / ``greedy_krylov.m:30-56``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..graphs.top_edges import find_top_edges, find_top_missing_edges
from ..ops.sparse import CooMatrix
from ..updates import trace_update
from ..updates.trace_update import DEFAULT_SCHEDULE, trace_fun_update_edges
from ..utils.device import float_dtype, require_full_f32_matmul, \
    resolve_device
from ..utils.guards import check_finite

# greedy tile-storage cap for the super-tile backend (bf16 tiles), kept at the
# JAX package's value so backend decisions match it
BSR_STORAGE_CAP = 768 * 1024 * 1024


def _guard_scores(scores: np.ndarray, step: int, dataset: str = ""):
    """A NaN/Inf score would silently win or lose the argmin: warn with the
    offending count (the reference's analog is its non-convergence warning,
    ``trace_fun_update.m:128-130``)."""
    report = check_finite(scores, name=f"greedy scores step {step} {dataset}")
    if not report.finite:
        bad = int(np.sum(~np.isfinite(scores)))
        warnings.warn(
            f"{report.name}: {bad}/{scores.size} candidate scores are "
            f"non-finite (max |x| = {report.max_abs:.3e}); they are "
            "excluded from the argmin", RuntimeWarning)
    return report.finite


@dataclasses.dataclass
class GreedyResult:
    edges: np.ndarray  # (k, 2) chosen edges
    rob_variation: float  # cumulative Δtrace
    A_new: sp.csr_matrix  # updated adjacency
    per_step_delta: np.ndarray  # (k,) chosen Δtrace per step
    per_step_iters: np.ndarray  # (k,) Krylov steps used for the chosen edge
    per_step_time: np.ndarray | None = None  # (k,) wall seconds per step
    operator: str = ""  # the scored operator, e.g. "SuperBsrOperator(bf16x2)"
    fused_accepted: int = 0  # steps committed by fused blocks


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _with_slots(A: sp.csr_matrix, extra_edges) -> sp.csr_matrix:
    """A with explicit (1e-300) entries at both triangles of ``extra_edges``,
    the pre-allocated slots of make-mode additions."""
    if extra_edges is None or not len(extra_edges):
        return A
    e = np.asarray(extra_edges)
    n = A.shape[0]
    pattern = sp.coo_matrix(
        (np.full(2 * len(e), 1e-300),
         (np.concatenate([e[:, 0], e[:, 1]]),
          np.concatenate([e[:, 1], e[:, 0]]))), shape=(n, n))
    return (A + pattern.tocsr()).tocsr()


class _FrozenStructureMatrix:
    """COO matrix with a fixed sparsity pattern and in-place value edits
    (symmetric). (i, j) → slot lookups search the sorted row-major keys."""

    def __init__(self, A: sp.spmatrix, extra_edges: np.ndarray | None,
                 dtype=torch.float64, *, device):
        A = _with_slots(sp.csr_matrix(A, copy=True), extra_edges)
        self.mat = CooMatrix.from_scipy(A, dtype=dtype, device=device)
        self._keys = _np(self.mat.rows) * self.mat.n + _np(self.mat.cols)
        if extra_edges is not None and len(extra_edges):
            # zero the placeholder values (in place)
            idx = self._edge_positions(np.asarray(extra_edges))
            self.mat.vals[torch.as_tensor(idx, device=self.mat.device)] = 0.0

    def _lookup(self, i, j) -> np.ndarray:
        key = np.asarray(i, np.int64) * self.mat.n + np.asarray(j, np.int64)
        pos = np.minimum(np.searchsorted(self._keys, key),
                         max(len(self._keys) - 1, 0))
        if not len(self._keys) or not np.all(self._keys[pos] == key):
            raise KeyError("edge not in the frozen structure")
        return pos

    def _edge_positions(self, edges: np.ndarray) -> np.ndarray:
        e = np.asarray(edges, np.int64).reshape(-1, 2)
        p1 = self._lookup(e[:, 0], e[:, 1])
        p2 = self._lookup(e[:, 1], e[:, 0])
        return np.concatenate([p1, p2[e[:, 0] != e[:, 1]]])

    def set_edge(self, i: int, j: int, value: float):
        idx = self._edge_positions(np.array([[i, j]]))
        self.mat.vals[torch.as_tensor(idx, device=self.mat.device)] = value

    def to_scipy(self) -> sp.csr_matrix:
        out = self.mat.to_scipy()
        out.eliminate_zeros()
        return out

    @property
    def operator(self):
        return self.mat

    def map_edges(self, E: np.ndarray) -> np.ndarray:
        return E

    # -- fused multi-step hooks (optimize/fused.py) -------------------------
    def fused_state(self):
        return self.mat, self.mat.vals

    @staticmethod
    def fused_rebuild(op, vals):
        from .fused import coo_rebuild

        return coo_rebuild(op, vals)

    def fused_slots(self, E: np.ndarray) -> np.ndarray:
        E = np.asarray(E, np.int64).reshape(-1, 2)
        return np.stack([self._lookup(E[:, 0], E[:, 1]),
                         self._lookup(E[:, 1], E[:, 0])], axis=1)

    def set_fused_vals(self, vals):
        self.mat = dataclasses.replace(self.mat, vals=vals)


class _BsrAdapter:
    """Greedy-facing adapter over the RCM-permuted super-tile operator: maps
    original node ids through the permutation for scoring and edits."""

    def __init__(self, op, pinv: np.ndarray):
        self.op = op
        self.pinv = pinv

    @property
    def operator(self):
        return self.op

    def map_edges(self, E: np.ndarray) -> np.ndarray:
        return self.pinv[np.asarray(E)]

    def set_edge(self, i: int, j: int, value: float):
        self.op.set_edge(int(self.pinv[i]), int(self.pinv[j]), value)

    def to_scipy(self) -> sp.csr_matrix:
        rows, cols = self.op._entry_rc
        perm = np.empty_like(self.pinv)
        perm[self.pinv] = np.arange(len(self.pinv))
        out = sp.coo_matrix(
            (self.op.entry_values(), (perm[rows], perm[cols])),
            shape=(self.op.n, self.op.n)).tocsr()
        out.eliminate_zeros()
        return out

    # -- fused multi-step hooks: flat view over the tile storage ------------
    def fused_state(self):
        return self.op, self.op.atiles.view(-1)

    @staticmethod
    def fused_rebuild(op, flat_vals):
        from .fused import bsr_rebuild

        return bsr_rebuild(op, flat_vals)

    def fused_slots(self, E: np.ndarray) -> np.ndarray:
        E = np.asarray(E, np.int64).reshape(-1, 2)
        tc = self.op.atiles.shape[1] * self.op.atiles.shape[2]
        out = np.empty((len(E), 2), np.int64)
        for c, (a, b) in enumerate(((0, 1), (1, 0))):
            e = self.op.entry_index(E[:, a], E[:, b])
            out[:, c] = self.op._entry_tile[e] * tc + self.op._entry_offset[e]
        return out

    def set_fused_vals(self, flat_vals):
        self.op.atiles = flat_vals.view(self.op.atiles.shape)


def krylov_miobi(
    A: sp.spmatrix,
    k: int,
    E: np.ndarray | None = None,
    tol: float = 1e-12,
    schedule: Sequence[int] = DEFAULT_SCHEDULE,
    mode: str = "break",
    rescale: float = 1.0,
    fun="exp",
    dtype=torch.float64,
    shift: float = 0.0,
    *,
    device,
) -> GreedyResult:
    """Greedy selection of k edges from candidate set E scored by batched
    Krylov trace updates (``functions/krylov_miobi.m``): 'break' removes the
    arg-min Δtrace edge per step, 'make' adds the arg-max. E defaults to all
    existing edges (``krylov_miobi.m:43-52``)."""
    A = sp.csr_matrix(A)
    if (abs(A - A.T) > 1e-12).nnz:
        raise ValueError("adjacency matrix must be symmetric")
    if E is None:
        C = sp.coo_matrix(sp.tril(A))
        E = np.stack([C.row, C.col], axis=1)
    E = np.asarray(E, dtype=np.int64)
    if mode == "break" and A.nnz < 2 * k:
        raise ValueError("edges to be removed exceed edges in the network")
    sign = -1.0 if mode == "break" else +1.0
    dev = resolve_device(device)
    F = _FrozenStructureMatrix(A, extra_edges=E if mode == "make" else None,
                               dtype=float_dtype(dtype), device=dev)
    chosen, deltas, iters, times = [], [], [], []
    rob = 0.0
    # fixed-size candidate array + alive mask (no per-step shape changes)
    alive = np.ones(len(E), dtype=bool)
    for _ in range(min(k, len(E))):
        t_step = time.perf_counter()
        res = trace_fun_update_edges(
            F.operator, F.map_edges(E), sign=sign, fun=fun, tol=tol,
            rescale=rescale, schedule=schedule, shift=shift)
        scores = _np(res.delta).copy()
        if not _guard_scores(scores[alive], len(chosen)):
            scores[~np.isfinite(scores)] = np.inf if mode == "break" \
                else -np.inf
        scores[~alive] = np.inf if mode == "break" else -np.inf
        h = int(np.argmin(scores) if mode == "break" else np.argmax(scores))
        i, j = int(E[h, 0]), int(E[h, 1])
        chosen.append((i, j))
        deltas.append(float(scores[h]))
        iters.append(int(_np(res.iters)[h]))
        rob += float(scores[h])
        F.set_edge(i, j, 0.0 if mode == "break" else 1.0 / rescale)
        alive[h] = False
        times.append(time.perf_counter() - t_step)
    return GreedyResult(
        edges=np.asarray(chosen, dtype=np.int64).reshape(-1, 2),
        rob_variation=rob, A_new=F.to_scipy(),
        per_step_delta=np.asarray(deltas), per_step_iters=np.asarray(iters),
        per_step_time=np.asarray(times))


def _use_super_tiles(A, top, Q: int, mode: str, backend: str,
                     device: torch.device):
    """The super-tile decision of the JAX package (greedy.py:595-641), with
    the banded backend's share taken by the super-tile kernel on CUDA until
    the banded kernel is ported. Returns (use_bsr, perm, A_aug)."""
    from ..ops.banded_spmm import rcm_bandwidth, rcm_permutation
    from ..ops.bsr_super import TILE_C, TILE_R, super_tile_count

    if backend == "coo" or (backend == "auto" and device.type != "cuda"):
        return False, None, None
    perm = rcm_permutation(A)
    wide_batch = 2 * Q >= 256
    if backend == "auto" and not wide_batch:
        # the JAX package runs narrow break sweeps with a narrow RCM band on
        # its banded kernel; the port takes the super-tile kernel there
        bw = rcm_bandwidth(A, perm)
        if mode != "break" or 2 * ((bw + 127) // 128 + 1) - 1 > 17:
            return False, None, None
    A_aug = A
    if mode == "make":
        # candidate slots as explicit zeros (both triangles): greedy
        # additions are pure value updates
        C0 = sp.coo_matrix(A)
        r = np.concatenate([C0.row, top[:, 0], top[:, 1]])
        c = np.concatenate([C0.col, top[:, 1], top[:, 0]])
        v = np.concatenate([C0.data, np.zeros(2 * len(top), C0.data.dtype)])
        A_aug = sp.coo_matrix((v, (r, c)), shape=A.shape).tocsr()
    ntile = super_tile_count(A_aug, perm)
    return ntile * TILE_R * TILE_C * 2 <= BSR_STORAGE_CAP, perm, A_aug


def greedy_krylov(
    A: sp.spmatrix,
    k: int,
    Q: int | None,
    centrality: np.ndarray,
    order: str = "mult",
    tol: float = 1e-12,
    schedule: Sequence[int] = DEFAULT_SCHEDULE,
    mode: str = "break",
    rescale: float = 1.0,
    fun="exp",
    dtype=torch.float64,
    checkpoint=None,
    dataset: str = "",
    backend: str = "auto",
    shift: float = 0.0,
    rescore_every: int = 1,
    rescore_frac: float = 0.2,
    fused_steps: int | None = 0,
    *,
    device,
) -> GreedyResult:
    """Adaptive-search-space greedy (``functions/greedy_krylov.m``): select
    the top Q+k candidates by centrality once, then per budget step re-score
    the surviving Q candidates and commit the best edge.

    ``backend``: 'coo' (gather + ``index_add_`` SpMM), 'bsr' (RCM +
    super-tile kernels K1/K2), or 'auto' — super tiles on CUDA where the JAX
    package would run a Pallas kernel, COO otherwise. 'banded', 'sharded' and
    'sharded_bsr' are not ported yet. The super-tile operator works in a
    relabeled node space; candidate selection and reported edges stay in the
    original labeling.

    ``fused_steps`` > 1 runs that many budget steps per block (:mod:`.fused`)
    with per-step replay of straggler steps; ``None`` resolves per dtype (10
    for float32, 0 for float64). ``checkpoint`` is any object with
    ``load(dataset)``, ``save(dataset, step, edges, rob, extra=...)`` and
    ``clear()``.
    """
    dev = resolve_device(device)
    dtype = float_dtype(dtype)
    if dev.type == "cuda" and dtype == torch.float32:
        require_full_f32_matmul()
    if fused_steps is None:
        fused_steps = 10 if dtype == torch.float32 else 0
    if backend in ("banded", "sharded", "sharded_bsr"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet (ROADMAP.md, Queue 1)")
    if backend not in ("auto", "coo", "bsr"):
        raise ValueError(f"unknown backend {backend!r}")
    A = sp.csr_matrix(A, copy=True)
    if Q is None or Q == 0:
        Q = int(A.sum(axis=0).max())
    if mode == "break" and A.nnz < 2 * k:
        raise ValueError("edges to be removed exceed edges in the network")
    if mode == "make":
        top = find_top_missing_edges(A, centrality, Q + k, order)
    else:
        top = find_top_edges(A, centrality, Q + k, order)
    sign = -1.0 if mode == "break" else +1.0

    use_bsr, perm, A_aug = _use_super_tiles(A, top, Q, mode, backend, dev)
    if use_bsr:
        from ..ops.bsr_super import SuperBsrOperator

        pinv = np.empty_like(perm)
        pinv[perm] = np.arange(len(perm))
        # permute in COO space: scipy's fancy-indexing permutation drops the
        # explicit-zero slots make mode depends on
        C1 = sp.coo_matrix(A_aug)
        Ap = sp.coo_matrix((C1.data, (pinv[C1.row], pinv[C1.col])),
                           shape=A.shape).tocsr()
        F = _BsrAdapter(SuperBsrOperator(Ap, dtype=dtype, device=dev), pinv)
    else:
        F = _FrozenStructureMatrix(
            A, extra_edges=top if mode == "make" else None, dtype=dtype,
            device=dev)

    # Below the dense cutoff the per-step loop scores exactly; above the
    # cell ceiling the fused block (one scoring call per step, unchunked)
    # cannot run, so large windows take the per-step loop. ¾ of the ceiling
    # leaves room for the padded window and the operator's padded rows.
    if (fused_steps > 1 and rescore_every <= 1
            and A.shape[0] > trace_update.DENSE_N_CUTOFF
            and (Q + fused_steps + 64) * A.shape[0]
            <= (3 * trace_update.MAX_SCORE_CELLS) // 4):
        return _greedy_loop_fused(F, top, Q, k, mode, sign, fun, tol,
                                  rescale, schedule, shift, checkpoint,
                                  dataset, R=fused_steps)
    return _greedy_loop(F, top, Q, k, mode, sign, fun, tol, rescale,
                        schedule, shift, checkpoint, dataset,
                        rescore_every=rescore_every,
                        rescore_frac=rescore_frac)


def _replay_checkpoint(F, top, mode, rescale, checkpoint, dataset):
    """Resume bookkeeping shared by the per-step and fused loops: re-apply
    recorded edits, shrink the search space, restore the running tallies."""
    chosen: list = []
    deltas: list = []
    iters: list = []
    times: list = []
    rob = 0.0
    start_step = 0
    if checkpoint is not None:
        state = checkpoint.load(dataset)
        if state is not None:
            for i, j in state["edges"]:
                F.set_edge(int(i), int(j),
                           0.0 if mode == "break" else 1.0 / rescale)
                top = top[~((top[:, 0] == i) & (top[:, 1] == j))]
                chosen.append((int(i), int(j)))
            rob = state["rob_variation"]
            start_step = state["step"]
            deltas = list(state["extra"].get("deltas", [0.0] * start_step))
            iters = list(state["extra"].get("iters", [0] * start_step))
            times = list(state["extra"].get("times", [0.0] * start_step))
    return top, chosen, deltas, iters, times, rob, start_step


def _describe(op) -> str:
    mode = getattr(op, "mode", None)
    return f"{type(op).__name__}({mode})" if mode else type(op).__name__


def _result(F, chosen, rob, deltas, iters, times,
            fused_accepted: int = 0) -> GreedyResult:
    return GreedyResult(
        edges=np.asarray(chosen, dtype=np.int64).reshape(-1, 2),
        rob_variation=rob, A_new=F.to_scipy(),
        per_step_delta=np.asarray(deltas), per_step_iters=np.asarray(iters),
        per_step_time=np.asarray(times), operator=_describe(F.operator),
        fused_accepted=fused_accepted)


def _greedy_loop_fused(F, top, Q, k, mode, sign, fun, tol, rescale, schedule,
                       shift, checkpoint, dataset, R=8):
    """Fused-block budget loop: R greedy steps per block (:mod:`.fused`, the
    reference hot loop ``krylov_miobi.m:112-137``). A step whose window has
    convergence stragglers beyond the fused budget is replayed through the
    accurate per-step lane, so results keep the full 100-step guarantee."""
    from ..funm.scalar import get_fun
    from .fused import fused_greedy_block

    rescale = float(rescale)
    fun_name = get_fun(fun).name
    top, chosen, deltas, iters, times, rob, step = _replay_checkpoint(
        F, top, mode, rescale, checkpoint, dataset)
    commit = 0.0 if mode == "break" else 1.0 / rescale

    def record(i, j, d, it, t):
        nonlocal rob
        chosen.append((int(i), int(j)))
        deltas.append(float(d))
        iters.append(int(it))
        rob += float(d)
        times.append(t)

    def shrink(i, j):
        nonlocal top
        top = top[~((top[:, 0] == i) & (top[:, 1] == j))]

    def save():
        if checkpoint is not None:
            checkpoint.save(dataset, step, chosen, rob,
                            extra={"deltas": deltas, "iters": iters,
                                   "times": times})

    # fixed candidate-table size for the whole sweep
    nC_pad = Q + R
    # persistent-straggler bail-out: after two consecutive zero-accept
    # blocks, devolve to per-step scoring for the rest of the sweep
    consec_bad = 0
    devolved = False
    fused_accepted = 0
    while step < k:
        acc = 0
        want = min(R, k - step)
        if not devolved:
            t0 = time.perf_counter()
            nC = min(len(top), nC_pad)
            table = top[:nC]
            if nC_pad > nC:
                table = np.concatenate(
                    [table, np.repeat(table[:1], nC_pad - nC, axis=0)])
            alive = np.zeros(nC_pad, bool)
            alive[:nC] = True
            mapped = np.asarray(F.map_edges(table))
            slots = F.fused_slots(mapped)
            op, vals = F.fused_state()
            vals_f, _, outs = fused_greedy_block(
                op, vals, mapped, slots, alive, commit, tol, shift, sign,
                rescale, rebuild=F.fused_rebuild, Q=Q, R=R, mode=mode,
                fun_name=fun_name)
            hs, dls, its, oks, nfs = (_np(t) for t in outs)
            while acc < want and oks[acc]:
                acc += 1
            if np.any(nfs[:max(acc, 1)]):
                warnings.warn(
                    f"fused greedy {dataset}: non-finite candidate scores "
                    f"in steps {step}..{step + acc} (excluded from the "
                    "argmin)", RuntimeWarning)
            t_per = (time.perf_counter() - t0) / max(acc, 1)
            for r in range(acc):
                h = int(hs[r])
                record(table[h, 0], table[h, 1], dls[r], its[r], t_per)
                shrink(table[h, 0], table[h, 1])
            if acc == R:
                F.set_fused_vals(vals_f)
            elif acc > 0:
                # the block worked on a copy: commit the accepted winners
                # into the pre-block storage, in place
                idxs = slots[hs[:acc]].reshape(-1)
                vals[torch.as_tensor(idxs, device=vals.device)] = commit
                F.set_fused_vals(vals)
            step += acc
            fused_accepted += acc
            if acc:
                save()
            consec_bad = consec_bad + 1 if acc == 0 else 0
            if consec_bad >= 2:
                devolved = True
                warnings.warn(
                    f"fused greedy {dataset}: convergence stragglers "
                    f"outlive the fused budget persistently at step {step};"
                    " devolving to per-step scoring for the remaining "
                    "budget", RuntimeWarning)
        if devolved or (acc < want and not oks[acc]):
            # straggler (or no finite score) in this step's window: score it
            # through the accurate per-step lane
            t1 = time.perf_counter()
            E = top[:Q]
            res = trace_fun_update_edges(
                F.operator, F.map_edges(E), sign=sign, fun=fun, tol=tol,
                rescale=rescale, schedule=schedule, shift=shift)
            scores = _np(res.delta).copy()
            worst = np.inf if mode == "break" else -np.inf
            if not _guard_scores(scores, step, dataset):
                scores[~np.isfinite(scores)] = worst
            h = int(np.argmin(scores) if mode == "break"
                    else np.argmax(scores))
            i, j = int(E[h, 0]), int(E[h, 1])
            F.set_edge(i, j, commit)
            record(i, j, scores[h], _np(res.iters)[h],
                   time.perf_counter() - t1)
            shrink(i, j)
            step += 1
            save()
    if checkpoint is not None:
        checkpoint.clear()
    return _result(F, chosen, rob, deltas, iters, times, fused_accepted)


def _greedy_loop(F, top, Q, k, mode, sign, fun, tol, rescale, schedule,
                 shift, checkpoint, dataset, rescore_every=1,
                 rescore_frac=0.2):
    """The per-step budget loop: score the surviving Q candidates in one
    batched call, commit the best edge, shrink the search space
    (``greedy_krylov.m:64-93``).

    ``rescore_every`` > 1 reuses stale scores between full rescores: a
    fixed-size fresh subset (the best ``rescore_frac`` by stale score, every
    candidate incident to the last edit, never-scored entrants) is scored
    each step, and a stale would-be winner forces a full rescore, so the
    committed pick always carries a fresh score. 1 is the reference
    protocol."""
    rescale = float(rescale)
    top, chosen, deltas, iters, times, rob, start_step = _replay_checkpoint(
        F, top, mode, rescale, checkpoint, dataset)
    worst = np.inf if mode == "break" else -np.inf
    scores_all = np.full(len(top), np.nan)  # stale scores aligned with top
    iters_all = np.zeros(len(top), np.int64)
    have_scores = False
    last_edit = None
    for step in range(start_step, k):
        t_step = time.perf_counter()
        E = top[:Q]
        nE = len(E)
        do_full = (rescore_every <= 1 or not have_scores
                   or (step - start_step) % rescore_every == 0)
        if not do_full:
            stale = scores_all[:nE]
            # fixed-size fresh subset, padded to a multiple of 64
            T_fix = min(nE, max(64, -(-int(nE * rescore_frac) // 64) * 64))
            rank_key = np.where(np.isnan(stale), worst,
                                stale if mode == "break" else -stale)
            order = np.argsort(rank_key, kind="stable")
            sel_mask = np.zeros(nE, bool)
            sel_mask[order[:T_fix]] = True
            sel_mask |= np.isnan(stale)
            if last_edit is not None:
                li, lj = last_edit
                sel_mask |= ((E[:, 0] == li) | (E[:, 1] == li)
                             | (E[:, 0] == lj) | (E[:, 1] == lj))
            sel = np.nonzero(sel_mask)[0]
            want = min(nE, -(-len(sel) // 64) * 64)
            if len(sel) < want:  # fill with next-best stale candidates
                extra = order[~sel_mask[order]][: want - len(sel)]
                sel = np.sort(np.concatenate([sel, extra]))
            res = trace_fun_update_edges(
                F.operator, F.map_edges(E[sel]), sign=sign, fun=fun,
                tol=tol, rescale=rescale, schedule=schedule, shift=shift)
            scores = stale.copy()
            scores[sel] = _np(res.delta)
            iters_vec = iters_all[:nE].copy()
            iters_vec[sel] = _np(res.iters)
            guarded = np.zeros(nE, bool)
            if not _guard_scores(scores, step, dataset):
                guarded = ~np.isfinite(scores)
                scores[guarded] = worst
            h = int(np.argmin(scores) if mode == "break"
                    else np.argmax(scores))
            if not sel_mask[h]:
                do_full = True  # stale would-be winner: rescore everything
        if do_full:
            res = trace_fun_update_edges(
                F.operator, F.map_edges(E), sign=sign, fun=fun, tol=tol,
                rescale=rescale, schedule=schedule, shift=shift)
            scores = _np(res.delta).copy()
            iters_vec = _np(res.iters).copy()
            guarded = np.zeros(nE, bool)
            if not _guard_scores(scores, step, dataset):
                guarded = ~np.isfinite(scores)
                scores[guarded] = worst
            h = int(np.argmin(scores) if mode == "break"
                    else np.argmax(scores))
        scores_all[:nE] = scores
        # guarded entries persist as NaN: they re-enter the refresh set next
        # step instead of staying excluded until the next full rescore
        scores_all[:nE][guarded] = np.nan
        iters_all[:nE] = iters_vec
        have_scores = True
        i, j = int(E[h, 0]), int(E[h, 1])
        chosen.append((i, j))
        deltas.append(float(scores[h]))
        iters.append(int(iters_vec[h]))
        rob += float(scores[h])
        F.set_edge(i, j, 0.0 if mode == "break" else 1.0 / rescale)
        last_edit = (i, j)
        # drop the chosen edge from the search space (greedy_krylov.m:68-71)
        keep = ~((top[:, 0] == i) & (top[:, 1] == j))
        top = top[keep]
        scores_all = scores_all[keep]
        iters_all = iters_all[keep]
        times.append(time.perf_counter() - t_step)
        if checkpoint is not None:
            checkpoint.save(dataset, step + 1, chosen, rob,
                            extra={"deltas": deltas, "iters": iters,
                                   "times": times})
    if checkpoint is not None:
        checkpoint.clear()
    return _result(F, chosen, rob, deltas, iters, times)
