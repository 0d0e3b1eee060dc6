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


def _with_zero_slots(A: sp.csr_matrix, extra_edges) -> sp.csr_matrix:
    """A with explicit-zero entries at both triangles of ``extra_edges``
    (make mode's candidate slots): additions become pure value updates, and
    a bf16-exactness test of the values sees the zeros they hold."""
    if extra_edges is None or not len(extra_edges):
        return A
    e = np.asarray(extra_edges)
    C0 = sp.coo_matrix(A)
    r = np.concatenate([C0.row, e[:, 0], e[:, 1]])
    c = np.concatenate([C0.col, e[:, 1], e[:, 0]])
    v = np.concatenate([C0.data, np.zeros(2 * len(e), C0.data.dtype)])
    return sp.coo_matrix((v, (r, c)), shape=A.shape).tocsr()


def _search(keys: np.ndarray, n: int, i, j) -> np.ndarray:
    """Positions of the row-major keys i·n + j in the sorted ``keys``;
    KeyError where one is missing."""
    key = np.asarray(i, np.int64) * n + np.asarray(j, np.int64)
    pos = np.minimum(np.searchsorted(keys, key), max(len(keys) - 1, 0))
    if not len(keys) or not np.all(keys[pos] == key):
        raise KeyError("edge not in the frozen structure")
    return pos


class _FrozenStructureMatrix:
    """COO matrix with a fixed sparsity pattern and in-place value edits
    (symmetric). (i, j) → slot lookups search the sorted row-major keys."""

    def __init__(self, A: sp.spmatrix, extra_edges: np.ndarray | None,
                 dtype=torch.float64, *, device):
        A = _with_slots(sp.csr_matrix(A, copy=True), extra_edges)
        self.mat = CooMatrix.from_scipy(A, dtype=dtype, device=device)
        k = self.mat.nnz
        self._keys = _np(self.mat.rows[:k]) * self.mat.n + _np(
            self.mat.cols[:k])
        if extra_edges is not None and len(extra_edges):
            # zero the placeholder values (in place)
            idx = self._edge_positions(np.asarray(extra_edges))
            self.mat.vals[torch.as_tensor(idx, device=self.mat.device)] = 0.0

    def _lookup(self, i, j) -> np.ndarray:
        return _search(self._keys, self.mat.n, i, j)

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


def _batch_axis(mesh):
    return "cands" if "cands" in mesh.shape else None


class _ShardedSlots:
    """(i, j) → global flat position of a sharded operator's value slot (a
    search over the sorted row-major keys), and positions in this rank's
    storage for the fused lane, where another rank's slot maps to the
    scratch element."""

    def _set_keys(self, keys: np.ndarray, flat: np.ndarray) -> None:
        by_key = np.argsort(keys, kind="stable")
        self._keys, self._flat = keys[by_key], flat[by_key]

    def _lookup(self, i, j) -> np.ndarray:
        return self._flat[_search(self._keys, self.operator.n, i, j)]

    _edge_positions = _FrozenStructureMatrix._edge_positions

    def fused_slots(self, E: np.ndarray) -> np.ndarray:
        E = np.asarray(E, np.int64).reshape(-1, 2)
        return np.stack([self.operator.local_positions(
            self._lookup(E[:, a], E[:, b])) for a, b in ((0, 1), (1, 0))],
            axis=1)


class _ShardedFrozenMatrix(_ShardedSlots):
    """Frozen-structure adapter over :class:`..parallel.spmm_sharded.
    RowShardedMatrix` (COO layout): the row-partitioned operator, with the
    candidate batch split over a ``cands`` axis on a 2-D mesh. Slots are
    addressed by their global flat position shard·nnz_shard + slot, as in
    the JAX package; each rank writes the ones it holds (another rank's
    land in the scratch slot)."""

    def __init__(self, A: sp.spmatrix, extra_edges: np.ndarray | None,
                 dtype=torch.float64, mesh=None, *, device):
        from ..parallel.mesh import default_mesh
        from ..parallel.spmm_sharded import RowShardedMatrix

        mesh = default_mesh(device=device) if mesh is None else mesh
        A = _with_slots(sp.csr_matrix(A, copy=True), extra_edges)
        self.mat = RowShardedMatrix.from_scipy(A, mesh, dtype=dtype,
                                               batch_axis=_batch_axis(mesh))
        # global flat position of each entry, mirroring from_scipy's packing
        # (row-sorted, each shard's run contiguous)
        C = sp.coo_matrix(A)
        order = np.argsort(C.row, kind="stable")
        rows, cols = C.row[order].astype(np.int64), C.col[order]
        D = mesh.shape[self.mat.axis]
        shard_of = rows // self.mat.rows_per_shard
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(shard_of, minlength=D))[:-1]])
        self._set_keys(rows * self.mat.n + cols, shard_of *
                       self.mat.nnz_shard + (np.arange(len(rows))
                                             - starts[shard_of]))
        if extra_edges is not None and len(extra_edges):
            self.set_edges(np.asarray(extra_edges), 0.0)

    def set_edges(self, edges, value: float):
        idx = self.mat.local_positions(self._edge_positions(edges))
        self.mat.vals[torch.as_tensor(idx, device=self.mat.device)] = value

    def set_edge(self, i: int, j: int, value: float):
        self.set_edges(np.array([[i, j]]), value)

    @property
    def operator(self):
        return self.mat

    def map_edges(self, E: np.ndarray) -> np.ndarray:
        return E

    def to_scipy(self) -> sp.csr_matrix:
        rows, cols, vals = self.mat.gather_coo()
        n = self.mat.n_orig
        # pad slots carry val 0 and go with the zeros
        out = sp.coo_matrix((vals, (rows, cols)),
                            shape=(self.mat.n, self.mat.n)).tocsr()[:n, :n]
        out.eliminate_zeros()
        return out

    # -- fused multi-step hooks (fused_slots: positions in this rank's vals)
    fused_state = _FrozenStructureMatrix.fused_state
    fused_rebuild = staticmethod(_FrozenStructureMatrix.fused_rebuild)
    set_fused_vals = _FrozenStructureMatrix.set_fused_vals


class _ShardedBsrFrozenMatrix(_ShardedSlots):
    """Frozen-structure adapter over :class:`..parallel.spmm_sharded.
    BsrRowShardedMatrix`, whose local product is K1/K2. Globally
    RCM-permuted at build time, so each shard's block is banded; candidate
    selection and reported edges stay in the original labeling through the
    pinv mapping, as with :class:`_BsrAdapter`. Make mode's candidate slots
    are explicit zeros from the start (the JAX package writes 1e-300
    placeholders and zeros them after the packing, so its bf16-exactness
    test sees the placeholders and runs K2 where K1 is exact)."""

    def __init__(self, A: sp.spmatrix, extra_edges: np.ndarray | None,
                 dtype=torch.float64, mesh=None, tile=(512, 256), *, device):
        from ..ops.banded_spmm import rcm_permutation
        from ..parallel.mesh import default_mesh
        from ..parallel.spmm_sharded import BsrRowShardedMatrix

        mesh = default_mesh(device=device) if mesh is None else mesh
        A = _with_zero_slots(sp.csr_matrix(A, copy=True), extra_edges)
        perm = rcm_permutation(A)
        self.pinv = np.empty_like(perm)
        self.pinv[perm] = np.arange(len(perm))
        # permute in COO space (scipy's fancy indexing would drop the
        # explicit-zero addition slots)
        C1 = sp.coo_matrix(A)
        Ap = sp.coo_matrix((C1.data, (self.pinv[C1.row], self.pinv[C1.col])),
                           shape=A.shape).tocsr()
        self.op = BsrRowShardedMatrix.from_scipy(
            Ap, mesh, dtype=dtype, batch_axis=_batch_axis(mesh), tile=tile)
        rc = self.op.entry_rc()
        self._set_keys(rc[:, 0] * self.op.n + rc[:, 1],
                       self.op.entry_positions())

    @property
    def operator(self):
        return self.op

    def map_edges(self, E: np.ndarray) -> np.ndarray:
        return self.pinv[np.asarray(E)]

    def set_edge(self, i: int, j: int, value: float):
        pi, pj = int(self.pinv[i]), int(self.pinv[j])
        self.op.set_flat(self._edge_positions(np.array([[pi, pj]])), value)

    def to_scipy(self) -> sp.csr_matrix:
        rc = self.op.entry_rc()
        vals = self.op.entry_values().astype(np.float64)
        perm = np.empty_like(self.pinv)
        perm[self.pinv] = np.arange(len(self.pinv))
        out = sp.coo_matrix((vals, (perm[rc[:, 0]], perm[rc[:, 1]])),
                            shape=self.op.shape).tocsr()
        out.eliminate_zeros()
        return out

    # -- fused multi-step hooks: this rank's flattened tiles and scratch ----
    def fused_state(self):
        return self.op, self.op.storage

    @staticmethod
    def fused_rebuild(op, flat_vals):
        from .fused import sharded_bsr_rebuild

        return sharded_bsr_rebuild(op, flat_vals)

    def set_fused_vals(self, flat_vals):
        self.op = self.fused_rebuild(self.op, flat_vals)


class _BandedAdapter:
    """Greedy-facing adapter over an RCM-permuted operator: maps original
    node ids through the permutation for scoring and edits."""

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


class _BsrAdapter(_BandedAdapter):
    """The same adapter over the super-tile operator, with the fused lane's
    hooks (the banded operator has none, so it never runs fused blocks)."""

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


def choose_operator(A, top, Q: int, mode: str, backend: str,
                    device: torch.device):
    """The scored operator, as the JAX package chooses it
    (greedy.py:595-648), with "the device is CUDA" in place of "the backend
    is the TPU": super tiles for ``backend='bsr'``, or for ``'auto'`` at
    2Q ≥ 256, while the bf16 tile storage fits ``BSR_STORAGE_CAP``;
    otherwise, in break mode only, the banded operator while the RCM band
    fits (``banded_spmm.banded_fits``); otherwise COO. ``'coo'``, and
    ``'auto'`` off CUDA, take COO. Allocates nothing on the device.

    Returns (kind, perm, A_aug): kind is 'bsr', 'banded' or 'coo'; A_aug is
    A with make mode's candidate slots (super tiles only)."""
    from ..ops.banded_spmm import banded_fits, rcm_permutation
    from ..ops.bsr_super import TILE_C, TILE_R, super_tile_count

    if backend == "coo" or (backend == "auto" and device.type != "cuda"):
        return "coo", None, None
    perm = rcm_permutation(A)
    if backend == "bsr" or (backend == "auto" and 2 * Q >= 256):
        A_aug = _with_zero_slots(A, top if mode == "make" else None)
        # bf16 tile storage (mode auto picks bf16x2 for 0/±1 adjacency)
        if super_tile_count(A_aug, perm) * TILE_R * TILE_C * 2 \
                <= BSR_STORAGE_CAP:
            return "bsr", perm, A_aug
    if mode == "break" and banded_fits(A, perm):
        return "banded", perm, None
    return "coo", None, None


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
    mesh=None,
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
    super-tile kernels K1/K2), 'banded' (RCM + banded-ELL kernel K3, break
    mode), 'sharded' (the row-partitioned operator over the ranks of
    ``mesh``, with the candidate batch split over a 'cands' axis; pass
    ``mesh`` or one is built over every rank of the process group),
    'sharded_bsr' (the same partitioning, each shard's product K1/K2 over
    its super-tiles, globally RCM-permuted), or 'auto' — on CUDA the JAX
    package's choice on the TPU (:func:`choose_operator`), COO otherwise.
    The sharded backends run on every rank of the mesh, each holding its
    row block and repeating the host and Krylov work on replicated blocks;
    ``device`` is the rank's device. The super-tile, banded and
    'sharded_bsr' operators work in a relabeled node space; candidate
    selection and reported edges stay in the original labeling.

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
    if backend not in ("auto", "coo", "bsr", "banded", "sharded",
                       "sharded_bsr"):
        raise ValueError(f"unknown backend {backend!r}")
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device}, device is {dev}")
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

    extra = top if mode == "make" else None
    if backend == "sharded":
        F = _ShardedFrozenMatrix(A, extra, dtype=dtype, mesh=mesh, device=dev)
    elif backend == "sharded_bsr":
        F = _ShardedBsrFrozenMatrix(A, extra, dtype=dtype, mesh=mesh,
                                    device=dev)
    else:
        F = _single_device_operator(A, top, Q, mode, backend, dtype, dev)

    # Below the dense cutoff the per-step loop scores exactly; above the
    # cell ceiling the fused block (one scoring call per step, unchunked)
    # cannot run, so large windows take the per-step loop. ¾ of the ceiling
    # leaves room for the padded window and the operator's padded rows. An
    # operator without the fused hooks (banded) runs the per-step loop.
    if (fused_steps > 1 and rescore_every <= 1
            and A.shape[0] > trace_update.DENSE_N_CUTOFF
            and (Q + fused_steps + 64) * A.shape[0]
            <= (3 * trace_update.MAX_SCORE_CELLS) // 4
            and hasattr(F, "fused_state")):
        return _greedy_loop_fused(F, top, Q, k, mode, sign, fun, tol,
                                  rescale, schedule, shift, checkpoint,
                                  dataset, R=fused_steps)
    return _greedy_loop(F, top, Q, k, mode, sign, fun, tol, rescale,
                        schedule, shift, checkpoint, dataset,
                        rescore_every=rescore_every,
                        rescore_frac=rescore_frac)


def _single_device_operator(A, top, Q: int, mode: str, backend: str, dtype,
                            dev):
    """The adapter over the operator :func:`choose_operator` picks."""
    kind, perm, A_aug = choose_operator(A, top, Q, mode, backend, dev)
    if kind != "coo":
        pinv = np.empty_like(perm)
        pinv[perm] = np.arange(len(perm))
    if kind == "bsr":
        from ..ops.bsr_super import SuperBsrOperator

        # permute in COO space: scipy's fancy-indexing permutation drops the
        # explicit-zero slots make mode depends on
        C1 = sp.coo_matrix(A_aug)
        Ap = sp.coo_matrix((C1.data, (pinv[C1.row], pinv[C1.col])),
                           shape=A.shape).tocsr()
        F = _BsrAdapter(SuperBsrOperator(Ap, dtype=dtype, device=dev), pinv)
    elif kind == "banded":
        from ..ops.banded_spmm import BandedEllOperator

        # break mode has no explicit-zero slots to lose: permute as the JAX
        # package does, so that the entry order matches its operator's
        Ap = A[perm, :].tocsc()[:, perm].tocsr()
        F = _BandedAdapter(BandedEllOperator(Ap, dtype=dtype, device=dev),
                           pinv)
    else:
        F = _FrozenStructureMatrix(
            A, extra_edges=top if mode == "make" else None, dtype=dtype,
            device=dev)
    return F


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

    # fixed candidate-table size for the whole sweep, a multiple of the
    # 'cands' axis of a sharded operator (its product splits the columns)
    op0, _ = F.fused_state()
    ba = getattr(op0, "batch_axis", None)
    pad_mult = int(op0.mesh.shape[ba]) if ba else 1
    nC_pad = -(-(Q + R) // pad_mult) * pad_mult
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
