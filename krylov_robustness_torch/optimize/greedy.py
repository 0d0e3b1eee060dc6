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
from ..utils import tracing
from ..utils.device import float_dtype, require_full_f32_matmul, \
    resolve_device
from ..utils.guards import check_finite

@dataclasses.dataclass(frozen=True)
class _ModeRule:
    """What a sweep's mode decides: 'break' removes the edge of least
    Δtrace, 'make' adds the edge of greatest. ``sign`` is the update's
    sign, ``commit`` the value a committed edge's slots take, ``worst`` the
    score that never wins."""

    mode: str
    sign: float
    commit: float
    worst: float

    @classmethod
    def of(cls, mode: str, rescale: float = 1.0) -> "_ModeRule":
        if mode not in ("break", "make"):
            raise ValueError(f"mode must be 'break' or 'make', not {mode!r}")
        if mode == "break":
            return cls(mode, -1.0, 0.0, np.inf)
        return cls(mode, +1.0, 1.0 / float(rescale), -np.inf)

    @property
    def adds(self) -> bool:
        return self.sign > 0

    def pick(self, scores: np.ndarray, step: int, dataset: str = "") -> int:
        """The greedy step's pick over a window's scores (written in
        place): a NaN/Inf score would silently win or lose, so non-finite
        ones score worst, with a warning of their count (the reference's
        analog is its non-convergence warning,
        ``trace_fun_update.m:128-130``)."""
        report = check_finite(scores,
                              name=f"greedy scores step {step} {dataset}")
        if not report.finite:
            bad = ~np.isfinite(scores)
            warnings.warn(
                f"{report.name}: {int(bad.sum())}/{scores.size} candidate "
                f"scores are non-finite (max |x| = {report.max_abs:.3e}); "
                "they are excluded from the argmin", RuntimeWarning)
            scores[bad] = self.worst
        return int(np.argmax(scores) if self.adds else np.argmin(scores))


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


def _with_zero_slots(A: sp.spmatrix, extra_edges) -> sp.csr_matrix:
    """A with explicit-zero entries at both triangles of ``extra_edges``
    (make mode's candidate slots): additions become pure value updates, and
    a bf16-exactness test of the values sees the zeros they hold."""
    if extra_edges is None or not len(extra_edges):
        return sp.csr_matrix(A)
    e = np.asarray(extra_edges)
    C0 = sp.coo_matrix(A)
    r = np.concatenate([C0.row, e[:, 0], e[:, 1]])
    c = np.concatenate([C0.col, e[:, 1], e[:, 0]])
    v = np.concatenate([C0.data, np.zeros(2 * len(e), C0.data.dtype)])
    return sp.coo_matrix((v, (r, c)), shape=A.shape).tocsr()


def _relabel(A: sp.spmatrix, perm: np.ndarray):
    """A with node ``perm[r]`` relabeled r (an RCM order), permuted in COO
    space: scipy's fancy-indexing permutation drops the explicit-zero slots
    make mode depends on. Returns (the relabeled CSR matrix, pinv), pinv
    mapping an original label to its new one."""
    pinv = np.empty_like(perm)
    pinv[perm] = np.arange(len(perm))
    C = sp.coo_matrix(A)
    return sp.coo_matrix((C.data, (pinv[C.row], pinv[C.col])),
                         shape=A.shape).tocsr(), pinv


def _unlabel(rows, cols, vals, shape, pinv=None) -> sp.csr_matrix:
    """An operator's entries, in its labels, as a scipy matrix in the
    original labels (relabeling by pinv undoes :func:`_relabel`'s;
    ``pinv=None``: the labels are the same), explicit zeros dropped."""
    C = sp.coo_matrix((vals, (rows, cols)), shape=shape)
    out = C.tocsr() if pinv is None else _relabel(C, pinv)[0]
    out.eliminate_zeros()
    return out


def _search(keys: np.ndarray, n: int, i, j) -> np.ndarray:
    """Positions of the row-major keys i·n + j in the sorted ``keys``;
    KeyError where one is missing."""
    key = np.asarray(i, np.int64) * n + np.asarray(j, np.int64)
    pos = np.minimum(np.searchsorted(keys, key), max(len(keys) - 1, 0))
    if not len(keys) or not np.all(keys[pos] == key):
        raise KeyError("edge not in the frozen structure")
    return pos


class _Adapter:
    """The greedy sweep's view of its scored operator ``op``, whose
    structure is frozen: edges are edited in place (``set_edge``, in the
    original labels), and ``pinv`` maps an original node label to the
    operator's (None: the operator keeps the original labels)."""

    def __init__(self, op, pinv: np.ndarray | None = None):
        self.op = op
        self.pinv = pinv

    @property
    def operator(self):
        return self.op

    def map_edges(self, E: np.ndarray) -> np.ndarray:
        return E if self.pinv is None else self.pinv[np.asarray(E)]


class _SlotAdapter(_Adapter):
    """An adapter whose operator holds each entry in a flat value slot:
    (i, j) → slot by a search over the entries' sorted row-major keys.
    Edits and the fused lane (:mod:`.fused`) write the slots in the storage
    ``fused_state`` returns, ``_local`` mapping a slot to its place there."""

    def _set_keys(self, keys: np.ndarray, slots: np.ndarray) -> None:
        by_key = np.argsort(keys, kind="stable")
        self._keys, self._slots = keys[by_key], slots[by_key]

    def _lookup(self, i, j) -> np.ndarray:
        return self._slots[_search(self._keys, self.op.n, i, j)]

    def _edge_positions(self, edges: np.ndarray) -> np.ndarray:
        e = np.asarray(edges, np.int64).reshape(-1, 2)
        p1 = self._lookup(e[:, 0], e[:, 1])
        p2 = self._lookup(e[:, 1], e[:, 0])
        return np.concatenate([p1, p2[e[:, 0] != e[:, 1]]])

    def _local(self, slots: np.ndarray) -> np.ndarray:
        return slots

    def set_edge(self, i: int, j: int, value: float):
        _, vals = self.fused_state()
        idx = self._local(self._edge_positions(
            self.map_edges(np.array([[i, j]]))))
        vals[torch.as_tensor(idx, device=vals.device)] = value

    # -- fused multi-step hooks (optimize/fused.py) -------------------------
    def fused_state(self):
        return self.op, self.op.vals

    @staticmethod
    def fused_rebuild(op, vals):
        from .fused import coo_rebuild

        return coo_rebuild(op, vals)

    def fused_slots(self, E: np.ndarray) -> np.ndarray:
        E = np.asarray(E, np.int64).reshape(-1, 2)
        return np.stack([self._local(self._lookup(E[:, a], E[:, b]))
                         for a, b in ((0, 1), (1, 0))], axis=1)

    def set_fused_vals(self, vals):
        self.op = self.fused_rebuild(self.op, vals)


class _FrozenStructureMatrix(_SlotAdapter):
    """COO matrix with a fixed sparsity pattern and in-place value edits
    (symmetric); entry k's value is slot k."""

    def __init__(self, A: sp.spmatrix, extra_edges: np.ndarray | None,
                 dtype=torch.float64, *, device):
        super().__init__(CooMatrix.from_scipy(
            _with_zero_slots(A, extra_edges), dtype=dtype, device=device))
        k = self.op.nnz
        self._set_keys(_np(self.op.rows[:k]) * self.op.n
                       + _np(self.op.cols[:k]), np.arange(k))

    @property
    def mat(self) -> CooMatrix:
        """The operator under the name benchmark/tests' fault hooks read."""
        return self.op

    def to_scipy(self) -> sp.csr_matrix:
        return _unlabel(*self.op.host_coo(), self.op.shape)


def _batch_axis(mesh):
    return "cands" if "cands" in mesh.shape else None


class _ShardedFrozenMatrix(_SlotAdapter):
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
        A = _with_zero_slots(A, extra_edges)
        super().__init__(RowShardedMatrix.from_scipy(
            A, mesh, dtype=dtype, batch_axis=_batch_axis(mesh)))
        # global flat position of each entry, mirroring from_scipy's packing
        # (row-sorted, each shard's run contiguous)
        C = sp.coo_matrix(A)
        order = np.argsort(C.row, kind="stable")
        rows, cols = C.row[order].astype(np.int64), C.col[order]
        D = mesh.shape[self.op.axis]
        shard_of = rows // self.op.rows_per_shard
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(shard_of, minlength=D))[:-1]])
        self._set_keys(rows * self.op.n + cols, shard_of *
                       self.op.nnz_shard + (np.arange(len(rows))
                                            - starts[shard_of]))

    def _local(self, slots: np.ndarray) -> np.ndarray:
        return self.op.local_positions(slots)

    def to_scipy(self) -> sp.csr_matrix:
        # pad slots carry val 0 and go with the zeros
        n = self.op.n_orig
        return _unlabel(*self.op.gather_coo(),
                        (self.op.n, self.op.n))[:n, :n]


class _ShardedBsrFrozenMatrix(_SlotAdapter):
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
        A = _with_zero_slots(A, extra_edges)
        Ap, pinv = _relabel(A, rcm_permutation(A))
        super().__init__(BsrRowShardedMatrix.from_scipy(
            Ap, mesh, dtype=dtype, batch_axis=_batch_axis(mesh), tile=tile),
            pinv)
        rc = self.op.entry_rc()
        self._set_keys(rc[:, 0] * self.op.n + rc[:, 1],
                       self.op.entry_positions())

    def _local(self, slots: np.ndarray) -> np.ndarray:
        return self.op.local_positions(slots)

    def to_scipy(self) -> sp.csr_matrix:
        rc = self.op.entry_rc()
        return _unlabel(rc[:, 0], rc[:, 1],
                        self.op.entry_values().astype(np.float64),
                        self.op.shape, self.pinv)

    # -- fused multi-step hooks: this rank's flattened tiles and scratch ----
    def fused_state(self):
        return self.op, self.op.storage

    @staticmethod
    def fused_rebuild(op, flat_vals):
        from .fused import sharded_bsr_rebuild

        return sharded_bsr_rebuild(op, flat_vals)


class _BandedAdapter(_Adapter):
    """Adapter over an RCM-relabeled operator that edits its own entries
    (the banded operator; the super-tile one through :class:`_BsrAdapter`):
    original node ids map through the permutation for scoring and edits. A
    make commit writes 1 into both of its candidate's slots, which the
    operator holds as explicit zeros until then."""

    def set_edge(self, i: int, j: int, value: float):
        self.op.set_edge(int(self.pinv[i]), int(self.pinv[j]), value)

    def to_scipy(self) -> sp.csr_matrix:
        return _unlabel(*self.op._entry_rc, self.op.entry_values(),
                        self.op.shape, self.pinv)


class _BsrAdapter(_BandedAdapter):
    """The same adapter over the super-tile operator, with the fused lane's
    hooks (the banded operator has none, so it never runs fused blocks): a
    slot is an entry's position in the operator's CSR-order values."""

    def fused_state(self):
        return self.op, self.op.vals

    @staticmethod
    def fused_rebuild(op, vals):
        from .fused import bsr_rebuild

        return bsr_rebuild(op, vals)

    def fused_slots(self, E: np.ndarray) -> np.ndarray:
        E = np.asarray(E, np.int64).reshape(-1, 2)
        return np.stack([self.op.entry_index(E[:, a], E[:, b])
                         for a, b in ((0, 1), (1, 0))], axis=1)

    def set_fused_vals(self, vals):
        self.op.vals = vals


class _Tally:
    """A sweep's bookkeeping: the search space ``top`` (the surviving
    candidates in centrality order), the committed edges with their
    Δtrace, Krylov steps and wall seconds, the running Δtrace, and the
    checkpoint (None: none) they are saved to."""

    def __init__(self, top: np.ndarray, checkpoint, dataset: str):
        self.top = top
        self.checkpoint, self.dataset = checkpoint, dataset
        self.chosen: list = []
        self.deltas: list = []
        self.iters: list = []
        self.times: list = []
        self.rob = 0.0

    def record(self, edge, delta, iters, seconds: float) -> np.ndarray:
        """Record a committed edge and drop it from the search space
        (``greedy_krylov.m:68-71``); returns the mask of ``top`` kept."""
        i, j = int(edge[0]), int(edge[1])
        keep = ~((self.top[:, 0] == i) & (self.top[:, 1] == j))
        self.top = self.top[keep]
        self.chosen.append((i, j))
        self.deltas.append(float(delta))
        self.iters.append(int(iters))
        self.rob += float(delta)
        self.times.append(seconds)
        return keep

    def save(self):
        if self.checkpoint is not None:
            self.checkpoint.save(self.dataset, len(self.chosen), self.chosen,
                                 self.rob, extra={"deltas": self.deltas,
                                                  "iters": self.iters,
                                                  "times": self.times})

    def finish(self, F, fused_accepted: int = 0) -> GreedyResult:
        """The sweep's result; its checkpoint is cleared."""
        if self.checkpoint is not None:
            self.checkpoint.clear()
        mode = getattr(F.operator, "mode", None)
        name = type(F.operator).__name__
        return GreedyResult(
            edges=np.asarray(self.chosen, dtype=np.int64).reshape(-1, 2),
            rob_variation=self.rob, A_new=F.to_scipy(),
            per_step_delta=np.asarray(self.deltas),
            per_step_iters=np.asarray(self.iters),
            per_step_time=np.asarray(self.times),
            operator=f"{name}({mode})" if mode else name,
            fused_accepted=fused_accepted)


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
    rule = _ModeRule.of(mode, rescale)
    A = sp.csr_matrix(A)
    if (abs(A - A.T) > 1e-12).nnz:
        raise ValueError("adjacency matrix must be symmetric")
    if E is None:
        C = sp.coo_matrix(sp.tril(A))
        E = np.stack([C.row, C.col], axis=1)
    E = np.asarray(E, dtype=np.int64)
    if not rule.adds and A.nnz < 2 * k:
        raise ValueError("edges to be removed exceed edges in the network")
    F = _FrozenStructureMatrix(A, extra_edges=E if rule.adds else None,
                               dtype=float_dtype(dtype), device=device)
    score_kw = dict(sign=rule.sign, fun=fun, tol=tol, rescale=float(rescale),
                    schedule=schedule, shift=shift)
    # the whole candidate set is the window; its steps carry sweep id 0,
    # which no greedy_krylov sweep takes
    return _greedy_loop(F, _Tally(E, None, ""), len(E), min(k, len(E)),
                        rule, score_kw, sweep=0)


def choose_operator(A, top, Q: int, mode: str, backend: str,
                    device: torch.device):
    """The scored operator, as the JAX package chooses it
    (greedy.py:595-648), with "the device is CUDA" in place of "the backend
    is the TPU", without its cap on the tiles' bytes (the super-tile
    operator holds its values in CSR order, so its storage is the
    nonzeros), and with make mode on the banded operator too: super tiles
    for ``backend='bsr'``, or for ``'auto'`` at 2Q ≥ 256; otherwise the
    banded operator while the RCM band of A with make mode's candidate
    slots fits (``banded_spmm.banded_fits``, under A's own RCM order);
    otherwise COO. ``'coo'``, and ``'auto'`` off CUDA, take COO. Allocates
    nothing on the device.

    The JAX package takes the banded operator in break mode only. A make
    sweep's Q + k candidates join a few of the most central nodes, which a
    road graph's RCM order keeps near each other, so their slots leave its
    band within the kernel's windows, and the port takes K3 for make at
    2Q < 256 where the JAX package takes COO.

    Returns (kind, perm, A_aug): kind is 'bsr', 'banded' or 'coo'; A_aug is
    A with make mode's candidate slots as explicit zeros (None for COO)."""
    from ..ops.banded_spmm import banded_fits, rcm_permutation

    if backend == "coo" or (backend == "auto" and device.type != "cuda"):
        return "coo", None, None
    perm = rcm_permutation(A)
    A_aug = _with_zero_slots(A, top if _ModeRule.of(mode).adds else None)
    if backend == "bsr" or (backend == "auto" and 2 * Q >= 256):
        return "bsr", perm, A_aug
    if banded_fits(A_aug, perm):
        return "banded", perm, A_aug
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
    super-tile kernels K1/K2), 'banded' (RCM + banded-ELL kernel K3, make
    mode's candidate slots among its entries), 'sharded' (the
    row-partitioned operator over the ranks of ``mesh``, with the candidate
    batch split over a 'cands' axis; pass ``mesh`` or one is built over
    every rank of the process group),
    'sharded_bsr' (the same partitioning, each shard's product K1/K2 over
    its super-tiles, globally RCM-permuted), or 'auto' — on CUDA the JAX
    package's choice on the TPU but for make mode at 2Q < 256, which takes
    the banded operator where its band fits (:func:`choose_operator`), COO
    otherwise.
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
    rule = _ModeRule.of(mode, rescale)
    t_build = time.perf_counter()
    with tracing.span("sweep.build"):
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
        if not rule.adds and A.nnz < 2 * k:
            raise ValueError("edges to be removed exceed edges in the network")
        t_cands = time.perf_counter()
        with tracing.span("sweep.candidates", mode, Q + k):
            top = (find_top_missing_edges if rule.adds else find_top_edges)(
                A, centrality, Q + k, order)
        tracing.count("sweep.candidates_s", time.perf_counter() - t_cands)

        extra = top if rule.adds else None
        if backend == "sharded":
            F = _ShardedFrozenMatrix(A, extra, dtype=dtype, mesh=mesh,
                                     device=dev)
        elif backend == "sharded_bsr":
            F = _ShardedBsrFrozenMatrix(A, extra, dtype=dtype, mesh=mesh,
                                        device=dev)
        else:
            F = _single_device_operator(A, top, Q, rule, backend, dtype, dev)
    tracing.count("sweep.build_s", time.perf_counter() - t_build)
    # entries the operator holds beyond A's: make mode's candidate slots
    tracing.count("sweep.slots", F.operator.nnz - A.nnz)
    tracing.count("spmm.operator_bytes", tracing.tensor_bytes(F.operator))
    # entries and units of the runs the kernels split (super-tile operator)
    for name in ("split_entries", "split_units"):
        tracing.count(f"spmm.{name}", getattr(F.operator, name, 0))
    sweep = tracing.count("sweep.builds")  # the sweep's id in the process
    score_kw = dict(sign=rule.sign, fun=fun, tol=tol, rescale=float(rescale),
                    schedule=schedule, shift=shift)
    tally = _Tally(top, checkpoint, dataset)

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
        return _greedy_loop_fused(F, tally, Q, k, rule, score_kw,
                                  R=fused_steps, sweep=sweep)
    return _greedy_loop(F, tally, Q, k, rule, score_kw,
                        rescore_every=rescore_every,
                        rescore_frac=rescore_frac, sweep=sweep)


def _single_device_operator(A, top, Q: int, rule: _ModeRule, backend: str,
                            dtype, dev):
    """The adapter over the operator :func:`choose_operator` picks, built
    inside the span ``kr:sweep.operator|kind|slots`` (slots: the explicit
    zeros make mode adds, both triangles of each candidate)."""
    kind, perm, A_aug = choose_operator(A, top, Q, rule.mode, backend, dev)
    with tracing.span("sweep.operator", kind,
                      2 * len(top) if rule.adds else 0):
        if kind == "coo":
            return _FrozenStructureMatrix(A, top if rule.adds else None,
                                          dtype=dtype, device=dev)
        Ap, pinv = _relabel(A_aug, perm)  # COO space: keeps the slots
        if kind == "bsr":
            from ..ops.bsr_super import SuperBsrOperator

            return _BsrAdapter(SuperBsrOperator(Ap, dtype=dtype, device=dev),
                               pinv)
        from ..ops.banded_spmm import BandedEllOperator

        return _BandedAdapter(BandedEllOperator(Ap, dtype=dtype, device=dev),
                              pinv)


def _replay_checkpoint(F, rule: _ModeRule, tally: _Tally) -> int:
    """Resume from the tally's checkpoint, for the per-step and fused loops
    alike: re-apply its edits, shrink the search space, restore the running
    tallies. Returns the step to resume at (0 without a checkpoint)."""
    state = None if tally.checkpoint is None \
        else tally.checkpoint.load(tally.dataset)
    if state is None:
        return 0
    for i, j in state["edges"]:
        F.set_edge(int(i), int(j), rule.commit)
        tally.record((i, j), 0.0, 0, 0.0)  # its figures are restored below
    step = state["step"]
    tally.rob = state["rob_variation"]
    tally.deltas = list(state["extra"].get("deltas", [0.0] * step))
    tally.iters = list(state["extra"].get("iters", [0] * step))
    tally.times = list(state["extra"].get("times", [0.0] * step))
    return step


def _score(F, E: np.ndarray, score_kw: dict):
    """One scoring call over the candidate edges E (original labels): their
    Δtrace (a writable copy) and Krylov steps, on the host."""
    res = trace_fun_update_edges(F.operator, F.map_edges(E), **score_kw)
    return _np(res.delta).copy(), _np(res.iters)


def _greedy_loop_fused(F, tally: _Tally, Q, k, rule: _ModeRule,
                       score_kw: dict, R=8, *, sweep: int):
    """Fused-block budget loop: R greedy steps per block (:mod:`.fused`, the
    reference hot loop ``krylov_miobi.m:112-137``). A step whose window has
    convergence stragglers beyond the fused budget is replayed through the
    accurate per-step lane, so results keep the full 100-step guarantee."""
    from ..funm.scalar import get_fun
    from .fused import fused_greedy_block

    fun_name = get_fun(score_kw["fun"]).name
    step = _replay_checkpoint(F, rule, tally)
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
            with tracing.span("step", sweep, step):  # the whole block
                t0 = time.perf_counter()
                nC = min(len(tally.top), nC_pad)
                table = tally.top[:nC]
                if nC_pad > nC:
                    table = np.concatenate(
                        [table, np.repeat(table[:1], nC_pad - nC, axis=0)])
                alive = np.zeros(nC_pad, bool)
                alive[:nC] = True
                mapped = np.asarray(F.map_edges(table))
                slots = F.fused_slots(mapped)
                op, vals = F.fused_state()
                vals_f, _, outs = fused_greedy_block(
                    op, vals, mapped, slots, alive, rule.commit,
                    score_kw["tol"], score_kw["shift"], rule.sign,
                    score_kw["rescale"], rebuild=F.fused_rebuild, Q=Q, R=R,
                    mode=rule.mode, fun_name=fun_name)
                hs, dls, its, oks, nfs = (_np(t) for t in outs)
                while acc < want and oks[acc]:
                    acc += 1
                if np.any(nfs[:max(acc, 1)]):
                    warnings.warn(
                        f"fused greedy {tally.dataset}: non-finite candidate "
                        f"scores in steps {step}..{step + acc} (excluded "
                        "from the argmin)", RuntimeWarning)
                t_per = (time.perf_counter() - t0) / max(acc, 1)
                for r in range(acc):
                    tally.record(table[hs[r]], dls[r], its[r], t_per)
                if acc == R:
                    F.set_fused_vals(vals_f)
                elif acc > 0:
                    # the block worked on a copy: commit the accepted winners
                    # into the pre-block storage, in place
                    idxs = slots[hs[:acc]].reshape(-1)
                    vals[torch.as_tensor(idxs, device=vals.device)] = \
                        rule.commit
                    F.set_fused_vals(vals)
                step += acc
                fused_accepted += acc
            if acc:
                tally.save()
            consec_bad = consec_bad + 1 if acc == 0 else 0
            if consec_bad >= 2:
                devolved = True
                warnings.warn(
                    f"fused greedy {tally.dataset}: convergence stragglers "
                    f"outlive the fused budget persistently at step {step};"
                    " devolving to per-step scoring for the remaining "
                    "budget", RuntimeWarning)
        if devolved or (acc < want and not oks[acc]):
            # straggler (or no finite score) in this step's window: score it
            # through the accurate per-step lane
            with tracing.span("step", sweep, step):
                t1 = time.perf_counter()
                E = tally.top[:Q]
                scores, iters = _score(F, E, score_kw)
                h = rule.pick(scores, step, tally.dataset)
                F.set_edge(int(E[h, 0]), int(E[h, 1]), rule.commit)
                tally.record(E[h], scores[h], iters[h],
                             time.perf_counter() - t1)
                step += 1
            tally.save()
    return tally.finish(F, fused_accepted)


def _greedy_loop(F, tally: _Tally, Q, k, rule: _ModeRule, score_kw: dict,
                 rescore_every=1, rescore_frac=0.2, *, sweep: int):
    """The per-step budget loop: score the surviving Q candidates in one
    batched call, commit the best edge, shrink the search space
    (``greedy_krylov.m:64-93``).

    ``rescore_every`` > 1 reuses stale scores between full rescores: a
    fixed-size fresh subset (the best ``rescore_frac`` by stale score, every
    candidate incident to the last edit, never-scored entrants) is scored
    each step, and a stale would-be winner forces a full rescore, so the
    committed pick always carries a fresh score. 1 is the reference
    protocol."""
    start_step = _replay_checkpoint(F, rule, tally)
    scores_all = np.full(len(tally.top), np.nan)  # stale scores, as top
    iters_all = np.zeros(len(tally.top), np.int64)
    last_edit = None
    for step in range(start_step, k):
        with tracing.span("step", sweep, step):
            t_step = time.perf_counter()
            E = tally.top[:Q]
            nE = len(E)
            h = None
            if (rescore_every > 1 and last_edit is not None
                    and (step - start_step) % rescore_every):
                stale = scores_all[:nE]
                # fixed-size fresh subset, padded to a multiple of 64
                T_fix = min(nE, max(64, -(-int(nE * rescore_frac) // 64) * 64))
                rank_key = np.where(np.isnan(stale), rule.worst,
                                    -rule.sign * stale)
                order = np.argsort(rank_key, kind="stable")
                sel_mask = np.zeros(nE, bool)
                sel_mask[order[:T_fix]] = True
                sel_mask |= np.isnan(stale)
                li, lj = last_edit
                sel_mask |= ((E[:, 0] == li) | (E[:, 1] == li)
                             | (E[:, 0] == lj) | (E[:, 1] == lj))
                sel = np.nonzero(sel_mask)[0]
                want = min(nE, -(-len(sel) // 64) * 64)
                if len(sel) < want:  # fill with next-best stale candidates
                    extra = order[~sel_mask[order]][: want - len(sel)]
                    sel = np.sort(np.concatenate([sel, extra]))
                scores, iters_vec = stale.copy(), iters_all[:nE].copy()
                scores[sel], iters_vec[sel] = _score(F, E[sel], score_kw)
                h = rule.pick(scores, step, tally.dataset)
                if not sel_mask[h]:
                    h = None  # stale would-be winner: rescore everything
            if h is None:
                scores, iters_vec = _score(F, E, score_kw)
                h = rule.pick(scores, step, tally.dataset)
            # scores the pick sent to worst persist as NaN: they re-enter
            # the refresh set next step instead of staying excluded until
            # the next full rescore
            scores_all[:nE] = scores
            scores_all[:nE][~np.isfinite(scores)] = np.nan
            iters_all[:nE] = iters_vec
            last_edit = E[h]
            F.set_edge(int(E[h, 0]), int(E[h, 1]), rule.commit)
            keep = tally.record(E[h], scores[h], iters_vec[h],
                                time.perf_counter() - t_step)
            scores_all, iters_all = scores_all[keep], iters_all[keep]
        tally.save()
    return tally.finish(F)
