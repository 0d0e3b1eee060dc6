"""Row-partitioned sparse operators over a mesh of ranks — port of
``krylov_robustness_tpu/parallel/spmm_sharded.py``.

The matrix is split into row blocks, one per rank along the mesh's ``rows``
axis, and each rank stores only its own block:

* :class:`RowShardedMatrix` — layout ``coo``: (local_row, global_col, val)
  padded to a uniform nnz per shard, filled as the JAX package fills them
  (so a flat slot position shard·nnz_shard + slot means the same in both);
  local product gather + ``index_add_``. Layout ``ell``: K column slots per
  local row (:func:`pack_ell`, the port's numpy packing, equal to the JAX
  package's native ``pack_ell``); local product K gathers.
* :class:`BsrRowShardedMatrix` — each block packed into 512 × 256
  super-tiles (the JAX package's packing, array for array), the local
  product the hand-written Hopper kernels K1 (``bf16x2``/``bf16x3``) or K2
  (``f32`` in f32 or f64) of ``ops/bsr_super.py``, launched on the block's
  own rows over the local x (diagonal tiles) and over the gathered x (the
  other tiles). Their plain versions serve CPU tensors only.

The sharded-in / sharded-out product :meth:`spmm_sharded` takes the rank's
row block of x (on a 2-D mesh its column block too) and returns its row
block of y. It issues the ``all_gather`` of x asynchronously first, runs the
pass over the entries whose columns lie in the rank's own rows on the local
x while the collective is in flight, then waits and runs the other entries
on the gathered x — the torch form of the JAX kernel's "issue the collective
first" (``spmm_sharded.py:196-205`` there).

The outer ``matmul``/``@`` API takes and returns *replicated* (n, b) blocks,
as the JAX package's does, so the Krylov, funm and greedy layers run
unchanged — and redundantly, on every rank: each rank computes its row
block (and, on a ``cands`` axis, its column block) from the replicated x and
all-gathers y. The host plan builders read the whole matrix's COO triple
through :meth:`RowShardedMatrix.host_coo` (the JAX operator's global
``rows``/``cols``/``vals``), which ``CooMatrix`` shares.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..ops import bsr_super, row_gather
from ..utils import tracing
from ..utils.device import float_dtype
from .mesh import Mesh, row_sharded


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _gather(x: torch.Tensor, group, dim: int = 0, async_op: bool = False):
    """Equal blocks of every rank of ``group`` concatenated along ``dim``
    (the identity without a group). With ``async_op`` the collective is
    issued and a function is returned that waits for it and concatenates."""
    if group is None:
        return (lambda: x) if async_op else x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    work = dist.all_gather(parts, x, group=group, async_op=async_op)
    if not async_op:
        return torch.cat(parts, dim)

    def wait():
        work.wait()
        return torch.cat(parts, dim)
    return wait


def _gather_ragged(x: torch.Tensor, counts, group) -> torch.Tensor:
    """Blocks of ``counts[d]`` rows from rank d of ``group``, concatenated
    (x is this rank's block)."""
    if group is None:
        return x
    width = max(int(max(counts)), 1)
    pad = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    pad[:x.shape[0]] = x
    parts = _gather(pad, group).split(width)
    return torch.cat([p[:int(c)] for p, c in zip(parts, counts)])


def psum_dot(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """Inner product of row-sharded blocks: Σ a·b here, all-reduced over
    ``group`` (a mesh axis's group; None for one rank)."""
    s = torch.sum(a * b)
    if group is not None:
        dist.all_reduce(s, group=group)
    return s


def pack_ell(A_csr, n_pad: int, K: int):
    """CSR → (cols (n_pad, K) int32, vals (n_pad, K) f64): slot k of row i
    holds the k-th entry of row i in sorted CSR order; padding slots hold
    column 0 and value 0. The packing of the JAX package's native
    ``pack_ell`` (``native/graphpack.py:68``), in numpy."""
    A = sp.csr_matrix(A_csr)
    A.sort_indices()
    deg = np.diff(A.indptr)
    if deg.max(initial=0) > K:
        raise ValueError("K smaller than max degree")
    rows = np.repeat(np.arange(A.shape[0]), deg)
    ks = np.arange(A.nnz) - A.indptr[rows]
    cols = np.zeros((n_pad, K), np.int32)
    vals = np.zeros((n_pad, K), np.float64)
    cols[rows, ks] = A.indices
    vals[rows, ks] = A.data
    return cols, vals


class _RowSharded:
    """The replicated outer API shared by the two operators. A subclass
    provides ``mesh``, ``n``, ``n_orig``, ``axis``, ``batch_axis`` and
    ``_product(x_local, x_full)``: its rank's row block of y from its row
    block of x and a function that returns the full x (its column block)."""

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.mesh.shape[self.axis]

    def _col_block(self, b: int) -> slice:
        """The columns of a (n, b) block this rank computes: all of them, or
        its share along the ``cands`` axis."""
        if self.batch_axis is None:
            return slice(None)
        C = self.mesh.shape[self.batch_axis]
        if b % C:
            raise ValueError(f"{b} columns do not split over the "
                             f"{self.batch_axis!r} axis of {C} ranks")
        c = self.mesh.index(self.batch_axis)
        return slice(c * (b // C), (c + 1) * (b // C))

    def spmm_sharded(self, x_local: torch.Tensor) -> torch.Tensor:
        """x (rps, b) — this rank's row block (and column block on a
        ``cands`` axis) — → its row block of y: the all-gather of x is
        issued first, the pass over the local columns runs while it is in
        flight."""
        gathered = _gather(x_local, self.mesh.group(self.axis),
                           async_op=True)
        return self._product(x_local, gathered)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """Replicated (n, b) or (n,) in, replicated out: this rank's block
        from the x it already holds (no gather of x), then y all-gathered
        over the rows axis (and the ``cands`` axis)."""
        with tracing.spmm_span(self, x):
            squeeze = x.ndim == 1
            if squeeze:
                x = x[:, None]
            n_in, b = x.shape
            if n_in != self.n:
                x = torch.nn.functional.pad(x, (0, 0, 0, self.n - n_in))
            xc = x[:, self._col_block(b)]
            rows = row_sharded(self.mesh, self.axis, n=self.n)
            y = self._product(xc[rows], lambda: xc)
            y = _gather(y, self.mesh.group(self.axis))
            if self.batch_axis is not None:
                y = _gather(y, self.mesh.group(self.batch_axis), dim=1)
            y = y[:n_in]
            return y[:, 0] if squeeze else y

    def __matmul__(self, x):
        return self.matmul(x)


@dataclasses.dataclass(eq=False)
class RowShardedMatrix(_RowSharded):
    """This rank's row block of a row-partitioned matrix. Layout ``coo``:
    ``rows_local``/``cols`` (nnz_shard,) and ``vals`` (nnz_shard + 1,) — the
    shard's slots, padded with val 0 at (local row 0, column 0), and one
    scratch slot that no product reads (where a value edit of an entry held
    by another rank lands, so the fused lane's scatter needs no branch).
    Layout ``ell``: ``cols``/``vals`` (rps, K) and an empty ``rows_local``."""

    mesh: Mesh
    rows_local: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n: int  # global rows, padded to a multiple of the rows axis
    n_orig: int
    nnz: int
    axis: str = "rows"
    batch_axis: str | None = None
    layout: str = "coo"

    def __post_init__(self):
        self._host_coo = None  # (vals' version, the gathered triple)
        lo = self.mesh.index(self.axis) * self.rows_per_shard
        # entries whose column lies in this rank's rows: the pass that needs
        # no gathered x
        self._local = (self.cols >= lo) & (self.cols < lo +
                                           self.rows_per_shard)
        self._cols_l = torch.clamp(self.cols - lo, 0,
                                   self.rows_per_shard - 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz_shard(self) -> int:
        return self.rows_local.shape[0]

    @property
    def rows(self) -> torch.Tensor:
        """Global row ids of this rank's slots (COO layout); the whole
        matrix's are :meth:`host_coo`'s."""
        return self.rows_local + self.mesh.index(self.axis) * \
            self.rows_per_shard

    @staticmethod
    def from_scipy(A, mesh: Mesh, dtype=torch.float64, axis: str = "rows",
                   batch_axis: str | None = None, layout: str = "coo"):
        A = sp.csr_matrix(A)
        n_orig = A.shape[0]
        D, d = mesh.shape[axis], mesh.index(axis)
        n = _round_up(n_orig, D)
        rps = n // D
        dev, dtype = mesh.device, float_dtype(dtype)
        if layout == "ell":
            K = max(int(np.diff(A.indptr).max()), 1)
            cols, vals = pack_ell(A[d * rps:min((d + 1) * rps, n_orig), :],
                                  rps, K)
            return RowShardedMatrix(
                mesh=mesh, rows_local=torch.zeros(0, dtype=torch.int64,
                                                  device=dev),
                cols=torch.as_tensor(cols.astype(np.int64), device=dev),
                vals=torch.as_tensor(vals, device=dev).to(dtype),
                n=n, n_orig=n_orig, nnz=int(A.nnz), axis=axis,
                batch_axis=batch_axis, layout="ell")
        if layout != "coo":
            raise ValueError(f"layout must be 'coo' or 'ell', got {layout!r}")
        C = sp.coo_matrix(A)
        order = np.argsort(C.row, kind="stable")
        rows, cols, vals = C.row[order], C.col[order], C.data[order]
        shard_of = rows // rps
        counts = np.bincount(shard_of, minlength=D)
        nnz_shard = max(int(counts.max()), 1)
        # entries are row-sorted, so each shard's are contiguous; slot =
        # position within the shard's run
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        mine = shard_of == d
        slot = np.arange(len(rows))[mine] - starts[d]
        r_l = np.zeros(nnz_shard, np.int64)
        c_l = np.zeros(nnz_shard, np.int64)
        v_l = np.zeros(nnz_shard + 1, np.float64)
        r_l[slot] = rows[mine] - d * rps
        c_l[slot] = cols[mine]
        v_l[slot] = vals[mine]
        return RowShardedMatrix(
            mesh=mesh, rows_local=torch.as_tensor(r_l, device=dev),
            cols=torch.as_tensor(c_l, device=dev),
            vals=torch.as_tensor(v_l, device=dev).to(dtype),
            n=n, n_orig=n_orig, nnz=int(A.nnz), axis=axis,
            batch_axis=batch_axis)

    def local_positions(self, positions) -> np.ndarray:
        """Global flat slot positions (shard·nnz_shard + slot) → positions in
        this rank's ``vals``; another rank's slot maps to the scratch
        slot."""
        p = np.asarray(positions, np.int64) - \
            self.mesh.index(self.axis) * self.nnz_shard
        return np.where((p >= 0) & (p < self.nnz_shard), p, self.nnz_shard)

    def _product(self, x_local: torch.Tensor, x_full) -> torch.Tensor:
        rps, b = x_local.shape
        loc = self._local
        if self.layout == "ell":
            vals = self.vals.to(x_local.dtype)
            y = torch.zeros((rps, b), dtype=x_local.dtype,
                            device=x_local.device)
            for k in range(self.cols.shape[1]):
                y = y + torch.where(loc[:, k], vals[:, k], 0)[:, None] * \
                    x_local[self._cols_l[:, k]]
            xf = x_full()
            for k in range(self.cols.shape[1]):
                y = y + torch.where(loc[:, k], 0, vals[:, k])[:, None] * \
                    xf[self.cols[:, k]]
            return y
        vals = self.vals[:self.nnz_shard].to(x_local.dtype)
        diag = torch.where(loc, vals, 0)[:, None] * x_local[self._cols_l]
        y = torch.zeros((rps, b), dtype=x_local.dtype, device=x_local.device)
        y.index_add_(0, self.rows_local, diag)
        off = torch.where(loc, 0, vals)[:, None] * x_full()[self.cols]
        return y + torch.zeros_like(y).index_add_(0, self.rows_local, off)

    def gather_coo(self):
        """(rows, cols, vals) of every shard's slots as numpy, global ids
        (COO layout; padding slots carry val 0 at their shard's first row)."""
        if self.layout != "coo":
            raise NotImplementedError("gather_coo() requires the COO layout")
        g = self.mesh.group(self.axis)
        return tuple(_gather(t, g).cpu().numpy() for t in (
            self.rows, self.cols, self.vals[:self.nnz_shard]))

    def host_coo(self):
        """The whole matrix's COO triple as numpy on every rank — the view
        that the host plan builders read (``funm.expmv``, the centralities,
        the norms), which the JAX operator's global ``rows``/``cols``/``vals``
        give there: :meth:`gather_coo`, a collective over the rows axis, kept
        until ``vals`` is next edited in place (its version counter, which
        every rank advances alike) or replaced."""
        if self.layout != "coo":
            raise NotImplementedError(
                "host_coo() requires the COO layout: an 'ell' shard keeps no "
                "COO slots (nor does the JAX package's)")
        key = self.vals._version
        if self._host_coo is None or self._host_coo[0] != key:
            self._host_coo = (key, self.gather_coo())
        return self._host_coo[1]

    def todense(self) -> torch.Tensor:
        """Replicated dense (n, n) view (COO layout): each rank's row block,
        all-gathered. Enables the exact dense path of
        ``updates.trace_update`` below its n ≤ 130 cutoff, as on the COO
        backend."""
        if self.layout != "coo":
            raise NotImplementedError("todense() requires the COO layout")
        block = torch.zeros((self.rows_per_shard, self.n), dtype=self.dtype,
                            device=self.device)
        block.index_put_((self.rows_local, self.cols),
                         self.vals[:self.nnz_shard], accumulate=True)
        return _gather(block, self.mesh.group(self.axis))


class BsrRowShardedMatrix(_RowSharded):
    """This rank's row block of a row-partitioned matrix packed into
    super-tiles, its local product the Hopper kernels K1/K2.

    The packing is the JAX package's (``spmm_sharded.py:337-452`` there):
    rows pad to a multiple of D (of D·tile_c with ``overlap``, so column
    slabs align with shards); each shard's block splits into tiles
    [0, n_diag) over its own column window (slab indices window-relative)
    and tiles [n_diag, ntile_u) over all columns, tile counts padded to the
    largest shard's with all-zero tiles that continue the last super-row.
    ``atiles`` (ntile_u, tile_r, tile_c) holds this rank's tiles, a view of
    ``storage`` (one scratch element past them, where an edit of another
    rank's entry lands); ``slab``/``sup``/``start`` its tiles' metadata;
    ``entry_positions()``/``entry_rc()`` every entry's global flat position
    and (row, col), shard-major, as in JAX.

    Two row indices into the flattened tiles (``ops/row_gather.py``) carry
    the kernels: the diagonal tiles' over the local x (rps rows, columns
    window-relative) and the other tiles' over the gathered x (n rows); both
    write the block's rps rows, and no entry points into a pad tile.
    """

    # the JAX dataclass's defaulted fields (every instance sets its own)
    axis: str = "rows"
    batch_axis: str | None = None
    mode: str = "f32"  # 'f32' | 'bf16x2' | 'bf16x3' (storage and kernel)
    dtype: torch.dtype = torch.float32  # compute dtype of the product
    n_diag: int = 0  # tiles [0, n_diag) read the local x; 0: no split

    def __init__(self, *, mesh, storage, meta, entry_flat, entry_rc, n,
                 n_orig, nnz, m_pad, n_pad, n_diag, tile, mode, dtype,
                 axis="rows", batch_axis=None):
        if mode not in bsr_super.MODES:
            raise ValueError(f"mode must be one of {bsr_super.MODES}")
        tr, tc = tile
        self.mesh, self.axis, self.batch_axis = mesh, axis, batch_axis
        self.n, self.n_orig, self.nnz = int(n), int(n_orig), int(nnz)
        self.m_pad, self.n_pad, self.n_diag = int(m_pad), int(n_pad), \
            int(n_diag)
        self.mode, self.dtype = mode, float_dtype(dtype)
        self.slab, self.sup, self.start = (np.asarray(a, np.int32)
                                           for a in meta)
        ntile = len(self.slab)
        self._tile_size = tr * tc
        self._S = ntile * tr * tc
        if storage.shape != (self._S + 1,):
            raise ValueError(f"storage of {tuple(storage.shape)} elements, "
                             f"not {ntile} tiles and a scratch element")
        self.storage = storage
        self.atiles = storage[:self._S].view(ntile, tr, tc)
        dev = storage.device
        self._slab_t = torch.as_tensor(self.slab, device=dev)
        self._sup_t = torch.as_tensor(self.sup, device=dev)
        self._entry_flat = np.asarray(entry_flat, np.int64)
        self._entry_rc = np.asarray(entry_rc, np.int64).reshape(-1, 2)
        D, me = mesh.shape[axis], mesh.index(axis)
        owner = self._entry_flat // self._S
        self._counts = np.bincount(owner, minlength=D)
        own = np.nonzero(owner == me)[0]
        self._own_local = self._entry_flat[own] - me * self._S
        rps = self.rows_per_shard
        rows = self._entry_rc[own, 0] - me * rps
        cols = self._entry_rc[own, 1]
        self._index = {}
        if self.n_diag:
            diag = self._own_local // self._tile_size < self.n_diag
            self._index["diag"] = row_gather.row_index(
                (rows[diag], cols[diag] - me * rps), self._own_local[diag],
                rps, self._S, dev, n_cols=rps)
            self._index["off"] = row_gather.row_index(
                (rows[~diag], cols[~diag]), self._own_local[~diag], rps,
                self._S, dev, n_cols=self.n)
        else:
            self._index["all"] = row_gather.row_index(
                (rows, cols), self._own_local, rps, self._S, dev,
                n_cols=self.n)

    @property
    def shape(self):
        return (self.n_orig, self.n_orig)

    @property
    def device(self) -> torch.device:
        return self.storage.device

    @staticmethod
    def from_scipy(A, mesh: Mesh, dtype=torch.float32, axis: str = "rows",
                   batch_axis: str | None = None, tile=(512, 256),
                   mode: str = "auto", overlap: bool = True):
        A = sp.csr_matrix(A)
        A.sort_indices()
        n_orig = A.shape[0]
        D, me = mesh.shape[axis], mesh.index(axis)
        tr, tc = tile
        overlap = bool(overlap) and D > 1
        n = _round_up(n_orig, D * tc if overlap else D)
        rps = n // D
        Ap = sp.csr_matrix(
            (A.data, A.indices,
             np.concatenate([A.indptr, np.full(n - n_orig, A.indptr[-1])])),
            shape=(n, n))

        def blocks(d):
            """Shard d's row block as (block, column offset) pairs: the
            (diag, off) split by column locality, diag columns
            window-relative, or the whole block."""
            blk = Ap[d * rps:(d + 1) * rps, :]
            if not overlap:
                return [(blk, 0)]
            C = sp.coo_matrix(blk)
            lo = d * rps
            loc = (C.col >= lo) & (C.col < lo + rps)
            return [(sp.coo_matrix((C.data[loc], (C.row[loc],
                                                  C.col[loc] - lo)),
                                   shape=(rps, rps)), lo),
                    (sp.coo_matrix((C.data[~loc], (C.row[~loc],
                                                   C.col[~loc])),
                                   shape=(rps, n)), 0)]

        # every shard's layout (host metadata only: its tiles are filled on
        # the rank that holds them)
        packs = []
        for d in range(D):
            packs.append([(bsr_super.super_layout(
                b, tr, tc, *bsr_super.block_pads(*b.shape, tr, tc)),
                bsr_super.block_pads(*b.shape, tr, tc), off)
                for b, off in blocks(d)])
        ntd_u = max(len(p[0][0][1][0]) for p in packs)
        ntile_u = ntd_u + (max(len(p[1][0][1][0]) for p in packs)
                           if overlap else 0)
        m_pad = packs[0][0][1][0]
        n_pad = packs[0][-1][1][1]
        # pad tiles (all zero, start 0) continue the last super-row, as in
        # the JAX packing (a TPU kernel invariant; the row gather never
        # reads them)
        slab = np.zeros(ntile_u, np.int32)
        sup = np.full(ntile_u, m_pad // tr - 1, np.int32)
        start = np.zeros(ntile_u, np.int32)
        flat_parts, rc_parts, data_parts = [], [], []
        for d in range(D):
            for p, ((coo, (sl, su, st), et, eo), _, off) in \
                    enumerate(packs[d]):
                base = ntd_u if p else 0
                if d == me:
                    k = len(sl)
                    slab[base:base + k] = sl
                    sup[base:base + k] = su
                    start[base:base + k] = st
                    data_parts.append(coo.data)
                flat_parts.append((d * ntile_u + base + et) * (tr * tc) + eo)
                rc_parts.append(np.stack([coo.row + d * rps, coo.col + off],
                                         axis=1))
        entry_flat = np.concatenate(flat_parts)
        if mode == "auto":
            vals = torch.as_tensor(A.data.astype(np.float64))
            exact = bool(torch.all(vals.to(torch.bfloat16).double() == vals))
            mode = "bf16x2" if (exact and dtype == torch.float32) else "f32"
        store = torch.bfloat16 if mode.startswith("bf16x") else \
            float_dtype(dtype)
        S = ntile_u * tr * tc
        dev = mesh.device
        storage = torch.zeros(S + 1, dtype=store, device=dev)
        own = (entry_flat >= me * S) & (entry_flat < (me + 1) * S)
        storage[torch.as_tensor(entry_flat[own] - me * S, device=dev)] = \
            torch.as_tensor(np.concatenate(data_parts), device=dev).to(store)
        return BsrRowShardedMatrix(
            mesh=mesh, storage=storage, meta=(slab, sup, start),
            entry_flat=entry_flat, entry_rc=np.concatenate(rc_parts),
            n=n, n_orig=n_orig, nnz=int(A.nnz), m_pad=m_pad, n_pad=n_pad,
            n_diag=ntd_u if overlap else 0, tile=tile, mode=mode,
            dtype=dtype, axis=axis, batch_axis=batch_axis)

    def with_storage(self, storage: torch.Tensor) -> "BsrRowShardedMatrix":
        """The same operator over replacement storage (no copy): it shares
        the packing and the row indices."""
        if storage.shape != self.storage.shape or \
                storage.dtype != self.storage.dtype:
            raise ValueError("replacement storage must match shape and dtype")
        obj = object.__new__(type(self))
        obj.__dict__.update(self.__dict__)
        obj.storage = storage
        obj.atiles = storage[:self._S].view(self.atiles.shape)
        return obj

    # -- frozen-structure value edits ---------------------------------------
    def entry_positions(self) -> np.ndarray:
        """Global flat tile-storage position per entry (shard-major, each
        shard's diagonal entries then the others, CSR order within each;
        rows/cols via :meth:`entry_rc`)."""
        return self._entry_flat

    def entry_rc(self) -> np.ndarray:
        return self._entry_rc

    def local_positions(self, positions) -> np.ndarray:
        """Global flat positions → positions in this rank's ``storage``;
        another rank's position maps to the scratch element."""
        p = np.asarray(positions, np.int64) - \
            self.mesh.index(self.axis) * self._S
        return np.where((p >= 0) & (p < self._S), p, self._S)

    def set_flat(self, positions, value: float) -> None:
        """Set the entries at global flat ``positions`` to ``value`` (those
        this rank holds; the others on their ranks)."""
        idx = torch.as_tensor(self.local_positions(positions),
                              device=self.device)
        self.storage[idx] = value

    def entry_values(self) -> np.ndarray:
        """Every entry's value in the compute dtype, in ``entry_rc`` order
        (each rank's gathered over the rows axis)."""
        own = self.storage[torch.as_tensor(self._own_local,
                                           device=self.device)]
        return _gather_ragged(own.to(self.dtype), self._counts,
                              self.mesh.group(self.axis)).cpu().numpy()

    # -- the sharded-in / sharded-out product -------------------------------
    def _terms(self) -> int:
        return int(self.mode[-1]) if self.mode.startswith("bf16x") else 0

    def local_pass(self, which: str, x: torch.Tensor) -> torch.Tensor:
        """One pass over this rank's tiles: ``'diag'`` (x = the local rps
        rows), ``'off'`` (x = the gathered n rows) or ``'all'`` (no overlap
        split; x = the gathered rows); y (rps, b) in the compute dtype. A
        CPU tensor runs the plain version, a CUDA tensor K1/K2 or raises."""
        terms = self._terms()
        if which not in self._index:
            raise ValueError(f"no {which!r} pass in this operator")
        if x.device.type == "cpu":
            return self.local_pass_plain(which, x)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        row_ptr, cols, val_off = self._index[which]
        if terms:
            return bsr_super.tile_spmm_bf16(row_ptr, cols, val_off,
                                            self.atiles, x, terms)
        return bsr_super.tile_spmm_full(row_ptr, cols, val_off, self.atiles,
                                        x)

    def local_pass_plain(self, which: str, x: torch.Tensor) -> torch.Tensor:
        """:meth:`local_pass` through the plain version on any device (the
        kernels' reference): batched tile products and ``index_add_``."""
        terms = self._terms()
        _, tr, tc = self.atiles.shape
        nd = self.n_diag
        sl = {"diag": slice(0, nd), "off": slice(nd, None),
              "all": slice(None)}[which]
        n_pad = (_round_up(max(self.rows_per_shard, tc), tc)
                 if which == "diag" else self.n_pad)
        args = (self.atiles[sl], self._slab_t[sl], self._sup_t[sl], x, n_pad)
        kw = dict(m_pad=self.m_pad, m=self.rows_per_shard)
        if terms:
            return bsr_super.tile_spmm_bf16_plain(*args, terms, **kw)
        return bsr_super.tile_spmm_full_plain(*args, **kw)

    def _product(self, x_local: torch.Tensor, x_full) -> torch.Tensor:
        compute = torch.float32 if self._terms() else self.dtype
        if self.n_diag:
            y = self.local_pass("diag", x_local.to(compute).contiguous())
            y = y + self.local_pass("off",
                                    x_full().to(compute).contiguous())
        else:
            y = self.local_pass("all", x_full().to(compute).contiguous())
        return y.to(x_local.dtype)
