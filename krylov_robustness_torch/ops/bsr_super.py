"""Super-tile SpMM operator with hand-written Hopper kernels.

Port of ``krylov_robustness_tpu/ops/pallas_bsr_super.py``. The JAX package
packs the (RCM-permuted) matrix into dense ``tile_r × tile_c`` super-tiles
(default 512 × 256), one per (super-row, column-slab) pair that holds an
entry; :func:`pack_bsr_super` and :func:`super_layout` reproduce that packing
(``atiles``, ``slab``/``sup``/``start``, the entry maps) for the parity tests,
the interop and the row-sharded operator (``parallel/spmm_sharded.py``).

Two kernels in ``csrc/bsr_super.cu`` compute ``A @ x``. Both are row gathers
(``csrc/row_gather.cuh``) over a CSR row index (``row_ptr``, ``cols`` and
``val_off``, each entry's offset in a flat value storage): no fill is
computed. :class:`SuperBsrOperator` holds its values in one array in CSR
order, so its ``val_off`` is each entry's own position and no tile is
allocated: its storage is the nonzeros, whatever its tiles would have taken
(a hub graph at soc-Epinions1's scale packs into ~9 GB of bf16 tiles for
0.8 M values). A row-sharded block reads its flattened tiles.

* K1 (``tile_spmm_bf16``) replaces ``_kernel_bf16`` — modes
  ``bf16x2``/``bf16x3``: A stored in bf16 (bf16-exact 0/±1 adjacency); each
  gathered f32 x value is split in registers into ``terms`` bf16 parts, each
  part's products summed in f32 on their own.
* K2 (``tile_spmm_full``) replaces ``_kernel_f32`` — mode ``f32`` (f32 or f64
  storage): one DFMA an entry into an f64 sum, never TF32; in f32 each sum is
  rounded to f32 once, at the store.

Beside each kernel are two plain torch versions: over the row index
(``csr_spmm_*_plain``, a row gather with ``index_add_``, the operator's CPU
path and the kernels' reference on the card) and over the tiles
(``tile_spmm_*_plain``, a batched tile product, the row-sharded block's CPU
path). :meth:`SuperBsrOperator.matmul` runs the plain version for CPU
tensors only; a CUDA tensor launches the kernel or raises. The kernels are
built with ``nvcc`` at first use (:mod:`.cuda_build`) and bound with
``ctypes``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import tracing
from ..utils.device import float_dtype, resolve_device
from . import cuda_build, row_gather

BLK = 128
SUP = 4  # 128-row blocks per super-row (tile height 512)
SLAB = 2  # 128-col blocks per x slab (tile width 256)
TILE_R = SUP * BLK
TILE_C = SLAB * BLK
MODES = ("f32", "bf16x2", "bf16x3")

_LIB = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _n_pad(n: int, tile_r: int, tile_c: int) -> int:
    return _round_up(max(n, tile_r), int(np.lcm(tile_r, tile_c)))


# -- packing ---------------------------------------------------------------
def super_layout(A_scipy, tile_r: int, tile_c: int, m_pad: int, n_pad: int):
    """The super-tile layout of a (possibly rectangular) CSR matrix padded to
    m_pad × n_pad, without the tiles: (coo (CSR order), meta = (slab, sup,
    start) int32 sorted by (super, slab), entry_tile, entry_offset). The
    entry arrays map CSR-order nnz index → (tile, flat offset in the tile);
    every super-row owns at least one tile so every y row is written."""
    A = sp.csr_matrix(A_scipy)
    A.sort_indices()
    nslab = n_pad // tile_c
    nsup = m_pad // tile_r
    coo = A.tocoo()
    key = (coo.row // tile_r).astype(np.int64) * nslab + coo.col // tile_c
    uniq = np.unique(key)
    missing = np.setdiff1d(np.arange(nsup), np.unique(uniq // nslab))
    if len(missing):
        extra = missing.astype(np.int64) * nslab + np.minimum(missing,
                                                              nslab - 1)
        uniq = np.unique(np.concatenate([uniq, extra]))
    sup = (uniq // nslab).astype(np.int32)
    slab = (uniq % nslab).astype(np.int32)
    start = np.zeros(len(uniq), dtype=np.int32)
    start[np.unique(sup, return_index=True)[1]] = 1
    entry_tile = np.searchsorted(uniq, key).astype(np.int64)
    entry_offset = ((coo.row % tile_r).astype(np.int64) * tile_c
                    + coo.col % tile_c).astype(np.int64)
    return coo, (slab, sup, start), entry_tile, entry_offset


def _fill(ntile, tile_r, tile_c, entry_tile, entry_offset, data, dtype, dev):
    """(ntile, tile_r, tile_c) tiles in their storage dtype, filled straight
    from the nonzeros, never through a dense f64 host array."""
    atiles = torch.zeros((ntile, tile_r, tile_c), dtype=dtype, device=dev)
    atiles.view(ntile, -1)[
        torch.as_tensor(entry_tile, device=dev),
        torch.as_tensor(entry_offset, device=dev),
    ] = torch.as_tensor(data, device=dev).to(dtype)
    return atiles


def pack_bsr_super(A_scipy, tile_r: int = TILE_R, tile_c: int = TILE_C, *,
                   dtype=torch.float64, device):
    """Pack a (RCM-permuted) square scipy matrix into super-tiles.

    Returns (atiles (ntile, tile_r, tile_c) in ``dtype`` on ``device``, meta
    = (slab, sup, start), entry_tile, entry_offset, n_pad); see
    :func:`super_layout`.
    """
    n_pad = _n_pad(A_scipy.shape[0], tile_r, tile_c)
    coo, meta, et, eo = super_layout(A_scipy, tile_r, tile_c, n_pad, n_pad)
    atiles = _fill(len(meta[0]), tile_r, tile_c, et, eo, coo.data, dtype,
                   resolve_device(device))
    return atiles, meta, et, eo, n_pad


def block_pads(m: int, n: int, tile_r: int, tile_c: int) -> tuple[int, int]:
    """(m_pad, n_pad) of an m × n block: rows and columns pad on their own."""
    return _round_up(max(m, tile_r), tile_r), _round_up(max(n, tile_c), tile_c)


def pack_bsr_super_block(A_block, tile_r: int = TILE_R, tile_c: int = TILE_C,
                         *, dtype=torch.float64, device):
    """Rectangular variant of :func:`pack_bsr_super` for a row block of a
    row-partitioned matrix (rows = a shard's rows, columns = all columns or
    the shard's own window): rows and columns pad on their own. Returns
    (atiles, meta, entry_tile, entry_offset, (m_pad, n_pad)), as the JAX
    package's ``pallas_bsr_super.py:238-280``."""
    m_pad, n_pad = block_pads(*A_block.shape, tile_r, tile_c)
    coo, meta, et, eo = super_layout(A_block, tile_r, tile_c, m_pad, n_pad)
    atiles = _fill(len(meta[0]), tile_r, tile_c, et, eo, coo.data, dtype,
                   resolve_device(device))
    return atiles, meta, et, eo, (m_pad, n_pad)


def super_tile_count(A_scipy, perm: np.ndarray | None = None,
                     tile_r: int = TILE_R, tile_c: int = TILE_C) -> int:
    """Number of super-tiles (incl. per-super fill-ins) under ``perm``."""
    C = sp.coo_matrix(A_scipy)
    row, col = C.row, C.col
    if perm is not None:
        pinv = np.empty_like(perm)
        pinv[perm] = np.arange(len(perm))
        row, col = pinv[row], pinv[col]
    n_pad = _n_pad(A_scipy.shape[0], tile_r, tile_c)
    nslab = n_pad // tile_c
    key = (row // tile_r).astype(np.int64) * nslab + col // tile_c
    uniq = np.unique(key)
    nsup_missing = len(np.setdiff1d(np.arange(n_pad // tile_r),
                                    np.unique(uniq // nslab)))
    return len(uniq) + nsup_missing


def bf16_split(x: torch.Tensor, terms: int) -> torch.Tensor:
    """x (f32) → [hi | lo | ...] bf16 parts concatenated along axis 1; each
    part is the round-to-nearest bf16 of what the previous ones left."""
    parts = []
    r = x
    for _ in range(terms):
        h = r.to(torch.bfloat16)
        parts.append(h)
        r = r - h.to(r.dtype)
    return torch.cat(parts, dim=1)


# -- plain versions over the tiles (the row-sharded block's CPU path) ------
def _fold_rows(p, sup, m_pad: int, m: int):
    """The tile products ``p`` (ntile, tile_r, b) summed into y by super-row
    with ``index_add_``; rows [0, m) of the m_pad-row result."""
    _, tile_r, b = p.shape
    y = torch.zeros((m_pad // tile_r, tile_r, b), dtype=p.dtype,
                    device=p.device)
    y.index_add_(0, sup.long(), p)
    return y.view(m_pad, b)[:m]


# Each plain version takes x of n rows (padded to n_pad, a multiple of the
# tile width, for the slab view) and gives y of m rows (m_pad, a multiple of
# the tile height, for the super-row fold); m and m_pad default to n and
# n_pad, the square operator's product.
def tile_spmm_bf16_plain(atiles, slab, sup, x, n_pad: int, terms: int,
                         m_pad: int | None = None, m: int | None = None):
    """Plain twin of K1: per term, batched f32 tile products over the x
    slabs, folded term-wise, then ``index_add_`` into y by super-row."""
    n, b = x.shape
    _, tile_r, tile_c = atiles.shape
    xp = torch.zeros((n_pad, b), dtype=torch.float32, device=x.device)
    xp[:n] = x
    xcat = bf16_split(xp, terms).view(n_pad // tile_c, tile_c, terms * b)
    p = torch.bmm(atiles.float(), xcat[slab.long()].float())
    s = p[..., :b]
    for k in range(1, terms):
        s = s + p[..., k * b:(k + 1) * b]
    return _fold_rows(s, sup, n_pad if m_pad is None else m_pad,
                      n if m is None else m)


def tile_spmm_full_plain(atiles, slab, sup, x, n_pad: int,
                         m_pad: int | None = None, m: int | None = None):
    """Plain twin of K2: batched tile products in the compute dtype, then
    ``index_add_`` into y by super-row."""
    n, b = x.shape
    _, tile_r, tile_c = atiles.shape
    xp = torch.zeros((n_pad, b), dtype=x.dtype, device=x.device)
    xp[:n] = x
    xs = xp.view(n_pad // tile_c, tile_c, b)[slab.long()]
    p = torch.bmm(atiles.to(x.dtype), xs)
    return _fold_rows(p, sup, n_pad if m_pad is None else m_pad,
                      n if m is None else m)


def _entry_rows(row_ptr: torch.Tensor) -> torch.Tensor:
    """The row of each entry of a CSR row index, in CSR order."""
    counts = torch.diff(row_ptr).long()
    return torch.repeat_interleave(
        torch.arange(len(counts), device=row_ptr.device), counts)


def csr_spmm_bf16_plain(row_ptr, cols, val_off, vals, x, terms: int):
    """Plain twin of K1 over its own arguments: y (m, b) f32 = A @ x for f32
    x (n_x, b), each entry's value ``vals.flatten()[val_off]`` times each
    bf16 part of its x row, the products of a part summed by row in f32
    (``index_add_``), then the parts' sums added, the high part's first."""
    m, b = row_ptr.numel() - 1, x.shape[1]
    v = vals.reshape(-1)[val_off.long()].float()[:, None]
    xs = bf16_split(x, terms).float().index_select(0, cols.long())
    y = torch.zeros((m, terms * b), dtype=torch.float32, device=x.device)
    y.index_add_(0, _entry_rows(row_ptr), v * xs)
    s = y[:, :b]
    for k in range(1, terms):
        s = s + y[:, k * b:(k + 1) * b]
    return s


def csr_spmm_full_plain(row_ptr, cols, val_off, vals, x):
    """Plain twin of K2 over its own arguments: y (m, b) = A @ x for x
    (n_x, b) in f32 or f64, each entry's product and each row's sum in f64,
    rounded to x's dtype once."""
    m, b = row_ptr.numel() - 1, x.shape[1]
    v = vals.reshape(-1)[val_off.long()].double()[:, None]
    y = torch.zeros((m, b), dtype=torch.float64, device=x.device)
    y.index_add_(0, _entry_rows(row_ptr),
                 v * x.double().index_select(0, cols.long()))
    return y.to(x.dtype)


# -- kernel binding ----------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.library("bsr_super")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.krt_bsr_super_bf16.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
        for name in ("krt_bsr_super_f32", "krt_bsr_super_f64"):
            getattr(lib, name).argtypes = [ptr] * 6 + [i32] * 2 + [ptr]
        for name in ("krt_bsr_super_bf16", "krt_bsr_super_f32",
                     "krt_bsr_super_f64"):
            getattr(lib, name).restype = i32
        _LIB = lib
    return _LIB


def tile_spmm_bf16(row_ptr, cols, val_off, vals, x, terms: int):
    """K1: y (m, b) f32 = A @ x for f32 x (n_x, b), A's values gathered out
    of the bf16 storage ``vals`` (the operator's CSR-order values, or a
    shard's tiles) through the int32 row index (``row_ptr`` of m + 1,
    ``cols`` and ``val_off`` of nnz, every column below n_x; see
    :mod:`.row_gather`), x split into ``terms`` bf16 parts inside the kernel.
    m = n_x for the square operator; a shard's block of a row-sharded
    operator has its own rows (m) and reads local or gathered x (n_x)."""
    m = row_gather.check_launch("K1", row_ptr, cols, val_off, vals, x,
                                torch.bfloat16, torch.float32)
    if terms not in (2, 3):
        raise ValueError(f"terms must be 2 or 3, got {terms}")
    b = x.shape[1]
    y = torch.empty((m, b), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.krt_bsr_super_bf16(
            row_ptr.data_ptr(), cols.data_ptr(), val_off.data_ptr(),
            vals.data_ptr(), x.data_ptr(), y.data_ptr(), m, b, terms,
            stream)
    cuda_build.raise_on(code, "krt_bsr_super_bf16")
    tracing.count("spmm.launches.K1")
    return y


def tile_spmm_full(row_ptr, cols, val_off, vals, x):
    """K2: y (m, b) = A @ x for x (n_x, b) in f32 or f64, A's values gathered
    out of the storage ``vals`` (in x's dtype) through the int32 row index
    (``row_ptr`` of m + 1, ``cols`` and ``val_off`` of nnz, every column
    below n_x; see :mod:`.row_gather`), one DFMA an entry into an f64 sum
    (in f32 rounded once at the store). m and n_x as for K1."""
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K2 takes float32 or float64, got {x.dtype}")
    m = row_gather.check_launch("K2", row_ptr, cols, val_off, vals, x,
                                x.dtype, x.dtype)
    b = x.shape[1]
    y = torch.empty((m, b), dtype=x.dtype, device=x.device)
    lib = _library()
    fn = (lib.krt_bsr_super_f32 if x.dtype == torch.float32
          else lib.krt_bsr_super_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(row_ptr.data_ptr(), cols.data_ptr(), val_off.data_ptr(),
                  vals.data_ptr(), x.data_ptr(), y.data_ptr(), m, b,
                  stream)
    cuda_build.raise_on(code, fn.__name__)
    tracing.count("spmm.launches.K2")  # f32 and f64
    return y


# -- the operator ------------------------------------------------------------
class SuperBsrOperator:
    """SpMM operator over the super-tile kernels K1/K2, with a frozen
    sparsity structure.

    The values are one array ``vals`` on the device in the CSR order of the
    matrix, in the storage dtype; K1 and K2 read it through the int32 row
    index ``_row_ptr``, ``_cols``, ``_val_off`` (each entry's own position).
    ``matmul`` on (n, b) blocks or (n,) vectors; ``update_entry_values`` /
    ``set_edge`` edit values of existing entries in place (make mode's
    candidate slots are explicit zeros). mode ``f32`` runs K2 in the compute
    dtype; ``bf16xN`` (N = 2, 3) stores A in bf16 (values must be
    bf16-exact) and runs K1 with x split into N bf16 parts — ~2^-18 (N=2) /
    ~2^-27 (N=3) relative error. ``auto`` picks ``bf16x2`` for bf16-exact
    values in f32 and ``f32`` otherwise.
    """

    # Plain (CPU) path only: batches wider than MAX_B run as column chunks,
    # which bounds the gathered products' scratch; results are identical.
    # The kernels take any width.
    MAX_B = 1024

    def __init__(self, A_scipy, *, dtype=torch.float32, device,
                 mode: str = "auto"):
        A = sp.csr_matrix(A_scipy)
        A.sort_indices()
        dtype = float_dtype(dtype)
        if mode == "auto":
            # bf16x2's ~2^-18 error equals the f32 trace-update convergence
            # floor (32·eps_f32, updates/trace_update.py), so for bf16-exact
            # values it is accuracy-consistent with the f32 path.
            vals = torch.as_tensor(A.data.astype(np.float64))
            exact = bool(torch.all(vals.to(torch.bfloat16).double() == vals))
            mode = "bf16x2" if (exact and dtype == torch.float32) else "f32"
        if mode not in MODES:
            raise ValueError(f"mode must be 'auto' or one of {MODES}")
        store = torch.bfloat16 if mode.startswith("bf16x") else dtype
        vals = torch.as_tensor(A.data.astype(np.float64),
                               device=resolve_device(device)).to(store)
        coo = A.tocoo()
        self._setup(vals, (coo.row.astype(np.int64),
                           coo.col.astype(np.int64)), A.shape[0], mode, dtype)

    @classmethod
    def from_packed(cls, atiles: torch.Tensor, entry_tile, entry_offset,
                    entry_rc, n: int, mode: str, dtype):
        """Operator over the values of an existing super-tile packing (tiles
        already in their storage dtype and on their device; entry k, in CSR
        order, at ``entry_offset[k]`` of tile ``entry_tile[k]``), gathered
        into CSR order."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        dev = atiles.device
        vals = atiles.reshape(atiles.shape[0], -1)[
            torch.as_tensor(np.asarray(entry_tile, np.int64), device=dev),
            torch.as_tensor(np.asarray(entry_offset, np.int64), device=dev)]
        obj = cls.__new__(cls)
        obj._setup(vals, tuple(np.array(a, np.int64) for a in entry_rc),
                   int(n), mode, float_dtype(dtype))
        return obj

    def _setup(self, vals, entry_rc, n, mode, dtype):
        self.n = n
        self.nnz = int(vals.numel())
        self.mode = mode
        self.dtype = dtype  # compute dtype of the products
        self.vals = vals
        self._entry_rc = entry_rc
        # CSR order ⇒ row-major keys ascending: (i, j) → entry by searchsorted
        self._entry_keys = entry_rc[0] * n + entry_rc[1]
        self._row_ptr, self._cols, self._val_off = row_gather.row_index(
            entry_rc, np.arange(self.nnz), n, self.nnz, vals.device)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def storage_bytes(self) -> int:
        return self.vals.numel() * self.vals.element_size()

    def with_values(self, vals: torch.Tensor) -> "SuperBsrOperator":
        """The same operator over replacement values (no copy); it shares
        the row index."""
        if vals.shape != self.vals.shape or vals.dtype != self.vals.dtype:
            raise ValueError("replacement values must match shape and dtype")
        obj = object.__new__(type(self))
        obj.__dict__.update(self.__dict__)
        obj.vals = vals
        return obj

    # -- frozen-structure value edits ---------------------------------------
    def update_entry_values(self, entry_indices, values) -> None:
        """Set values of specific nnz entries (CSR order), in place."""
        dev = self.vals.device
        self.vals[torch.as_tensor(np.asarray(entry_indices, np.int64),
                                  device=dev)] = torch.as_tensor(
            np.asarray(values, np.float64), device=dev).to(self.vals.dtype)

    def entry_index(self, i, j):
        """CSR-order entry index of (i, j); arrays give arrays."""
        keys = self._entry_keys
        key = np.asarray(i, np.int64) * self.n + np.asarray(j, np.int64)
        pos = np.minimum(np.searchsorted(keys, key), max(len(keys) - 1, 0))
        if not len(keys) or not np.all(keys[pos] == key):
            raise KeyError(f"no stored entry at ({i}, {j})")
        return int(pos) if np.ndim(pos) == 0 else pos

    def set_edge(self, i: int, j: int, value: float) -> None:
        idx = [self.entry_index(i, j)]
        if i != j:
            idx.append(self.entry_index(j, i))
        self.update_entry_values(np.asarray(idx), np.full(len(idx), value))

    def entry_values(self) -> np.ndarray:
        """Current values of all nnz entries in CSR order, as f32."""
        return self.vals.to(torch.float32).cpu().numpy()

    # -- linear algebra ------------------------------------------------------
    def _terms(self) -> int:
        return int(self.mode[-1]) if self.mode.startswith("bf16x") else 0

    def _compute_dtype(self) -> torch.dtype:
        return torch.float32 if self._terms() else self.dtype

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        index = (self._row_ptr, self._cols, self._val_off, self.vals, x)
        if self._terms():
            return csr_spmm_bf16_plain(*index, self._terms())
        return csr_spmm_full_plain(*index)

    def _prepare(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.vals.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.vals.device}")
        if x.shape[0] != self.n:
            raise ValueError(f"x has {x.shape[0]} rows, A is {self.n}x{self.n}")
        return x.to(self._compute_dtype()).contiguous()

    def matmul_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain torch version on any device (the kernels' reference)."""
        squeeze = x.ndim == 1
        xc = self._prepare(x[:, None] if squeeze else x)
        b = xc.shape[1]
        y = torch.cat([self._plain(xc[:, s:s + self.MAX_B])
                       for s in range(0, b, self.MAX_B)], dim=1) \
            if b > self.MAX_B else self._plain(xc)
        y = y.to(x.dtype)
        return y[:, 0] if squeeze else y

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.spmm_span(self, x):
            if x.device.type == "cpu":
                return self.matmul_plain(x)
            if x.device.type != "cuda":
                raise ValueError(f"unsupported device {x.device}")
            squeeze = x.ndim == 1
            xc = self._prepare(x[:, None] if squeeze else x)
            index = (self._row_ptr, self._cols, self._val_off, self.vals, xc)
            y = tile_spmm_bf16(*index, self._terms()) if self._terms() \
                else tile_spmm_full(*index)
            y = y.to(x.dtype)
            return y[:, 0] if squeeze else y

    def __matmul__(self, x):
        return self.matmul(x)
