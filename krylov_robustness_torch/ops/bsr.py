"""Flat block-sparse (BSR, 128 × 128 blocks) SpMM operator with a
hand-written Hopper kernel — port of ``krylov_robustness_tpu/ops/pallas_bsr.py``.

The (RCM-permuted) matrix is packed into dense 128 × 128 blocks, one per
(row block, column block) pair that holds an entry, sorted by row block;
every row block owns at least one block (a zero diagonal block where it has
none), so every y row is written. The packing (``ablocks``, ``cb``, ``rb``,
``first``, the entry maps) equals the JAX package's; the first-of-row flags
``first`` are implied by ``rb``, and neither the kernel nor the operator
keeps them.

K4 (``csrc/bsr_flat.cu``) computes ``A @ x`` over that packing in full f32
or f64 (FFMA/DFMA, never TF32) and replaces ``_bsr_kernel``. It is a row
gather (``csrc/row_gather.cuh``) over a CSR row index of the packing
(``row_ptr``, ``cols`` and ``val_off``, each entry's offset in the flattened
blocks, built once by the operator): each entry's value is read out of the
blocks, which stay the only copy of the values, and no fill is computed.
Beside it is its plain torch version (a batched block product plus
``index_add_`` by row block);
:meth:`BsrOperator.matmul` runs it for CPU tensors only, and a CUDA tensor
launches the kernel or raises.

:func:`make_bsr_operator` builds the operator when its block storage fits
768 MiB and falls back to COO otherwise (hub graphs without band structure),
counting the blocks before it packs any.
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.device import float_dtype, resolve_device
from . import cuda_build, row_gather
from .sparse import CooMatrix

BLK = 128
# make_bsr_operator's storage budget, the JAX package's value
MAX_STORAGE_BYTES = 768 * 1024 * 1024

# launch count of K4 (both dtypes); the wrapper adds one where it launches the
# kernel and nowhere else
launches_bsr = 0

_LIB = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# -- packing ---------------------------------------------------------------
def pack_bsr(A_scipy, *, dtype=torch.float64, device):
    """Pack a (RCM-permuted) scipy matrix into sorted dense 128 × 128 blocks.

    Returns (ablocks (nblk, 128, 128) in ``dtype`` on ``device``, cb, rb,
    first int32, entry_block, entry_offset int64); the entry arrays map
    CSR-order nnz index → (block, flat offset inside the block). ``ablocks``
    is filled in its storage dtype straight from the nonzeros.
    """
    A = sp.csr_matrix(A_scipy)
    A.sort_indices()
    n = A.shape[0]
    nrb = _round_up(max(n, BLK), BLK) // BLK
    coo = A.tocoo()
    ri, ci = coo.row % BLK, coo.col % BLK
    key = (coo.row // BLK).astype(np.int64) * nrb + coo.col // BLK
    uniq = np.unique(key)
    # every row block (padding ones too) needs a block so its y rows are
    # written: a zero diagonal block where it has none
    missing = np.setdiff1d(np.arange(nrb), np.unique(uniq // nrb))
    if len(missing):
        uniq = np.sort(np.concatenate(
            [uniq, missing.astype(np.int64) * nrb + missing]))
    entry_block = np.searchsorted(uniq, key).astype(np.int64)
    entry_offset = (ri * BLK + ci).astype(np.int64)
    rb = (uniq // nrb).astype(np.int32)
    cb = (uniq % nrb).astype(np.int32)
    dev = resolve_device(device)
    ablocks = torch.zeros((len(uniq), BLK, BLK), dtype=dtype, device=dev)
    ablocks.view(len(uniq), -1)[
        torch.as_tensor(entry_block, device=dev),
        torch.as_tensor(entry_offset, device=dev),
    ] = torch.as_tensor(coo.data, device=dev).to(dtype)
    return ablocks, cb, rb, first_of_row(rb), entry_block, entry_offset


def first_of_row(rb: np.ndarray) -> np.ndarray:
    """The JAX packing's flags: 1 at the first block of each row block."""
    first = np.zeros(len(rb), dtype=np.int32)
    first[np.unique(rb, return_index=True)[1]] = 1
    return first


def bsr_block_count(A_scipy, perm: np.ndarray | None = None) -> int:
    """Number of nonzero 128 × 128 blocks of A under ``perm``, without the
    zero blocks :func:`pack_bsr` adds for empty row blocks (as the JAX
    package counts them)."""
    C = sp.coo_matrix(A_scipy)
    row, col = C.row, C.col
    if perm is not None:
        pinv = np.empty_like(perm)
        pinv[perm] = np.arange(len(perm))
        row, col = pinv[row], pinv[col]
    nrb = _round_up(max(A_scipy.shape[0], BLK), BLK) // BLK
    return len(np.unique((row // BLK).astype(np.int64) * nrb + col // BLK))


# -- plain version (CPU path, and the kernel's on-card reference) -----------
# blocks per batched product: bounds the plain version's scratch, which is two
# (chunk, 128, b) arrays (the gathered x blocks and the products)
PLAIN_CHUNK = 512


def bsr_spmm_plain(ablocks: torch.Tensor, cb: torch.Tensor, rb: torch.Tensor,
                   x_pad: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4: y_pad (n_pad, b) = Σ_t into row block rb[t] of
    ablocks[t] @ x_pad[cb[t]], as batched block products in the dtype of
    ``ablocks`` and ``index_add_`` by row block, over chunks of blocks."""
    n_pad, b = x_pad.shape
    xb = x_pad.view(n_pad // BLK, BLK, b)
    y = torch.zeros_like(xb)
    for s in range(0, ablocks.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        y.index_add_(0, rb[s:e].long(),
                     torch.bmm(ablocks[s:e], xb[cb[s:e].long()]))
    return y.view(n_pad, b)


# -- kernel binding ----------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.library("bsr_flat")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("krt_bsr_flat_f32", "krt_bsr_flat_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 6 + [i32] * 2 + [ptr]
            fn.restype = i32
        _LIB = lib
    return _LIB


def bsr_spmm(row_ptr: torch.Tensor, cols: torch.Tensor,
             val_off: torch.Tensor, ablocks: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """K4: y (n, b) = A @ x on the card for x (n, b) in f32 or f64, A's
    values gathered out of the blocks ``ablocks`` (in x's dtype) through the
    int32 row index (``row_ptr`` of n + 1, ``cols`` and ``val_off`` of nnz;
    see :mod:`.row_gather`)."""
    global launches_bsr
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K4 takes float32 or float64, got {x.dtype}")
    n, b = x.shape
    if row_gather.check_launch("K4", row_ptr, cols, val_off, ablocks, x,
                               x.dtype, x.dtype) != n:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries, x has {n} "
                         f"rows: K4 takes a square matrix")
    y = torch.empty((n, b), dtype=x.dtype, device=x.device)
    lib = _library()
    fn = (lib.krt_bsr_flat_f32 if x.dtype == torch.float32
          else lib.krt_bsr_flat_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(row_ptr.data_ptr(), cols.data_ptr(), val_off.data_ptr(),
                  ablocks.data_ptr(), x.data_ptr(), y.data_ptr(), n, b,
                  stream)
    cuda_build.raise_on(code, fn.__name__)
    launches_bsr += 1
    return y


# -- the operator ------------------------------------------------------------
class BsrOperator:
    """Flat 128 × 128 block-sparse SpMM operator over a frozen sparsity
    structure, in whatever node order the matrix has (pair it with RCM via
    :func:`make_bsr_operator` to keep the block count low).

    ``matmul`` on (n, b) blocks or (n,) vectors in f32 or f64 storage;
    ``update_entry_values`` / ``set_edge`` edit values of existing entries in
    place.
    """

    def __init__(self, A_scipy, *, dtype=torch.float32, device):
        A = sp.csr_matrix(A_scipy)
        A.sort_indices()
        ablocks, cb, rb, _, eb, eo = pack_bsr(
            A, dtype=float_dtype(dtype), device=device)
        coo = A.tocoo()
        self._setup(ablocks, cb, rb, eb, eo,
                    (coo.row.astype(np.int64), coo.col.astype(np.int64)),
                    A.shape[0])

    @classmethod
    def from_packed(cls, ablocks: torch.Tensor, cb, rb, first, entry_block,
                    entry_offset, entry_rc, n: int) -> "BsrOperator":
        """Operator over an existing packing (blocks already in their storage
        dtype and on their device); ``first`` must be the flags ``rb``
        implies."""
        float_dtype(ablocks.dtype)
        cb, rb, first = (np.array(a, np.int32) for a in (cb, rb, first))
        if not np.array_equal(first, first_of_row(rb)):
            raise ValueError("first-of-row flags do not match rb")
        obj = cls.__new__(cls)
        obj._setup(ablocks, cb, rb, np.array(entry_block, np.int64),
                   np.array(entry_offset, np.int64),
                   tuple(np.array(a, np.int64) for a in entry_rc), int(n))
        return obj

    def _setup(self, ablocks, cb, rb, entry_block, entry_offset, entry_rc,
               n):
        if ablocks.ndim != 3 or ablocks.shape[1:] != (BLK, BLK):
            raise ValueError("ablocks must be (nblk, 128, 128)")
        if np.any(np.diff(rb) < 0):
            raise ValueError("blocks must be sorted by row block")
        self.n = n
        self.nnz = len(entry_block)
        self.n_pad = _round_up(max(n, BLK), BLK)
        self.ablocks = ablocks
        self._entry_block = entry_block
        self._entry_offset = entry_offset
        self._entry_rc = entry_rc
        # CSR order ⇒ row-major keys ascending: (i, j) → entry by searchsorted
        self._entry_keys = entry_rc[0] * n + entry_rc[1]
        dev = ablocks.device
        self.cb = torch.as_tensor(cb, device=dev)
        self.rb = torch.as_tensor(rb, device=dev)
        # K4's row index, in the operator's node order: the entries are in
        # CSR order, and each reads its value at block·128·128 + offset of
        # the flattened blocks
        self.row_ptr, self.cols, self.val_off = row_gather.row_index(
            entry_rc, entry_block * (BLK * BLK) + entry_offset, n,
            ablocks.numel(), dev)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.ablocks.dtype

    @property
    def device(self) -> torch.device:
        return self.ablocks.device

    @property
    def nblocks(self) -> int:
        return int(self.ablocks.shape[0])

    def storage_bytes(self) -> int:
        return self.ablocks.numel() * self.ablocks.element_size()

    # -- frozen-structure value edits ---------------------------------------
    def update_entry_values(self, entry_indices, values) -> None:
        """Set values of specific nnz entries (CSR order), in place."""
        idx = np.asarray(entry_indices, np.int64)
        dev = self.ablocks.device
        self.ablocks.view(self.nblocks, -1)[
            torch.as_tensor(self._entry_block[idx], device=dev),
            torch.as_tensor(self._entry_offset[idx], device=dev)] = (
            torch.as_tensor(np.asarray(values, np.float64), device=dev).to(
                self.dtype))

    def entry_index(self, i, j):
        """CSR-order entry index of (i, j); arrays give arrays."""
        keys = self._entry_keys
        key = np.asarray(i, np.int64) * self.n + np.asarray(j, np.int64)
        pos = np.minimum(np.searchsorted(keys, key), max(len(keys) - 1, 0))
        if not len(keys) or not np.all(keys[pos] == key):
            raise KeyError(f"no stored entry at ({i}, {j})")
        return int(pos) if np.ndim(pos) == 0 else pos

    def set_edge(self, i: int, j: int, value: float) -> None:
        """Symmetric edge edit in place (frozen structure)."""
        idx = [self.entry_index(i, j)]
        if i != j:
            idx.append(self.entry_index(j, i))
        self.update_entry_values(np.asarray(idx), np.full(len(idx), value))

    def entry_values(self) -> np.ndarray:
        """Current values of all nnz entries in CSR order, in the storage
        dtype."""
        dev = self.ablocks.device
        return self.ablocks.view(self.nblocks, -1)[
            torch.as_tensor(self._entry_block, device=dev),
            torch.as_tensor(self._entry_offset, device=dev)].cpu().numpy()

    # -- linear algebra ------------------------------------------------------
    def _prepare(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.ablocks.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.ablocks.device}")
        if x.shape[0] != self.n:
            raise ValueError(f"x has {x.shape[0]} rows, A is {self.n}x{self.n}")
        return x.to(self.dtype).contiguous()

    def matmul_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain torch version on any device (the kernel's reference)."""
        squeeze = x.ndim == 1
        xc = self._prepare(x[:, None] if squeeze else x)
        x_pad = torch.zeros((self.n_pad, xc.shape[1]), dtype=self.dtype,
                            device=xc.device)
        x_pad[:self.n] = xc
        y = bsr_spmm_plain(self.ablocks, self.cb, self.rb, x_pad)
        y = y[:self.n].to(x.dtype)
        return y[:, 0] if squeeze else y

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.matmul_plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        squeeze = x.ndim == 1
        y = bsr_spmm(self.row_ptr, self.cols, self.val_off, self.ablocks,
                     self._prepare(x[:, None] if squeeze else x)).to(x.dtype)
        return y[:, 0] if squeeze else y

    def __matmul__(self, x):
        return self.matmul(x)


def make_bsr_operator(A_scipy, *, dtype=torch.float32, device,
                      max_storage_bytes: int = MAX_STORAGE_BYTES):
    """RCM-reorder and build the flat BSR operator when its block storage
    fits ``max_storage_bytes``; otherwise COO over A as it is (hub graphs
    whose blocks do not compress). The blocks are counted before any packing,
    so a graph over the budget never allocates its blocks.

    Returns (operator, perm): ``perm`` is the node relabeling applied
    (identity for COO); edge indices must be mapped through it.
    """
    from .banded_spmm import rcm_permutation

    A = sp.csr_matrix(A_scipy)
    dtype = float_dtype(dtype)
    perm = rcm_permutation(A)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if bsr_block_count(A, perm) * BLK * BLK * itemsize <= max_storage_bytes:
        Ap = A[perm, :].tocsc()[:, perm].tocsr()
        return BsrOperator(Ap, dtype=dtype, device=device), perm
    return (CooMatrix.from_scipy(A, dtype=dtype, device=device),
            np.arange(A.shape[0]))
