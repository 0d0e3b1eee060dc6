"""Banded-ELL SpMM operator with a hand-written Hopper kernel — port of
``krylov_robustness_tpu/ops/pallas_spmm.py``.

Road networks have a narrow band after RCM reordering (a few hundred rows),
and a bounded degree. :class:`BandedEllOperator` stores the (already
RCM-permuted) matrix as an ELL of K = max-degree slots per row, slot-major
``(K, n)`` tables ``cols`` and ``vals``: slot k of row r is the k-th entry of
row r in sorted CSR order, padding slots hold ``val = 0`` and ``col = r``.
So its entries are addressed exactly as the JAX operator addresses them
(``_entry_pos = (ks, rows)`` in CSR order). An explicit zero of the CSR
matrix is a stored entry like any other: greedy's make mode hands the
operator its candidate slots as zeros, K counts them, and a commit writes
its value into them (``set_edge``).

K3 (``csrc/banded_ell.cu``) computes ``y = A @ x`` over that ELL and
replaces ``_banded_kernel``. From b = :data:`GATHER_MIN_B` on it is the row
gather of K1, K2 and K4 (``csrc/row_gather.cuh``) over a CSR row index of
the ELL (``row_ptr``, ``cols`` and ``val_off`` = k·n + r, each entry's slot
in the flattened ``vals``, built once by the operator): padding slots are
never read, and each entry's column and value are read once for all b
columns. Narrower x runs one thread per output over the K slots. The JAX
kernel's 128-lane windows (``rel``/``win`` tables, halo-padded xᵀ) exist
only because Mosaic's gather cannot cross a vector register, and are not
carried over. Beside the kernel is its plain torch version (a loop over
slots of ``vals[k] · x[cols[k]]``, summed in slot order);
:meth:`BandedEllOperator.matmul` runs it for CPU tensors only, and a CUDA
tensor launches the kernel or raises.

The RCM helpers and :func:`make_operator` (banded kernel on a CUDA device
when the band is narrow, COO otherwise) are as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import tracing
from ..utils.device import float_dtype, resolve_device
from . import cuda_build, row_gather
from .sparse import CooMatrix

# K3 runs the row gather for x of at least this many columns, and one thread
# per output over the ELL below it (where the gather's lanes would stride
# over a row's few entries)
GATHER_MIN_B = 32

_LIB = None


def rcm_permutation(A_scipy) -> np.ndarray:
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(A_scipy),
                                            symmetric_mode=True))


def rcm_bandwidth(A_scipy, perm: np.ndarray | None = None) -> int:
    C = sp.coo_matrix(A_scipy)
    if not C.nnz:
        return 0
    if perm is not None:
        pinv = np.empty_like(perm)
        pinv[perm] = np.arange(len(perm))
        return int(np.abs(pinv[C.row] - pinv[C.col]).max())
    return int(np.abs(C.row - C.col).max())


def num_windows(bandwidth: int) -> int:
    """The JAX kernel's count of 128-lane windows, 2·(⌈bw/128⌉ + 1) − 1, for
    a bandwidth (``pallas_spmm.py:274``, ``greedy.py:623``)."""
    return 2 * ((bandwidth + 127) // 128 + 1) - 1


MAX_WINDOWS = 17


def banded_fits(A_scipy, perm: np.ndarray) -> bool:
    """Whether the RCM band of A under ``perm`` spans at most
    :data:`MAX_WINDOWS` windows: the rule by which greedy and
    :func:`make_operator` take the banded operator, as the JAX package does."""
    return num_windows(rcm_bandwidth(A_scipy, perm)) <= MAX_WINDOWS


# -- plain version (CPU path, and the kernel's on-card reference) -----------
def ell_spmm_plain(cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: y = Σ_k vals[k, :, None] · x[cols[k]], summed in slot
    order, for x (n, b) in the dtype of ``vals``."""
    y = torch.zeros_like(x)
    for k in range(cols.shape[0]):
        y = y + vals[k, :, None] * x.index_select(0, cols[k])
    return y


# -- kernel binding ----------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.library("banded_ell")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("krt_banded_ell_f32", "krt_banded_ell_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
            fn.restype = i32
        for name in ("krt_banded_gather_f32", "krt_banded_gather_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 6 + [i32] * 2 + [ptr]
            fn.restype = i32
        _LIB = lib
    return _LIB


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, row_ptr: torch.Tensor,
             entry_cols: torch.Tensor, val_off: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """K3: y (n, b) = ELL(cols, vals) @ x (n, b) on the card, for int32
    ``cols`` and f32/f64 ``vals`` (K, n) and x (n, b) of the same dtype, and
    the ELL's int32 row index (``row_ptr`` of n + 1, ``entry_cols`` and
    ``val_off`` of nnz, each entry's slot in the flattened ``vals``; see
    :mod:`.row_gather`). x of at least :data:`GATHER_MIN_B` columns runs the
    row gather over the index, narrower x the ELL kernel over the tables."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the banded-ELL kernel runs on CUDA tensors, got "
                         f"{dev}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K3 takes float32 or float64, got {x.dtype}")
    if row_gather.check_launch("K3", row_ptr, entry_cols, val_off, vals, x,
                               x.dtype, x.dtype) != x.shape[0]:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries, x has "
                         f"{x.shape[0]} rows: K3 takes a square matrix")
    if cols.device != dev or cols.dtype != torch.int32 or \
            not cols.is_contiguous():
        raise ValueError(f"cols must be contiguous int32 on {dev}, got "
                         f"{cols.dtype} on {cols.device}")
    if cols.ndim != 2 or vals.shape != cols.shape or 0 in cols.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must be one non-empty (K, n)")
    K, n = cols.shape
    if x.shape[0] != n:
        raise ValueError(f"x has {x.shape[0]} rows, the tables {n}")
    b = x.shape[1]
    if n * b > (2**31 - 1) * 256:
        raise ValueError(f"x ({n}, {b}) exceeds the kernel's grid")
    y = torch.empty((n, b), dtype=x.dtype, device=dev)
    lib = _library()
    f32 = x.dtype == torch.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if b >= GATHER_MIN_B:
            fn = lib.krt_banded_gather_f32 if f32 else \
                lib.krt_banded_gather_f64
            code = fn(row_ptr.data_ptr(), entry_cols.data_ptr(),
                      val_off.data_ptr(), vals.data_ptr(), x.data_ptr(),
                      y.data_ptr(), n, b, stream)
        else:
            fn = lib.krt_banded_ell_f32 if f32 else lib.krt_banded_ell_f64
            code = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                      y.data_ptr(), n, K, b, stream)
    cuda_build.raise_on(code, fn.__name__)
    tracing.count("spmm.launches.K3")  # both dtypes, both paths
    return y


# -- the operator ------------------------------------------------------------
class BandedEllOperator:
    """RCM-banded ELL SpMM operator over a frozen sparsity structure.

    Works in permuted node space: build it with the already-RCM-permuted
    matrix (:func:`make_operator` and greedy's banded backend do). Every
    entry of the CSR matrix is stored, explicit zeros too (make mode's
    candidate slots), and counts in K and ``nnz``. ``matmul`` on (n, b)
    blocks or (n,) vectors; ``update_entry_values`` / ``set_edge`` edit
    values of stored entries in place. No ``todense``: at n ≤ 130 the
    scorer runs the phase lane on it, as the JAX package does.
    """

    def __init__(self, A_scipy, *, dtype=torch.float32, device):
        A = sp.csr_matrix(A_scipy)
        A.sort_indices()
        n = A.shape[0]
        deg = np.diff(A.indptr)
        K = max(int(deg.max(initial=0)), 1)
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        ks = np.arange(A.nnz, dtype=np.int64) - A.indptr[rows]
        cols = np.tile(np.arange(n, dtype=np.int32), (K, 1))
        cols[ks, rows] = A.indices
        vals = np.zeros((K, n), np.float64)
        vals[ks, rows] = A.data
        dev = resolve_device(device)
        self._setup(torch.as_tensor(cols, device=dev),
                    torch.as_tensor(vals, device=dev).to(float_dtype(dtype)),
                    (ks, rows), A.indices.astype(np.int64))

    @classmethod
    def from_tables(cls, cols: torch.Tensor, vals: torch.Tensor, entry_pos,
                    entry_cols) -> "BandedEllOperator":
        """Operator over existing (K, n) tables on their device; padding
        slots must hold val 0 and col r. ``entry_pos`` = (ks, rows) and
        ``entry_cols`` list the stored entries in CSR order."""
        obj = cls.__new__(cls)
        obj._setup(cols, vals, tuple(np.array(a, np.int64) for a in entry_pos),
                   np.array(entry_cols, np.int64))
        return obj

    def _setup(self, cols, vals, entry_pos, entry_cols):
        if cols.dtype != torch.int32 or cols.shape != vals.shape:
            raise ValueError("cols must be int32 and shaped like vals")
        float_dtype(vals.dtype)
        self.K, self.n = (int(s) for s in cols.shape)
        self.cols = cols
        self.vals = vals
        self._entry_pos = entry_pos
        self._entry_cols = entry_cols
        self.nnz = len(entry_cols)
        ks, rows = entry_pos
        self._entry_rc = (rows, entry_cols)
        # CSR order ⇒ row-major keys ascending: (i, j) → entry by searchsorted
        self._entry_keys = rows * self.n + entry_cols
        bw = int(np.abs(rows - entry_cols).max()) if self.nnz else 0
        self.Wv = max((bw + 127) // 128, 1)  # the JAX operator's halo windows
        self.num_windows = 2 * self.Wv + 1
        # K3's row index for the row gather: the stored entries in CSR
        # order, each reading its value at slot k·n + r of the flattened
        # vals, so no padding slot is in it
        self._row_ptr, self._cols, self._val_off = row_gather.row_index(
            self._entry_rc, ks * self.n + rows, self.n, vals.numel(),
            vals.device)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    # -- frozen-structure value edits ---------------------------------------
    def update_entry_values(self, entry_indices, values) -> None:
        """Set values of specific nnz entries (CSR order), in place."""
        idx = np.asarray(entry_indices, np.int64)
        ks, rows = self._entry_pos
        dev = self.vals.device
        self.vals[torch.as_tensor(ks[idx], device=dev),
                  torch.as_tensor(rows[idx], device=dev)] = torch.as_tensor(
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
        """Symmetric edge edit in place (frozen structure)."""
        idx = [self.entry_index(i, j)]
        if i != j:
            idx.append(self.entry_index(j, i))
        self.update_entry_values(np.asarray(idx), np.full(len(idx), value))

    def entry_values(self) -> np.ndarray:
        """Current values of all nnz entries in CSR order, in the storage
        dtype."""
        ks, rows = self._entry_pos
        dev = self.vals.device
        return self.vals[torch.as_tensor(ks, device=dev),
                         torch.as_tensor(rows, device=dev)].cpu().numpy()

    # -- linear algebra ------------------------------------------------------
    def _prepare(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.vals.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.vals.device}")
        if x.shape[0] != self.n:
            raise ValueError(f"x has {x.shape[0]} rows, A is {self.n}x{self.n}")
        return x.to(self.vals.dtype).contiguous()

    def matmul_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain torch version on any device (the kernel's reference)."""
        squeeze = x.ndim == 1
        xc = self._prepare(x[:, None] if squeeze else x)
        y = ell_spmm_plain(self.cols.long(), self.vals, xc).to(x.dtype)
        return y[:, 0] if squeeze else y

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.spmm_span(self, x):
            if x.device.type == "cpu":
                return self.matmul_plain(x)
            if x.device.type != "cuda":
                raise ValueError(f"unsupported device {x.device}")
            squeeze = x.ndim == 1
            y = ell_spmm(self.cols, self.vals, self._row_ptr, self._cols,
                         self._val_off,
                         self._prepare(x[:, None] if squeeze else x)
                         ).to(x.dtype)
            return y[:, 0] if squeeze else y

    def __matmul__(self, x):
        return self.matmul(x)


def make_operator(A_scipy, *, dtype=torch.float32, device):
    """The SpMM operator for a graph: RCM + the banded kernel on a CUDA
    device when :func:`banded_fits`, COO otherwise (as the JAX package takes
    its banded kernel on the TPU only).

    Returns (operator, perm): ``perm`` is the node relabeling applied
    (identity for COO); edge indices must be mapped through it.
    """
    A = sp.csr_matrix(A_scipy)
    dev = resolve_device(device)
    perm = rcm_permutation(A)
    if dev.type == "cuda" and banded_fits(A, perm):
        Ap = A[perm, :].tocsc()[:, perm].tocsr()
        return BandedEllOperator(Ap, dtype=dtype, device=dev), perm
    return (CooMatrix.from_scipy(A, dtype=dtype, device=dev),
            np.arange(A.shape[0]))
