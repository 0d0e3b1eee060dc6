"""The CSR row index that the row-gather kernel (``csrc/row_gather.cuh``:
K1, K2, K3 for b ≥ 32, K4) reads, and the checks its wrappers make before a
launch.

Each kernel gathers each entry's value out of the operator's own dense value
storage (super-tiles, ELL tables or 128 × 128 blocks, flattened) through an
int32 offset, so the storage stays the only copy of the values: edits in
place, a replaced storage tensor over the same packing and make mode's
explicit-zero slots need no change to the index.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

INT32_MAX = 2**31 - 1
# the kernels' grid: 16 rows a CTA, column slices of at least 64 along
# gridDim.y (at most 65,535 of them)
ROWS_PER_CTA = 16
MAX_B = 65535 * 64

# the largest column of each index's ``cols`` tensor, read from the card once
# per tensor and version (an index is frozen: edits change values only)
_MAX_COL = WeakIdKeyDictionary()


def row_index(entry_rc, entry_slot, n: int, numel: int, device,
              n_cols: int | None = None):
    """(row_ptr (n + 1), cols (nnz), val_off (nnz)), int32 on ``device``:
    the CSR row index of an n × ``n_cols`` (default n × n) matrix whose
    entries are given in CSR order by their (row, column) ``entry_rc`` and
    their flat offset ``entry_slot`` in a value storage of ``numel``
    elements. A launch over it writes n rows of y and reads x rows below
    ``n_cols``."""
    rows, cols = (np.asarray(a, np.int64) for a in entry_rc)
    slot = np.asarray(entry_slot, np.int64)
    n_cols = n if n_cols is None else n_cols
    if numel > INT32_MAX:
        raise ValueError(f"value storage of {numel} elements: the row-gather "
                         f"kernels address it with int32 offsets")
    if n > INT32_MAX - ROWS_PER_CTA or n_cols > INT32_MAX:
        raise ValueError(f"a {n}x{n_cols} matrix exceeds the row-gather "
                         f"kernels' grid")
    if len(slot) and (slot.min() < 0 or slot.max() >= numel):
        raise ValueError("an entry's value offset lies outside the storage")
    if len(rows) and (rows.min() < 0 or rows.max() >= n or cols.min() < 0
                      or cols.max() >= n_cols):
        raise ValueError(f"an entry lies outside the {n}x{n_cols} matrix")
    if np.any(np.diff(rows * n_cols + cols) <= 0):
        raise ValueError("entries must be in CSR order, without repeats")
    row_ptr = np.searchsorted(rows, np.arange(n + 1))
    return tuple(torch.as_tensor(a.astype(np.int32), device=device)
                 for a in (row_ptr, cols, slot))


def _max_col(cols: torch.Tensor) -> int:
    cached = _MAX_COL.get(cols)
    if cached is None or cached[0] != cols._version:
        cached = (cols._version, int(cols.max()) if cols.numel() else -1)
        _MAX_COL[cols] = cached
    return cached[1]


def check_launch(kernel: str, row_ptr, cols, val_off, vals, x, vals_dtype,
                 x_dtype) -> int:
    """Raise unless the arguments are what the row-gather kernel takes: CUDA
    tensors on x's device, contiguous, int32 index, ``vals_dtype`` values,
    ``x_dtype`` x of shape (n_x, b) with every column of the index below
    n_x. Returns m, the rows of y (``row_ptr`` holds m + 1): m = n_x for a
    square matrix, the rows of a shard's block for a rectangular one."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {dev}")
    for name, t, dt in (("row_ptr", row_ptr, torch.int32),
                        ("cols", cols, torch.int32),
                        ("val_off", val_off, torch.int32),
                        ("values", vals, vals_dtype), ("x", x, x_dtype)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 2 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (n, b) matrix, got "
                         f"{tuple(x.shape)}")
    n_x, b = x.shape
    if row_ptr.ndim != 1 or row_ptr.shape[0] < 2:
        raise ValueError(f"row_ptr has shape {tuple(row_ptr.shape)}, not "
                         f"(m + 1,) for m >= 1 rows")
    m = row_ptr.shape[0] - 1
    if cols.ndim != 1 or cols.shape != val_off.shape:
        raise ValueError("cols and val_off must be vectors of one length")
    if vals.numel() > INT32_MAX or m > INT32_MAX - ROWS_PER_CTA or \
            n_x > INT32_MAX or b > MAX_B:
        raise ValueError(f"values of {vals.numel()} elements, {m} rows or x "
                         f"of {tuple(x.shape)} exceed the kernel's int32 "
                         f"offsets or its grid")
    if _max_col(cols) >= n_x:
        raise ValueError(f"the index reads x row {_max_col(cols)}, x has "
                         f"{n_x} rows")
    return m
