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

INT32_MAX = 2**31 - 1
# the kernels' grid: 16 rows a CTA, column slices of at least 64 along
# gridDim.y (at most 65,535 of them)
ROWS_PER_CTA = 16
MAX_B = 65535 * 64


def row_index(entry_rc, entry_slot, n: int, numel: int, device):
    """(row_ptr (n + 1), cols (nnz), val_off (nnz)), int32 on ``device``:
    the CSR row index of entries given in CSR order by their (row, column)
    ``entry_rc`` and their flat offset ``entry_slot`` in a value storage of
    ``numel`` elements."""
    rows, cols = (np.asarray(a, np.int64) for a in entry_rc)
    slot = np.asarray(entry_slot, np.int64)
    if numel > INT32_MAX:
        raise ValueError(f"value storage of {numel} elements: the row-gather "
                         f"kernels address it with int32 offsets")
    if n > INT32_MAX - ROWS_PER_CTA:
        raise ValueError(f"n = {n} exceeds the row-gather kernels' grid")
    if len(slot) and (slot.min() < 0 or slot.max() >= numel):
        raise ValueError("an entry's value offset lies outside the storage")
    if len(rows) and (rows.min() < 0 or rows.max() >= n or cols.min() < 0
                      or cols.max() >= n):
        raise ValueError(f"an entry lies outside the {n}x{n} matrix")
    if np.any(np.diff(rows * n + cols) <= 0):
        raise ValueError("entries must be in CSR order, without repeats")
    row_ptr = np.searchsorted(rows, np.arange(n + 1))
    return tuple(torch.as_tensor(a.astype(np.int32), device=device)
                 for a in (row_ptr, cols, slot))


def check_launch(kernel: str, row_ptr, cols, val_off, vals, x, vals_dtype,
                 x_dtype) -> None:
    """Raise unless the arguments are what the row-gather kernel takes: CUDA
    tensors on x's device, contiguous, int32 index, ``vals_dtype`` values,
    ``x_dtype`` x of shape (n, b) with ``row_ptr`` of n + 1."""
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
    n, b = x.shape
    if row_ptr.shape != (n + 1,):
        raise ValueError(f"row_ptr has shape {tuple(row_ptr.shape)}, x has "
                         f"{n} rows")
    if cols.ndim != 1 or cols.shape != val_off.shape:
        raise ValueError("cols and val_off must be vectors of one length")
    if vals.numel() > INT32_MAX or n > INT32_MAX - ROWS_PER_CTA or b > MAX_B:
        raise ValueError(f"values of {vals.numel()} elements or x of "
                         f"{tuple(x.shape)} exceed the kernel's int32 "
                         f"offsets or its grid")
