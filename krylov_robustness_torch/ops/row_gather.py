"""The CSR row index that the row-gather kernel (``csrc/row_gather.cuh``:
K1, K2, K3 for b ≥ 32, K4) reads, and the checks its wrappers make before a
launch.

Each kernel gathers each entry's value out of the operator's own dense value
storage (super-tiles, ELL tables or 128 × 128 blocks, flattened) through an
int32 offset, so the storage stays the only copy of the values: edits in
place, a replaced storage tensor over the same packing and make mode's
explicit-zero slots need no change to the index.

For b ≥ 32 a warp walks the entries of a run of ``ROWS_PER_WARP``
consecutive rows as one stream, so its time grows with the run's entries. A
split plan (:func:`split_plan`) takes each run of more than
``SPLIT_ENTRIES`` entries out of that grid and hands its rows to units of at
most ``SPLIT_ENTRIES`` entries each, one warp a unit: a row of the run with
more entries is cut into balanced pieces, whose sums the kernel adds in
order after the gather; every other row of the run is one unit whole. The
plan depends on the row structure only, so value edits keep it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

INT32_MAX = 2**31 - 1
# the kernels' grid: 16 rows a CTA, column slices of at least 64 along
# gridDim.y (at most 65,535 of them)
ROWS_PER_CTA = 16
MAX_B = 65535 * 64
# as csrc/row_gather.cuh: the rows a warp owns, and the most entries a
# warp's run or unit holds before a split plan cuts it (the launch refuses a
# plan built for others)
ROWS_PER_WARP = 4
SPLIT_ENTRIES = 128

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


class SplitPlan(NamedTuple):
    """The units of the runs a row-gather launch takes out of its regular
    grid (:func:`split_plan`), on the index's device.

    ``units`` (U, 3) int32: each unit's row, first entry and end entry; the
    pieces of cut rows come first (row by row, each row's in entry order),
    then the whole rows, in row order. ``cut_end`` (C,) int32: for each cut
    row, in row order, the end of its pieces among the units (its first is
    the previous row's end, or 0). ``pieces`` = ``cut_end[-1]`` (0 without
    cut rows), ``entries`` the entries the units hold; ``limit`` and
    ``run`` the ``SPLIT_ENTRIES`` and ``ROWS_PER_WARP`` the plan was built
    for."""
    units: torch.Tensor
    cut_end: torch.Tensor
    pieces: int
    entries: int
    limit: int
    run: int


def split_plan(row_ptr, device, limit: int = SPLIT_ENTRIES,
               run: int = ROWS_PER_WARP) -> SplitPlan:
    """The split plan of a CSR row index (``row_ptr``, n + 1): every run of
    ``run`` rows (rows r .. r + run − 1 for r a multiple of ``run``; the
    last may be shorter) with more than ``limit`` entries is split; a row of
    such a run with more than ``limit`` entries is cut into ⌈len / limit⌉
    pieces of balanced length, every other row is one unit. No unit holds
    more than ``limit`` entries. Empty (0 units) where no run exceeds
    ``limit``, as on a road network or a banded matrix."""
    rp = np.asarray(row_ptr.cpu() if isinstance(row_ptr, torch.Tensor)
                    else row_ptr, np.int64)
    n = len(rp) - 1
    starts = np.arange(0, n, run)
    ends = np.minimum(starts + run, n)
    split = (rp[ends] - rp[starts]) > limit
    rows = (starts[split, None] + np.arange(run)).ravel()
    rows = rows[rows < n]
    lens = rp[rows + 1] - rp[rows]
    cut = lens > limit
    cut_rows, cut_lens = rows[cut], lens[cut]
    count = -(-cut_lens // limit)  # pieces a cut row
    first = np.cumsum(count) - count
    piece_row = np.repeat(cut_rows, count)
    k = np.arange(int(count.sum())) - np.repeat(first, count)
    span = np.repeat(cut_lens, count)
    parts = np.repeat(count, count)
    begin = rp[piece_row] + k * span // parts
    end = rp[piece_row] + (k + 1) * span // parts
    whole = rows[~cut]
    units = np.concatenate([np.stack([piece_row, begin, end], axis=1),
                            np.stack([whole, rp[whole], rp[whole + 1]],
                                     axis=1)]).astype(np.int32)
    cut_end = np.cumsum(count).astype(np.int32)
    return SplitPlan(torch.as_tensor(units.reshape(-1, 3), device=device),
                     torch.as_tensor(cut_end, device=device),
                     int(count.sum()), int(lens.sum()), int(limit), int(run))


class CSplitPlan(ctypes.Structure):
    """``row_gather::SplitPlan`` of ``csrc/row_gather.cuh``, as a launch
    takes it."""
    _fields_ = [("units", ctypes.c_void_p), ("cut_end", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("n_units", ctypes.c_int),
                ("n_cuts", ctypes.c_int), ("pieces", ctypes.c_int),
                ("limit", ctypes.c_int), ("run", ctypes.c_int)]


def launch_plan(split: SplitPlan | None, x: torch.Tensor, terms: int,
                acc_dtype: torch.dtype):
    """The plan argument of a row-gather launch on x (n_x, b): a reference
    to the ``CSplitPlan`` of ``split`` with its pieces' scratch (pieces,
    ``terms``, b) of ``acc_dtype``, the kernel's sum type, taken from
    ``torch.empty`` on x's device (the caching allocator, on the current
    stream); None (NULL) without units or for b < 32, which takes no plan."""
    b = x.shape[1]
    if split is None or not split.units.shape[0] or b < 32:
        return None
    if split.units.device != x.device:
        raise ValueError(f"the split plan is on {split.units.device}, x on "
                         f"{x.device}")
    part = torch.empty((split.pieces, terms, b), dtype=acc_dtype,
                       device=x.device) if split.pieces else None
    plan = CSplitPlan(split.units.data_ptr(),
                      split.cut_end.data_ptr() if split.pieces else None,
                      part.data_ptr() if split.pieces else None,
                      split.units.shape[0], split.cut_end.shape[0],
                      split.pieces, split.limit, split.run)
    plan.scratch = part  # alive until the launch has been enqueued
    return ctypes.byref(plan)


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
