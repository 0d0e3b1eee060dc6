"""Build the port's objects from the JAX package's state, passed as numpy
arrays (``np.asarray`` on the JAX side), so both packages can be shown to
compute the same thing from the same state — for example a JAX Lanczos
recurrence resumed in torch."""

from __future__ import annotations

import numpy as np
import torch

from .krylov.lanczos import LanczosState
from .ops.bsr_super import SuperBsrOperator
from .ops.sparse import CooMatrix
from .utils.device import float_dtype, resolve_device


def coo_from_arrays(rows, cols, vals, n: int, nnz: int, device) -> CooMatrix:
    """``CooMatrix`` from the JAX container's arrays; padding entries past
    ``nnz`` are dropped."""
    dev = resolve_device(device)
    vals = np.array(vals)[:nnz]
    return CooMatrix(
        rows=torch.as_tensor(np.array(rows)[:nnz].astype(np.int64),
                             device=dev),
        cols=torch.as_tensor(np.array(cols)[:nnz].astype(np.int64),
                             device=dev),
        vals=torch.as_tensor(vals, device=dev).to(
            float_dtype(torch.float32 if vals.dtype == np.float32
                        else torch.float64)),
        n=int(n), nnz=int(nnz))


def super_bsr_from_arrays(atiles, slab, sup, start, entry_tile, entry_offset,
                          entry_rc, n: int, n_pad: int, mode: str, dtype,
                          device) -> SuperBsrOperator:
    """``SuperBsrOperator`` over the JAX operator's packing. ``atiles`` is
    converted to the storage dtype of ``mode`` (bf16 for ``bf16xN``, else
    ``dtype``)."""
    dev = resolve_device(device)
    dtype = float_dtype(dtype)
    store = torch.bfloat16 if mode.startswith("bf16x") else dtype
    tiles = torch.as_tensor(np.array(atiles, np.float64), device=dev).to(
        store)
    return SuperBsrOperator.from_packed(
        tiles, (slab, sup, start), entry_tile, entry_offset, entry_rc, n,
        n_pad, mode, dtype)


def lanczos_state_from_arrays(v_prev, v_cur, alive, device) -> LanczosState:
    """``LanczosState`` (n-major (n, batch, bs) blocks) from the JAX carry."""
    dev = resolve_device(device)
    return LanczosState(v_prev=torch.as_tensor(np.array(v_prev), device=dev),
                        v_cur=torch.as_tensor(np.array(v_cur), device=dev),
                        alive=torch.as_tensor(np.array(alive, bool),
                                              device=dev))
