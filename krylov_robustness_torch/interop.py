"""Build the port's objects from the JAX package's state, passed as numpy
arrays (``np.asarray`` on the JAX side), so both packages can be shown to
compute the same thing from the same state — for example a JAX Lanczos
recurrence resumed in torch."""

from __future__ import annotations

import numpy as np
import torch

from .krylov.arnoldi import ArnoldiState
from .krylov.lanczos import LanczosState
from .ops.banded_spmm import BandedEllOperator
from .ops.bsr import BsrOperator
from .ops.bsr_super import SuperBsrOperator
from .ops.sparse import CooMatrix
from .optimize.continuous import ContinuousProblem
from .parallel.spmm_sharded import BsrRowShardedMatrix, RowShardedMatrix
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


def bsr_from_arrays(ablocks, cb, rb, first, entry_block, entry_offset,
                    entry_rc, n: int, dtype, device) -> BsrOperator:
    """``BsrOperator`` over the JAX operator's flat 128 × 128 packing, its
    blocks converted to ``dtype``."""
    dev = resolve_device(device)
    blocks = torch.as_tensor(np.array(ablocks, np.float64), device=dev).to(
        float_dtype(dtype))
    return BsrOperator.from_packed(blocks, cb, rb, first, entry_block,
                                   entry_offset, entry_rc, n)


def banded_ell_from_arrays(relT, winT, valT, Wv: int, n: int, entry_pos,
                           device) -> BandedEllOperator:
    """``BandedEllOperator`` from the JAX operator's lane-window tables
    (``relT``, ``winT``, ``valT``, each (K, n_lanes)), its ``Wv`` attribute,
    ``n`` and its entry positions (ks, rows). A real slot's column is decoded
    as col = (win − Wv + r//128)·128 + rel; every other slot becomes a padding
    slot (val 0, col r)."""
    dev = resolve_device(device)
    rel = np.array(relT, np.int64)[:, :n]
    win = np.array(winT, np.int64)[:, :n]
    vals = np.array(valT)[:, :n]
    ks, rows = (np.array(a, np.int64) for a in entry_pos)
    K = rel.shape[0]
    r = np.arange(n)
    decoded = (win - Wv + r // 128) * 128 + rel
    cols = np.tile(r.astype(np.int32), (K, 1))
    cols[ks, rows] = decoded[ks, rows]
    real = np.zeros((K, n), bool)
    real[ks, rows] = True
    vals = np.where(real, vals, 0)
    dtype = torch.float32 if vals.dtype == np.float32 else torch.float64
    return BandedEllOperator.from_tables(
        torch.as_tensor(cols, device=dev),
        torch.as_tensor(vals, device=dev).to(dtype), (ks, rows),
        decoded[ks, rows])


def row_sharded_from_arrays(rows_local, cols, vals, n: int, n_orig: int,
                            nnz: int, mesh, axis: str = "rows",
                            batch_axis: str | None = None,
                            layout: str = "coo") -> RowShardedMatrix:
    """This rank's shard of a ``RowShardedMatrix`` from the JAX operator's
    global arrays: ``rows_local``/``cols``/``vals`` of D·nnz_shard slots
    (COO) or ``cols``/``vals`` (n, K) (ELL)."""
    D, d = mesh.shape[axis], mesh.index(axis)
    dev = mesh.device
    vals = np.array(vals)
    dtype = torch.float32 if vals.dtype == np.float32 else torch.float64
    if layout == "ell":
        rps = n // D
        part = slice(d * rps, (d + 1) * rps)
        rows_t = torch.zeros(0, dtype=torch.int64, device=dev)
        cols_t = torch.as_tensor(np.array(cols)[part].astype(np.int64),
                                 device=dev)
        vals_t = torch.as_tensor(vals[part], device=dev)
    else:
        per = len(vals) // D
        part = slice(d * per, (d + 1) * per)
        rows_t, cols_t = (torch.as_tensor(np.array(a)[part].astype(np.int64),
                                          device=dev) for a in (rows_local,
                                                                cols))
        vals_t = torch.as_tensor(np.concatenate([vals[part], [0]]),
                                 device=dev)
    return RowShardedMatrix(mesh=mesh, rows_local=rows_t, cols=cols_t,
                            vals=vals_t.to(dtype), n=int(n),
                            n_orig=int(n_orig), nnz=int(nnz), axis=axis,
                            batch_axis=batch_axis, layout=layout)


def bsr_row_sharded_from_arrays(atiles, slab, sup, start, entry_flat,
                                entry_rc, n: int, n_orig: int, nnz: int,
                                m_pad: int, n_pad: int, n_diag: int,
                                mode: str, dtype, mesh, axis: str = "rows",
                                batch_axis: str | None = None
                                ) -> BsrRowShardedMatrix:
    """This rank's shard of a ``BsrRowShardedMatrix`` from the JAX
    operator's global packing: ``atiles`` (D, ntile_u, tile_r, tile_c),
    ``slab``/``sup``/``start`` (D, ntile_u), its ``entry_positions()`` and
    ``entry_rc()``, and its sizes. The tiles are converted to the storage
    dtype of ``mode`` (bf16 for ``bf16xN``, else ``dtype``)."""
    d = mesh.index(axis)
    dtype = float_dtype(dtype)
    store = torch.bfloat16 if mode.startswith("bf16x") else dtype
    tiles = np.array(atiles[d], np.float64)
    storage = torch.as_tensor(np.concatenate([tiles.reshape(-1), [0.0]]),
                              device=mesh.device).to(store)
    return BsrRowShardedMatrix(
        mesh=mesh, storage=storage,
        meta=tuple(np.array(a)[d] for a in (slab, sup, start)),
        entry_flat=entry_flat, entry_rc=entry_rc, n=n, n_orig=n_orig,
        nnz=nnz, m_pad=m_pad, n_pad=n_pad, n_diag=n_diag,
        tile=tiles.shape[1:], mode=mode, dtype=dtype, axis=axis,
        batch_axis=batch_axis)


def lanczos_state_from_arrays(v_prev, v_cur, alive, device) -> LanczosState:
    """``LanczosState`` (n-major (n, batch, bs) blocks) from the JAX carry."""
    dev = resolve_device(device)
    return LanczosState(v_prev=torch.as_tensor(np.array(v_prev), device=dev),
                        v_cur=torch.as_tensor(np.array(v_cur), device=dev),
                        alive=torch.as_tensor(np.array(alive, bool),
                                              device=dev))


def arnoldi_state_from_arrays(V, step, alive, device) -> ArnoldiState:
    """``ArnoldiState`` (the padded (batch, n, max_cols) basis, the completed
    step count, the live mask) from the JAX carry. The port writes the basis
    in place, so it gets a copy of ``V``."""
    dev = resolve_device(device)
    return ArnoldiState(V=torch.as_tensor(np.array(V), device=dev),
                        step=int(np.asarray(step)),
                        alive=torch.as_tensor(np.array(alive, bool),
                                              device=dev))


def continuous_problem_from_arrays(Omega, dfA, lb, ub,
                                   budget) -> ContinuousProblem:
    """``ContinuousProblem`` from the JAX problem's fields (host arrays)."""
    return ContinuousProblem(Omega=np.array(Omega, np.int64),
                             dfA=np.array(dfA, np.float64),
                             lb=np.array(lb, np.float64),
                             ub=np.array(ub, np.float64),
                             budget=float(budget))
