"""Sparse containers and the fill-free plain SpMMs.

Port of ``krylov_robustness_tpu/ops/sparse.py``. ``coo_spmm`` (gather +
``index_add_``) serves the ``coo`` greedy backend, the dense n ≤ 130 path
(via :meth:`CooMatrix.todense`) and is the oracle the super-tile kernels are
held against. ``ell_spmm`` is the padded-ELL product (K slot gathers and one
``einsum``), plain torch as it is XLA in the JAX package. Replaces MATLAB's
built-in sparse ``A*w`` (``lanczos_krylov.m:81``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import tracing
from ..utils.device import float_dtype, resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CooMatrix:
    """Square sparse matrix in row-sorted (CSR-order) COO layout. Padding
    entries past ``nnz`` carry val 0 at (0, 0), so they add nothing to
    products."""

    rows: torch.Tensor  # (nnz_pad,) int64, ascending over the first nnz
    cols: torch.Tensor  # (nnz_pad,) int64
    vals: torch.Tensor  # (nnz_pad,) float
    n: int
    nnz: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def astype(self, dtype) -> "CooMatrix":
        return dataclasses.replace(self, vals=self.vals.to(float_dtype(dtype)))

    @staticmethod
    def from_scipy(A, *, dtype=torch.float64, device,
                   pad_to: int = 1) -> "CooMatrix":
        """``pad_to`` > 1 pads the entries to a multiple of it (at least one
        multiple) with val-0 entries at (0, 0), as the JAX package does with
        its default 8; the port's default keeps exactly the nnz entries."""
        A = sp.coo_matrix(A)
        if A.shape[0] != A.shape[1]:
            raise ValueError("matrix must be square")
        dev = resolve_device(device)
        order = np.lexsort((A.col, A.row))
        nnz = len(order)
        pad = (max(_round_up(nnz, pad_to), pad_to) - nnz) if pad_to > 1 else 0
        rows, cols, vals = (np.pad(a[order], (0, pad))
                            for a in (A.row, A.col, A.data))
        return CooMatrix(
            rows=torch.as_tensor(rows.astype(np.int64), device=dev),
            cols=torch.as_tensor(cols.astype(np.int64), device=dev),
            vals=torch.as_tensor(vals, device=dev).to(float_dtype(dtype)),
            n=A.shape[0],
            nnz=nnz,
        )

    @staticmethod
    def from_edges(edges, n: int, weights=None, symmetrize: bool = True, *,
                   dtype=torch.float64, device) -> "CooMatrix":
        """Build from an (e, 2) edge array (no self-loop handling here)."""
        e = np.asarray(edges)
        w = np.ones(len(e)) if weights is None else np.asarray(weights)
        A = sp.coo_matrix((w, (e[:, 0], e[:, 1])), shape=(n, n))
        if symmetrize:
            A = A + A.T
        return CooMatrix.from_scipy(A.tocsr(), dtype=dtype, device=device)

    def to_scipy(self) -> sp.csr_matrix:
        k = self.nnz
        return sp.csr_matrix(
            (self.vals[:k].cpu().numpy(),
             (self.rows[:k].cpu().numpy(), self.cols[:k].cpu().numpy())),
            shape=self.shape)

    def host_coo(self):
        """(rows, cols, vals) as numpy: the view that the host plan builders
        read, shared with the row-sharded operator."""
        return tuple(t.cpu().numpy() for t in (self.rows, self.cols,
                                                self.vals))

    def todense(self) -> torch.Tensor:
        out = torch.zeros((self.n, self.n), dtype=self.dtype,
                          device=self.device)
        return out.index_put_((self.rows, self.cols), self.vals,
                              accumulate=True)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.spmm_span(self, x):
            return coo_spmm(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmul(x)

    def transpose(self) -> "CooMatrix":
        # as in the JAX package: the matrices are symmetric in almost all
        # uses; build Aᵀ from scipy where one is needed
        raise NotImplementedError(
            "CooMatrix.transpose is unsupported; build A^T with scipy")


def coo_spmm(A: CooMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape (n, b) or (n,): gather the x rows of every
    entry, scale, and ``index_add_`` them into their output rows."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    contrib = A.vals[:, None].to(x.dtype) * x.index_select(0, A.cols)
    y = torch.zeros((A.n, x.shape[1]), dtype=x.dtype, device=x.device)
    y.index_add_(0, A.rows, contrib)
    return y[:, 0] if squeeze else y


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded-ELL layout: ``K`` column slots per row. ``cols[i, k]`` is the
    column of the k-th stored entry of row i (0 for padding), ``vals[i, k]``
    its value (0 for padding); rows are padded to ``n_pad``, a multiple of
    ``row_pad``."""

    cols: torch.Tensor  # (n_pad, K) int64
    vals: torch.Tensor  # (n_pad, K) float
    n: int
    nnz: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def n_pad(self) -> int:
        return self.cols.shape[0]

    @property
    def slots(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @staticmethod
    def from_scipy(A, *, dtype=torch.float64, device,
                   row_pad: int = 8) -> "EllMatrix":
        A = sp.csr_matrix(A)
        n = A.shape[0]
        deg = np.diff(A.indptr)
        K = max(int(deg.max()) if n else 1, 1)
        n_pad = max(_round_up(n, row_pad), row_pad)
        rows = np.repeat(np.arange(n), deg)
        ks = np.arange(A.nnz) - A.indptr[rows]
        cols = np.zeros((n_pad, K), np.int64)
        vals = np.zeros((n_pad, K), np.float64)
        cols[rows, ks] = A.indices
        vals[rows, ks] = A.data
        dev = resolve_device(device)
        return EllMatrix(cols=torch.as_tensor(cols, device=dev),
                         vals=torch.as_tensor(vals, device=dev).to(
                             float_dtype(dtype)),
                         n=n, nnz=int(A.nnz))

    @property
    def padding_efficiency(self) -> float:
        """nnz / (n_pad·K): the fraction of slots doing useful work."""
        return self.nnz / float(self.cols.shape[0] * self.cols.shape[1])

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.spmm_span(self, x):
            return ell_spmm(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmul(x)


def ell_spmm(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with the ELL layout; x (n, b) → y (n, b), or (n,) → (n,)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, b = x.shape
    if A.n_pad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, A.n_pad - n))
    gathered = x[A.cols]  # (n_pad, K, b)
    y = torch.einsum("nk,nkb->nb", A.vals.to(x.dtype), gathered)[:A.n]
    return y[:, 0] if squeeze else y


SparseMatrix = Any  # CooMatrix | EllMatrix duck type


def spmm(A: SparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """Layout-dispatching SpMM."""
    return A.matmul(x)
