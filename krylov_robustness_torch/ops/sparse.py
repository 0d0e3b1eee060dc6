"""Sparse COO container and the fill-free plain SpMM.

Port of ``krylov_robustness_tpu/ops/sparse.py``. ``coo_spmm`` (gather +
``index_add_``) serves the ``coo`` greedy backend, the dense n ≤ 130 path
(via :meth:`CooMatrix.todense`) and is the oracle the super-tile kernels are
held against. Replaces MATLAB's built-in sparse ``A*w``
(``lanczos_krylov.m:81``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.device import float_dtype, resolve_device


@dataclasses.dataclass(frozen=True)
class CooMatrix:
    """Square sparse matrix in row-sorted (CSR-order) COO layout."""

    rows: torch.Tensor  # (nnz,) int64, ascending
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz,) float
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

    @staticmethod
    def from_scipy(A, *, dtype=torch.float64, device) -> "CooMatrix":
        A = sp.coo_matrix(A)
        if A.shape[0] != A.shape[1]:
            raise ValueError("matrix must be square")
        dev = resolve_device(device)
        order = np.lexsort((A.col, A.row))
        return CooMatrix(
            rows=torch.as_tensor(A.row[order].astype(np.int64), device=dev),
            cols=torch.as_tensor(A.col[order].astype(np.int64), device=dev),
            vals=torch.as_tensor(A.data[order], device=dev).to(
                float_dtype(dtype)),
            n=A.shape[0],
            nnz=len(order),
        )

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix(
            (self.vals.cpu().numpy(),
             (self.rows.cpu().numpy(), self.cols.cpu().numpy())),
            shape=self.shape)

    def todense(self) -> torch.Tensor:
        out = torch.zeros((self.n, self.n), dtype=self.dtype,
                          device=self.device)
        return out.index_put_((self.rows, self.cols), self.vals,
                              accumulate=True)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        return coo_spmm(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return coo_spmm(self, x)


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
