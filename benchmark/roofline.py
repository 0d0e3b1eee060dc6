"""The least time a sparse product y = A·x can take on one NVIDIA H100 SXM,
from the shapes alone (NVIDIA's data sheet, 700 W: 3.35 TB/s of HBM; 67
TFLOP/s in FP32 and 34 in FP64 outside the tensor cores).

The bytes count A as CSR in the product's value type (a value and an int32
column index a nonzero, n + 1 int32 row pointers), x read once and y
written once; the operations are 2·nnz·b. Whatever format or kernel
implements the product, this is the work it has to do, so no
implementation can run under the bound.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67.0e12, 8: 34.0e12}  # by value size: FFMA, DFMA


def function_bytes(n: int, nnz: int, b: int, value_size: int,
                   x_size: int) -> int:
    """Bytes y = A·x must move for an n × n A with ``nnz`` stored entries
    and an (n, b) x: CSR values and column indices, row pointers, x once,
    y once."""
    return nnz * (value_size + 4) + (n + 1) * 4 + 2 * n * b * x_size


def least_time_s(n: int, nnz: int, b: int, value_size: int,
                 x_size: int) -> tuple[float, str]:
    """(seconds, 'bytes' or 'operations'): the larger of the bytes at the
    HBM rate and 2·nnz·b at the peak of the value type."""
    t_bytes = function_bytes(n, nnz, b, value_size, x_size) / HBM_BYTES_PER_S
    t_ops = 2.0 * nnz * b / PEAK_FLOPS[max(4, value_size)]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
