"""The weighted cell's sparse products against their roofline, in %
(``layers.spmm_roofline_pct``: the least time from n, nnz, b and the value
type over the device time each launched, less its all-gathers). Layer:
SpMM (``ops/sparse.py``, ``parallel/spmm_sharded.py``)."""

from benchmark.layers import SPMM as SPANS, spmm_roofline_pct


def read(ctx):
    return spmm_roofline_pct(ctx.trace)
