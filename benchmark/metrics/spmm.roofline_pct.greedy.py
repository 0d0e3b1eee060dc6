"""The greedy cells' sparse products against their roofline, in %: the least
time of each product from its n, nnz, b and value type, over the device
time of what it launched (``layers.spmm_roofline_pct``). Layer: SpMM
(``ops/bsr_super.py``, ``banded_spmm.py``, ``bsr.py``, ``sparse.py``)."""

from benchmark.layers import SPMM as SPANS, spmm_roofline_pct


def read(ctx):
    return spmm_roofline_pct(ctx.trace)
