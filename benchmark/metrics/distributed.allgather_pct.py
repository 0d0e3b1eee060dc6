"""Share of the traced solve's wall time spent in the row-sharded
operator's all-gathers, in %. Layer: distributed
(``parallel/spmm_sharded.py``)."""

from benchmark.layers import SPMM as SPANS


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.outermost("distributed"):
        return None
    return 100.0 * t.host_s("distributed") / t.window_s
