"""MiB of device memory that one sweep's scored operator holds, over the
window: Δ``spmm.operator_bytes`` / Δ``sweep.builds`` / 2^20, the program's
counters of the bytes each build's operator holds (its values and index)
and of the builds. A program without the counters, or a window without a
build, reads nothing. Layer: SpMM (``ops/``, built in
``optimize/greedy.py``)."""

from benchmark.program import counters, since

SPANS = {}
AT_LOAD = counters()  # the window's start: readers load after the set-up


def read(ctx):
    grew = since(AT_LOAD)
    if not grew or "spmm.operator_bytes" not in grew or \
            not grew.get("sweep.builds"):
        return None
    return grew["spmm.operator_bytes"] / grew["sweep.builds"] / 2**20
