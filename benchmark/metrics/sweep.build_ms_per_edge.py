"""Host milliseconds the window's sweeps spent building, over the edges
committed in the window: 1e3 · Δ``sweep.build_s`` / edges, the program's
counter of the time from a sweep's start to its first step (top edges,
operator choice and build). Layer: sweep (``optimize/greedy.py``)."""

from benchmark.program import counters, since

SPANS = {}
AT_LOAD = counters()  # the window's start: readers load after the set-up


def read(ctx):
    grew = since(AT_LOAD)
    units = ctx.readings.get("units", 0)
    if not grew or "sweep.build_s" not in grew or not units or \
            ctx.readings.get("unit") != "edge":
        return None
    return 1e3 * grew["sweep.build_s"] / units
