"""Host milliseconds the window's sweeps spent choosing their Q + k
candidates, over the edges committed in the window: 1e3 ·
Δ``sweep.candidates_s`` / edges, the program's counter of the time in
``kr:sweep.candidates`` (``find_top_edges`` in break mode,
``find_top_missing_edges`` in make mode), for the cells that report
``s_per_edge.hub``. A program without the counter reads nothing. Layer:
sweep (``optimize/greedy.py``)."""

from benchmark.program import counters, since

SPANS = {}
AT_LOAD = counters()  # the window's start: readers load after the set-up


def read(ctx):
    grew = since(AT_LOAD)
    units = ctx.readings.get("units", 0)
    if not grew or "sweep.candidates_s" not in grew or not units or \
            ctx.readings.get("unit") != "edge":
        return None
    return 1e3 * grew["sweep.candidates_s"] / units
