"""Share of the candidate block steps the device ran in the window that the
scorer's lag test used, in %: 100 · Δ``krylov.steps_used`` /
Δ``krylov.steps_run``, the program's counters over the window. A step is
used up to the round at which its candidate was accepted (or the last
round it ran); the rest is the speculated rounds and the batch's converged
candidates carried along. Layer: Krylov (``krylov/lanczos.py``,
``updates/trace_update.py``)."""

from benchmark.program import counters, since

SPANS = {}
AT_LOAD = counters()  # the window's start: readers load after the set-up


def read(ctx):
    grew = since(AT_LOAD)
    if not grew or not grew.get("krylov.steps_run"):
        return None
    return 100.0 * grew.get("krylov.steps_used", 0) / \
        grew["krylov.steps_run"]
