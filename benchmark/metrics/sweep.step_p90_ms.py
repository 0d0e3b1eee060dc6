"""90th percentile of the committed edges' step times over the window, in
ms (``GreedyResult.per_step_time`` as the sweep reports it: the host clock
from a step's start to its commit; a fused block's edges share its time),
leaving out the edges of the profiled stretch, which the profiler slows.
Layer: sweep (``optimize/greedy.py``)."""

import numpy as np

from benchmark.layers import SWEEP as SPANS


def read(ctx):
    first, last = ctx.profiled
    times = [t for i, t in enumerate(ctx.readings.get("step_times_s", []))
             if not first <= i < last]
    if not times:
        return None
    return float(np.percentile(np.asarray(times) * 1e3, 90))
