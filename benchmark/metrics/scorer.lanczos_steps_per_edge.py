"""Mean Krylov block steps of the committed edges' scores over the window
(``GreedyResult.per_step_iters``, a count). Layer: scorer
(``updates/trace_update.py``)."""

import numpy as np

from benchmark.layers import SCORER as SPANS


def read(ctx):
    steps = ctx.readings.get("lanczos_steps")
    return float(np.mean(steps)) if steps else None
