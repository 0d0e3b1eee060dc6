"""The program's own counters as the per-layer readers take them
(``krylov_robustness_torch/utils/tracing.py``: plain numbers, always on).

A reader takes the counters when it is loaded, which the harness does after
the set-up and just before the window, in traced runs only; it reads the
difference when it is read, after the window. A program without the
tracing module has no counters, and its readers read nothing.
"""

from __future__ import annotations

import importlib


def counters() -> dict | None:
    """The program's counters now; None if it keeps none."""
    try:
        tracing = importlib.import_module(
            "krylov_robustness_torch.utils.tracing")
    except ImportError:
        return None
    return tracing.counters()


def since(before: dict | None) -> dict | None:
    """How far each counter grew since ``before``; None if the program
    keeps no counters."""
    now = counters()
    if before is None or now is None:
        return None
    return {k: v - before.get(k, 0) for k, v in now.items()}
