"""Objective-and-gradient evaluations a solve makes, over the window's
solves (a count). Layer: optimizer
(``optimize/continuous.py::optimize_weights``, scipy trust-constr)."""

from benchmark.layers import EVALUATION, OPTIMIZER

SPANS = {**EVALUATION, **OPTIMIZER}


def read(ctx):
    units = ctx.readings.get("units", 0)
    if not units or ctx.readings.get("unit") != "solve":
        return None
    return ctx.counts.get("evaluation", 0) / units or None
