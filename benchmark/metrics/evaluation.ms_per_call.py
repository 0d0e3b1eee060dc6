"""Host milliseconds of one objective-and-gradient evaluation, over the
calls of the traced solve. Layer: evaluations
(``optimize/continuous.py::fun_and_grad``)."""

from benchmark.layers import EVALUATION as SPANS


def read(ctx):
    t = ctx.trace
    calls = t.outermost("evaluation") if t is not None else []
    return 1e3 * t.host_s("evaluation") / len(calls) if calls else None
