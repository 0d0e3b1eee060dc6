"""Device milliseconds a committed edge spends in block Lanczos steps,
less their sparse products, over the traced stretch. Layer: Krylov
(``krylov/lanczos.py::lanczos_step``)."""

from benchmark.layers import KRYLOV, SPMM

SPANS = {**KRYLOV, **SPMM}


def read(ctx):
    t = ctx.trace
    if t is None or not t.units or not t.device or \
            not t.outermost("krylov"):
        return None
    return 1e3 * t.device_s("krylov", excluding=("spmm",)) / t.units
