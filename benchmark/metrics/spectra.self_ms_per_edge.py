"""Host milliseconds a committed edge spends in the projected spectra, less
any span nested in them, over the traced stretch: the f32 Sturm bisection
of the fused blocks (``ops/banded_eig.py``) and the host banded LAPACK of
the per-step scorer (``updates/trace_update.py``). Layer: spectra."""

from benchmark.layers import SPECTRA as SPANS


def read(ctx):
    t = ctx.trace
    if t is None or not t.units or not t.outermost("spectra"):
        return None
    return 1e3 * t.self_s("spectra") / t.units
