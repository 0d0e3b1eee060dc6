"""Share of the weighted cell's traced solve in which the device ran no
kernel, copy or memset, in %. Layer: device (H100)."""

from benchmark.layers import device_idle_pct

SPANS = {}


def read(ctx):
    return device_idle_pct(ctx.trace)
