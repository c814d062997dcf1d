"""device.idle.closed: the share of the traced window in which no operation
ran on the device (closed-loop serving cells): 1 - the union of the device ops' intervals
over the window, from torch.profiler."""

from benchmark.devtrace import idle_percent

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "queries_per_s"


def read(ctx):
    return idle_percent(ctx.observed.profile)
