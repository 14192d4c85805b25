"""The tau rubber band (kernels/tau.py, rubber_band.cu): the host time in
the tau spans, in ms per traced iteration (metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "tau", "host_ms")
