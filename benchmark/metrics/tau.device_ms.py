"""The tau rubber band (kernels/tau.py, rubber_band.cu): the device time of
the operations enqueued inside the tau spans, in ms per traced iteration
(metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "tau", "device_ms")
