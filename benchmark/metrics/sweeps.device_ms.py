"""Sweep wrappers (ops/sweeps.py, kernels/node_age.py, mig_age.py, spr.py):
the device time of the operations enqueued inside the node_age, mig_age and
spr spans, in ms per traced iteration (metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "sweeps", "device_ms")
