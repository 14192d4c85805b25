"""Plain tensor code (kernels/scalar_params.py): the device time of the
operations enqueued inside the theta and mig_rate spans, in ms per traced
iteration (metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "scalars", "device_ms")
