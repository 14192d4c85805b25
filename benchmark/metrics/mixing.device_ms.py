"""Plain tensor code (kernels/mixing.py, ops/likelihood_cache.py): the
device time of the operations enqueued inside the mixing spans, in ms per
traced iteration (metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "mixing", "device_ms")
