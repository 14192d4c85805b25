"""Plain tensor code (kernels/mixing.py, ops/likelihood_cache.py): the host
time in the mixing spans, in ms per traced iteration (metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "mixing", "host_ms")
