"""Plain tensor code (ops/coalstats.py, kernels/common.py): the device time
of the operations enqueued inside the full_stats spans (the statistics pass,
its log priors and the prior refresh), in ms per traced iteration
(metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "full_stats", "device_ms")
