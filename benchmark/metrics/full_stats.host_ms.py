"""Plain tensor code (ops/coalstats.py, kernels/common.py): the host time in
the full_stats spans (the statistics pass, its log priors and the prior
refresh), in ms per traced iteration (metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "full_stats", "host_ms")
