"""Kernel argument blocks (ops/sweeps.prepare_*): the host time in the
prepare spans (also counted in their families), in ms per traced iteration
(metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "prepare", "host_ms")
