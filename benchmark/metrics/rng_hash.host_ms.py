"""Counter RNG (rng_fast.py): the host time in the rng_hash spans around
rng_fast.raw_bits (also counted in their families), in ms per traced
iteration (metrics/_spans.py)."""

from benchmark.metrics._spans import group_ms


def read(ctx):
    return group_ms(ctx, "rng_hash", "host_ms")
