"""Kernels: spr_kernel's share of its roofline (metrics/_roofline.py)."""

from benchmark.metrics._roofline import share


def read(ctx):
    return share(ctx, "spr")
