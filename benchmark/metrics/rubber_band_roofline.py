"""Kernels: rubber_band_kernel's share of its roofline, averaged over its
launches in the traced window (metrics/_roofline.py)."""

from benchmark.metrics._roofline import share


def read(ctx):
    return share(ctx, "rubber_band")
