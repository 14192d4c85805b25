"""Kernels: the four sweep kernels' share of their roofline together, in
%: the bounds of their traced launches summed over the kernels, over
their summed traced device time.  A launch's bound is opmodels.bound_s of
its model on the traced state; a kernel launches once per pattern bucket
in turn, so each of its launches is given the mean bound of its buckets.
Nothing when the trace holds no launch of a kernel with a model; a share
above 100 means the models count more than the kernels do, and is
refused (as metrics/_roofline.py refuses one kernel's)."""

from benchmark import opmodels
from benchmark.trace_reduce import KERNELS


def read(ctx):
    bound_s = time_s = 0.0
    for name in KERNELS:
        times = ctx["trace"].kernel_us.get(name) or []
        per_launch = ctx["models"].get(name.removesuffix("_kernel"))
        if not times or not per_launch:
            continue
        bounds = [opmodels.bound_s(nbytes, ops, ctx["dtype"])
                  for nbytes, ops in per_launch]
        bound_s += sum(bounds) / len(bounds) * len(times)
        time_s += sum(times) / 1e6
    if not time_s:
        return None
    value = 100.0 * bound_s / time_s
    if value > 100.0:
        raise ValueError(f"kernels: roofline share {value} above 100%")
    return {"value": value, "unit": "%"}
