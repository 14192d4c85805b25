"""A kernel's share of its roofline: the bound of one sweep on the traced
state (opmodels.py: per launch, the larger of bytes over HBM bandwidth and
operations over the float peak; a sweep launches the kernel once per
pattern bucket) over the kernel's device time per sweep (its mean time per
launch times the launches of a sweep), in %.  Nothing when the trace holds
no launch of the kernel.  A share above 100 means the model counts more
than the kernel does, and is refused."""

from benchmark import opmodels


def share(ctx, kernel: str):
    times = ctx["trace"].kernel_us.get(kernel + "_kernel") or []
    per_launch = ctx["models"].get(kernel)
    if not times or not per_launch:
        return None
    bound = sum(opmodels.bound_s(nbytes, ops, ctx["dtype"])
                for nbytes, ops in per_launch)
    sweep_s = sum(times) / len(times) * len(per_launch) / 1e6
    value = 100.0 * bound / sweep_s
    if value > 100.0:
        raise ValueError(f"{kernel}: roofline share {value} above 100%")
    return {"value": value, "unit": "%"}
