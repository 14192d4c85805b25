"""Iteration layer: kernel launches (cudaLaunchKernel and its kin in the
profiler's runtime events) per traced iteration."""


def read(ctx):
    t = ctx["trace"]
    if not t.launches:
        return None
    return {"value": t.launches / t.iters, "unit": "launches/it"}
