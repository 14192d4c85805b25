"""Plain tensor code (ops/coalstats.py, ops/likelihood_cache.py,
ops/pruning.py, kernels/*.py, rng_fast.py): the union of the device time
ranges of every device operation other than the four hand-written
kernels, in ms per traced iteration."""


def read(ctx):
    t = ctx["trace"]
    if not t.device_events:
        return None
    return {"value": t.tensor_code_busy_s * 1e3 / t.iters, "unit": "ms/it"}
