"""Initialization (sampler/init.py, Sampler.initialize): the harness's
span around `initialize()`, ending in a synchronize, in seconds."""


def read(ctx):
    return {"value": ctx["spans"]["init_s"], "unit": "s"}
