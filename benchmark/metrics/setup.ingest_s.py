"""Host ingest (io/sequences.py, io/native.py, io/patterns.py): the
harness's span around `Sampler(cfg, seq_path=...)`, in seconds."""


def read(ctx):
    return {"value": ctx["spans"]["ingest_s"], "unit": "s"}
