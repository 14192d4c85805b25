"""A group of the program's spans inside the traced iterations
(benchmark/span_reduce.py's rows, `ctx["program"]`): the sum of one field
over the group's rows, in ms per traced iteration.  A span that did not
run in the traced chunk adds 0.0; nothing when the trace holds no
gphocs.iteration span (a program without spans)."""

GROUPS = {
    "sweeps": ("node_age", "mig_age", "spr"),
    "full_stats": ("full_stats",),
    "scalars": ("theta", "mig_rate"),
    "tau": ("tau",),
    "mixing": ("mixing",),
    "rng_hash": ("rng_hash",),      # nested: also in its family's numbers
    "prepare": ("prepare",),        # nested
}


def group_ms(ctx, group: str, field: str):
    rows = (ctx.get("program") or {}).get("rows", {})
    if not rows.get("iteration", {}).get("calls"):
        return None
    return {"value": sum((rows[n][field] for n in GROUPS[group] if n in rows),
                         0.0), "unit": "ms/it"}
