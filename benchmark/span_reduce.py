"""From a torch.profiler trace of the traced window to one row per span of
the program: the host ranges "gphocs.<name>" that
gphocs_tpu_torch/profiling.span records around each update family of the
iteration, on the host clock that the trace shares with the device.

An event is (name, on_device, start_us, end_us, correlation):
trace_reduce's four fields and the id that ties a device operation to the
runtime call that enqueued it (0 where the profiler gives none).
`events(prof)` makes them from a finished torch.profiler.profile.

Rows, so that nothing is counted twice:
  * partition rows: the families (node_age ... sums, and chunk_totals),
    the self part of the two containers, chunk and iteration (what falls
    inside the span and inside none of its child spans), and "(outside)",
    where no span is open.  At each instant of the host's timeline one
    of them is open, so together they split the window's host time, and
    whatever is put down to a host instant: device time, launches, syncs,
    idle gaps;
  * nested rows, prepare and rng_hash: parts of the row open around them,
    which keeps them too.

Each row, per traced iteration:
  * calls: spans of the name (0 for "(outside)");
  * host_ms: the host time in which the row is open;
  * device_ms: the durations of the device operations enqueued while the
    row was open, each matched to its runtime call by the correlation id
    and counted at that call's start; kernel_ms, the part of it spent in
    the four hand-written kernels (trace_reduce.KERNELS);
  * launches and syncs: the calls of trace_reduce.LAUNCHES and SYNCS that
    start in the row; `sites` counts the syncs by the innermost ATen
    operator open around them;
  * idle_ms: the device's idle gaps between its operations (the
    arithmetic of trace_reduce.idle_gaps, every gap), each at the row open
    on the host at the gap's middle.

A hand-written kernel with no correlated runtime call (they are launched
through ctypes, ops/cuda_lib.launch) falls to the launch-order rule: node
age, migration age and SPR in their own family, and the k-th rubber band
in the family of the k-th prepare span opened inside tau or sample_age.
Any other device operation without its call goes to "(unmatched)".
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import Dict, List, Optional, Tuple

from benchmark.trace_reduce import LAUNCHES, SYNCS, kernel_of

PREFIX = "gphocs."
NESTED = ("prepare", "rng_hash")
OUTSIDE = "(outside)"
UNMATCHED = "(unmatched)"
# the runtime calls that enqueue a device operation
ENQUEUES = LAUNCHES | {"cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
                       "cudaMemset"}
# a rubber band launched without a correlated call belongs to the family
# of the prepare span that preceded it
RUBBER_BAND_FAMILIES = ("tau", "sample_age")

Event = Tuple[str, bool, float, float, int]


def events(prof) -> List[Event]:
    """The events of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA,
             e.start_ns() / 1e3, e.end_ns() / 1e3, e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


class Timeline:
    """The innermost of properly nested intervals (a, b, label) open at
    each instant: a step function over time, None where none is open.  An
    interval that ends after the one around it is cut at its end."""

    def __init__(self, intervals):
        self.times, self.labels = [], []
        stack = []                       # (end, label), innermost last
        for a, b, label in sorted(intervals, key=lambda x: (x[0], -x[1])):
            self._close(stack, a)
            if stack:
                b = min(b, stack[-1][0])
            stack.append((b, label))
            self._step(a, label)
        self._close(stack, float("inf"))

    def _close(self, stack, t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            self._step(end, stack[-1][1] if stack else None)

    def _step(self, t, label):
        self.times.append(t)
        self.labels.append(label)

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.labels[i] if i >= 0 else None

    def durations(self, start: float, end: float) -> Dict[Optional[str],
                                                          float]:
        """Time in [start, end] under each label."""
        out: Dict[Optional[str], float] = {}
        edges = [start] + [min(max(t, start), end) for t in self.times] + [end]
        labels = [None] + self.labels
        for a, b, label in zip(edges, edges[1:], labels):
            out[label] = out.get(label, 0.0) + (b - a)
        return out


def _row(kind: str) -> dict:
    return {"kind": kind, "calls": 0, "host_ms": 0.0, "device_ms": 0.0,
            "kernel_ms": 0.0, "launches": 0, "syncs": 0, "idle_ms": 0.0,
            "sites": Counter()}


def reduce(evs: List[Event], iters: int) -> dict:
    """{"iters", "rows": {name: row}, "matched": {rule: operations},
    "annotations": device events named like a span}; every number of a
    row per traced iteration (the module's docstring)."""
    host = [e for e in evs if not e[1]]
    spans = [(a, b, n[len(PREFIX):]) for n, _, a, b, _ in host
             if n.startswith(PREFIX)]
    dev = [e for e in evs if e[1] and not e[0].startswith(PREFIX)]
    outer = Timeline((a, b, n) for a, b, n in spans if n not in NESTED)
    inner = Timeline((a, b, n) for a, b, n in spans if n in NESTED)
    aten = Timeline((a, b, n) for n, _, a, b, _ in host
                    if n.startswith("aten::"))
    rows: Dict[str, dict] = {}

    def row(name, kind="partition"):
        if name not in rows:
            rows[name] = _row(kind)
        return rows[name]

    def rows_at(t):
        out = [row(outer.at(t) or OUTSIDE)]
        n = inner.at(t)
        if n is not None:
            out.append(row(n, "nested"))
        return out

    for _, _, n in spans:
        row(n, "nested" if n in NESTED else "partition")["calls"] += 1
    if not evs:
        return {"iters": iters, "rows": {}, "matched": {}, "annotations": 0}
    start = min(e[2] for e in evs)
    end = max(e[3] for e in evs)
    for tl, kind in ((outer, "partition"), (inner, "nested")):
        for n, us in tl.durations(start, end).items():
            if n is None and kind == "nested":
                continue
            row(n or OUTSIDE, kind)["host_ms"] += us / 1e3

    for n, _, a, _, _ in host:
        is_launch, is_sync = n in LAUNCHES, n in SYNCS
        if not (is_launch or is_sync):
            continue
        for r in rows_at(a):
            r["launches"] += is_launch
            if is_sync:
                r["syncs"] += 1
                r["sites"][aten.at(a) or "(no ATen operator)"] += 1

    calls = {c: a for n, _, a, _, c in host if n in ENQUEUES and c}
    band_prepares = [outer.at(a) for a, _, n in sorted(spans)
                     if n == "prepare"
                     and outer.at(a) in RUBBER_BAND_FAMILIES]
    matched = Counter()
    bands = 0
    for n, _, a, b, c in sorted(dev, key=lambda e: e[2]):
        k = kernel_of(n)
        if c in calls:
            targets, rule = rows_at(calls[c]), "correlation"
        elif k in ("node_age_kernel", "mig_age_kernel", "spr_kernel"):
            targets, rule = [row(k[:-len("_kernel")])], "launch_order"
        elif k == "rubber_band_kernel" and bands < len(band_prepares):
            targets, rule = [row(band_prepares[bands])], "launch_order"
        else:
            targets, rule = [row(UNMATCHED)], "unmatched"
        if k == "rubber_band_kernel":
            bands += 1
        matched[rule] += 1
        for r in targets:
            r["device_ms"] += (b - a) / 1e3
            if k:
                r["kernel_ms"] += (b - a) / 1e3

    busy_end = None
    for a, b in sorted((e[2], e[3]) for e in dev):
        if busy_end is not None and a > busy_end:
            row(outer.at((a + busy_end) / 2) or OUTSIDE)["idle_ms"] += \
                (a - busy_end) / 1e3
        busy_end = b if busy_end is None else max(busy_end, b)

    for r in rows.values():
        for f in ("calls", "host_ms", "device_ms", "kernel_ms", "launches",
                  "syncs", "idle_ms"):
            r[f] /= iters
        r["sites"] = {s: v / iters for s, v in r["sites"].most_common()}
    return {"iters": iters, "rows": rows, "matched": dict(matched),
            "annotations": sum(e[1] and e[0].startswith(PREFIX)
                               for e in evs)}


def totals(program: dict) -> dict:
    """The partition rows' sums (with "(unmatched)"), per iteration."""
    part = [r for r in program["rows"].values() if r["kind"] == "partition"]
    return {f: sum(r[f] for r in part)
            for f in ("host_ms", "device_ms", "kernel_ms", "launches",
                      "syncs", "idle_ms")}


def table(program: dict) -> str:
    """The rows as text, partition rows by host time, nested rows last."""
    head = (f"{'span':<14}{'calls':>7}{'host ms':>10}{'device ms':>11}"
            f"{'kernels':>9}{'launches':>10}{'syncs':>7}{'idle ms':>9}"
            "  syncs by site (per iteration)")
    lines = [f"spans per traced iteration ({program['iters']} iterations; "
             f"device operations matched by {program['matched']})", head]
    order = sorted(program["rows"].items(),
                   key=lambda kv: (kv[1]["kind"] != "partition",
                                   -kv[1]["host_ms"]))
    for name, r in order + [("(sum)", dict(totals(program), calls=0,
                                           kind="", sites={}))]:
        sites = ", ".join(f"{s} {v:g}" for s, v in r["sites"].items())
        lines.append(f"{name:<14}{r['calls']:>7.2f}{r['host_ms']:>10.3f}"
                     f"{r['device_ms']:>11.4f}{r['kernel_ms']:>9.4f}"
                     f"{r['launches']:>10.2f}{r['syncs']:>7.2f}"
                     f"{r['idle_ms']:>9.3f}  {sites}")
    return "\n".join(lines)
