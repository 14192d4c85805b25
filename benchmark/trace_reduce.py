"""From a torch.profiler trace of the traced window to the numbers that
the per-layer metrics read.

An event is (name, on_device, start_us, end_us).  Device events are the
kernels and copies that ran on the card; host events are the CUDA runtime
calls (cudaLaunchKernel, cudaStreamSynchronize, ...) and, where the host
was traced, PyTorch's operators.  The device is busy over the union of its
events' time ranges (summing them would count overlaps twice: the
arithmetic of the port's tools/profile_main.py, copied here), and idle
over the rest of the window's wall time.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"})
# calls after which the host waits for the device: synchronizations and
# the blocking copy
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cuStreamSynchronize",
                   "cuCtxSynchronize", "cudaMemcpy"})
# the hand-written kernels (csrc/*.cu); every other device operation is
# the plain tensor code's, or a copy
KERNELS = ("node_age_kernel", "mig_age_kernel", "rubber_band_kernel",
           "spr_kernel")

Event = Tuple[str, bool, float, float]


def union_us(spans) -> float:
    """The length of the union of (start, end) spans."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def kernel_of(name: str) -> Optional[str]:
    for k in KERNELS:
        if k in name:
            return k
    return None


def short(name: str) -> str:
    """A device operation's name without its template arguments and
    parameter list."""
    return name.split("(")[0].split("<")[0].strip()[:80] or name[:80]


@dataclass
class Summary:
    iters: int
    wall_s: float
    busy_s: float
    launches: int
    syncs: int
    device_events: int
    kernel_us: Dict[str, List[float]] = field(default_factory=dict)
    tensor_code_busy_s: float = 0.0
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def summarize(events: List[Event], iters: int, wall_s: float,
              top: int = 10) -> Summary:
    dev = [(a, b, n) for n, d, a, b in events if d]
    host = [(a, b, n) for n, d, a, b in events if not d]
    kernel_us: Dict[str, List[float]] = {k: [] for k in KERNELS}
    plain = []
    by_name: Dict[str, float] = {}
    for a, b, n in dev:
        k = kernel_of(n)
        if k:
            kernel_us[k].append(b - a)
        else:
            plain.append((a, b))
        by_name[short(n)] = by_name.get(short(n), 0.0) + (b - a)
    s = Summary(
        iters=iters, wall_s=wall_s,
        busy_s=union_us((a, b) for a, b, _ in dev) / 1e6,
        launches=sum(n in LAUNCHES for _, _, n in host),
        syncs=sum(n in SYNCS for _, _, n in host),
        device_events=len(dev), kernel_us=kernel_us,
        tensor_code_busy_s=union_us(plain) / 1e6)
    s.device_ops = [[n, t / 1e6] for n, t in sorted(
        by_name.items(), key=lambda x: -x[1])[:top]]
    s.idle_gaps = idle_gaps(dev, host, top)
    return s


def idle_gaps(dev, host, top: int = 10, scan: int = 2000) -> List[list]:
    """The idle gaps between device operations, summed by what the host
    was doing at each gap's middle (the innermost host event open there),
    the longest `top` names.  Only the `scan` longest gaps are named."""
    spans = sorted((a, b) for a, b, _ in dev)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, reverse=True)[:scan]
    host = sorted(host)
    starts = [a for a, _, _ in host]
    total: Dict[str, float] = {}
    for length, a, b in gaps:
        mid = (a + b) / 2
        name = "(no host event)"
        j = bisect.bisect_right(starts, mid)
        i = j - 1
        while i >= max(0, j - 400):
            if host[i][1] >= mid:
                name = host[i][2]
                break
            i -= 1
        total[name] = total.get(name, 0.0) + length / 1e6
    return [[n, t] for n, t in sorted(total.items(),
                                      key=lambda x: -x[1])[:top]]
