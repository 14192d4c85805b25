"""The program's span rows (span_reduce.py), their readers
(metrics/_spans.py and the span metrics) and span_table.py's traced run
on the CPU."""

import json
import os

import pytest

from benchmark import harness, span_reduce, span_table, trace_reduce

# host, in us: chunk [0, 100] > iteration [5, 90] > node_age [10, 20] >
# prepare; tau [25, 50] > prepare, a copy and a sync under .item();
# mixing [55, 70] > rng_hash > one launch; sums [80, 88] > one launch;
# chunk_totals [91, 95]; outside the chunk, the read-back [100, 125]
EVENTS = [
    ("gphocs.chunk", False, 0.0, 100.0, 0),
    ("gphocs.iteration", False, 5.0, 90.0, 0),
    ("gphocs.node_age", False, 10.0, 20.0, 0),
    ("gphocs.prepare", False, 11.0, 13.0, 0),
    ("gphocs.tau", False, 25.0, 50.0, 0),
    ("gphocs.prepare", False, 26.0, 28.0, 0),
    ("aten::item", False, 41.0, 48.0, 1),
    ("aten::_local_scalar_dense", False, 42.0, 47.0, 2),
    ("cudaMemcpyAsync", False, 43.0, 44.0, 7),
    ("cudaStreamSynchronize", False, 44.0, 47.0, 0),
    ("gphocs.mixing", False, 55.0, 70.0, 0),
    ("gphocs.rng_hash", False, 56.0, 60.0, 0),
    ("aten::bitwise_and", False, 57.0, 59.0, 3),
    ("cudaLaunchKernel", False, 57.5, 58.5, 5),
    ("gphocs.sums", False, 80.0, 88.0, 0),
    ("cudaLaunchKernel", False, 81.0, 82.0, 6),
    ("gphocs.chunk_totals", False, 91.0, 95.0, 0),
    ("aten::copy_", False, 100.0, 125.0, 4),
    ("cudaMemcpyAsync", False, 101.0, 102.0, 8),
    ("cudaStreamSynchronize", False, 102.0, 124.0, 0),
    # device: the ctypes kernels without a correlated call, the rest
    # matched by correlation id (the hash's kernel runs after its span)
    ("void node_age_kernel<float>(SweepArgs)", True, 16.0, 26.0, 99),
    ("void rubber_band_kernel<float>(SweepArgs)", True, 30.0, 40.0, 0),
    ("Memcpy DtoH (Device -> Pinned)", True, 44.0, 45.0, 7),
    ("vectorized_elementwise_kernel<bitwise_and>", True, 75.0, 80.0, 5),
    ("reduce_kernel<sum>", True, 82.0, 84.0, 6),
    ("Memcpy DtoH (Device -> Pinned)", True, 120.0, 121.0, 8),
]
ITERS = 2


def test_rows_of_a_synthetic_trace():
    prog = span_reduce.reduce(EVENTS, ITERS)
    rows = prog["rows"]

    def per_it(us):
        return pytest.approx(us / 1e3 / ITERS)

    want = {  # name: (calls, host us, device us, kernel us, launches,
              #        syncs, idle us)
        "node_age": (1, 10, 10, 10, 0, 0, 0),
        "tau": (1, 25, 11, 10, 0, 1, 8),
        "mixing": (1, 15, 5, 0, 1, 0, 30),
        "sums": (1, 8, 2, 0, 1, 0, 2),
        "chunk_totals": (1, 4, 0, 0, 0, 0, 0),
        "iteration": (1, 85 - 58, 0, 0, 0, 0, 0),    # its self part
        "chunk": (1, 100 - 85 - 4, 0, 0, 0, 0, 0),
        "(outside)": (0, 25, 1, 0, 0, 1, 36),
        "prepare": (2, 4, 0, 0, 0, 0, 0),
        "rng_hash": (1, 4, 5, 0, 1, 0, 0),
    }
    assert set(rows) == set(want)
    for name, (calls, host, device, kern, launches, syncs, idle) in \
            want.items():
        r = rows[name]
        assert r["kind"] == ("nested" if name in span_reduce.NESTED
                             else "partition")
        assert r["calls"] == calls / ITERS, name
        assert (r["host_ms"], r["device_ms"], r["kernel_ms"],
                r["idle_ms"]) == (per_it(host), per_it(device),
                                  per_it(kern), per_it(idle)), name
        assert (r["launches"], r["syncs"]) == (launches / ITERS,
                                               syncs / ITERS), name
    assert rows["tau"]["sites"] == {"aten::_local_scalar_dense": 0.5}
    assert rows["(outside)"]["sites"] == {"aten::copy_": 0.5}
    assert prog["matched"] == {"correlation": 4, "launch_order": 2}
    # the partition rows split the window and what the trace counts
    s = trace_reduce.summarize([e[:4] for e in EVENTS], ITERS, 125e-6)
    tot = span_reduce.totals(prog)
    assert tot["host_ms"] == per_it(125)
    assert (tot["launches"], tot["syncs"]) == (s.launches / ITERS,
                                               s.syncs / ITERS)
    assert tot["device_ms"] == pytest.approx(s.busy_s * 1e3 / ITERS)
    assert tot["idle_ms"] == per_it(4 + 4 + 30 + 2 + 36)
    assert "tau" in span_reduce.table(prog)


def test_rubber_band_without_its_call_goes_to_the_family_that_prepared():
    ev = [("gphocs.iteration", False, 0.0, 50.0, 0),
          ("gphocs.tau", False, 1.0, 10.0, 0),
          ("gphocs.prepare", False, 2.0, 3.0, 0),
          ("gphocs.sample_age", False, 11.0, 20.0, 0),
          ("gphocs.prepare", False, 12.0, 13.0, 0),
          ("gphocs.mixing", False, 21.0, 30.0, 0),
          ("void rubber_band_kernel<float>(SweepArgs)", True, 5.0, 8.0, 0),
          ("void rubber_band_kernel<float>(SweepArgs)", True, 14.0, 19.0,
           0),
          ("Memset (Device)", True, 25.0, 26.0, 0)]
    rows = span_reduce.reduce(ev, 1)["rows"]
    assert rows["tau"]["kernel_ms"] == pytest.approx(3e-3)
    assert rows["sample_age"]["kernel_ms"] == pytest.approx(5e-3)
    assert rows["(unmatched)"]["device_ms"] == pytest.approx(1e-3)
    assert "mixing" in rows and rows["mixing"]["device_ms"] == 0.0


def test_readers_none_without_spans_and_zero_for_an_absent_family():
    readers = {n: harness.metric_reader(n) for n in span_table.SPAN_METRICS}
    no_spans = span_reduce.reduce([e for e in EVENTS
                                   if not e[0].startswith("gphocs.")], 1)
    for read in readers.values():
        assert read({}) is None
        assert read({"program": no_spans}) is None
    prog = span_reduce.reduce(EVENTS, ITERS)
    got = {n: read({"program": prog}) for n, read in readers.items()}
    assert all(v["unit"] == "ms/it" for v in got.values())
    assert got["scalars.host_ms"]["value"] == 0.0       # no theta, mig_rate
    assert got["full_stats.device_ms"]["value"] == 0.0
    assert got["sweeps.host_ms"]["value"] == pytest.approx(10e-3 / ITERS)
    assert got["tau.device_ms"]["value"] == pytest.approx(11e-3 / ITERS)
    assert got["prepare.host_ms"]["value"] == pytest.approx(4e-3 / ITERS)


def test_traced_run_on_the_cpu():
    """span_table's run of the harness at 12 loci: every span metric a
    number, the families inside the iterations, no sync outside a
    family, `correct` true."""
    config = dict(json.load(open(os.path.join(
        harness.HERE, "configs", "sample_1k.json"))), num_loci=12,
        locus_length=300)
    traffic = {"chains": 1, "chunk": 2, "warmup_chunks": 1,
               "trace_chunks": 1}
    out, prog, chk = span_table.traced_spans(config, traffic, 2 ** 31 + 5,
                                             device="cpu")
    assert out["correct"]
    assert set(span_table.SPAN_METRICS) <= set(out["metrics"])
    rows = prog["rows"]
    assert rows["iteration"]["calls"] == 1.0
    for name in ("node_age", "mig_age", "spr", "full_stats", "theta",
                 "tau", "mixing", "sums"):
        assert rows[name]["calls"] >= 1.0 and rows[name]["host_ms"] > 0
    assert rows["rng_hash"]["calls"] > 0
    assert chk["iteration_self_share"] < 0.05
    assert chk["iteration_self_syncs"] == 0
