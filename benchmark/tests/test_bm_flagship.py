"""The paper-scale configuration, flagship_37k, under its traffic, c4:
its stated scale, `correct` on a run of the harness at a CPU size (four
chains, as the cell runs them) with the bfloat16 control failing there,
and the kernels' roofline share that the cell reports
(metrics/kernels_roofline.py) on a synthetic trace."""

import os

import pytest

from benchmark import harness, opmodels, trace_reduce
from benchmark.metrics import kernels_roofline
from benchmark.reference import judge


CONFIG = harness.load_json(harness.HERE, "configs", "flagship_37k.json")
TRAFFIC = harness.load_json(harness.HERE, "traffic", "c4.json")


def test_configuration_states_the_papers_scale():
    assert CONFIG["num_loci"] == 37574 and CONFIG["locus_length"] == 1000
    assert CONFIG["reduced"] == []
    assert os.path.isfile(os.path.join(harness.HERE, "configs",
                                       CONFIG["control"]))
    assert tuple(CONFIG["limits"]) == judge.ORDER
    assert {"tree", "data", "chains", "dtype"} <= set(CONFIG["assumed"])
    assert TRAFFIC["chains"] == 4
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}["flagship_37k.c4"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "flagship_37k", "c4", 1)


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_small_run_is_correct_and_control_is_not(trace):
    """12 loci of 300 bp, chunks of 2, four chains: the program is
    correct under the configuration's limits and the control is not; on
    the CPU no kernel launches, so the kernels' share reads nothing."""
    small = dict(CONFIG, num_loci=12, locus_length=300)
    traffic = dict(TRAFFIC, chunk=2)
    res = harness.run_cell(small, traffic, 2 ** 31 + 107, 0.0, trace,
                           device="cpu", metrics=("kernels_roofline",),
                           controls=(CONFIG["control_dtype"],))
    assert res["correct"], res["checks"]
    assert res["attempted"] == 4 * 2   # one chunk of 2, four chains
    ok, rows = res["control_checks"][CONFIG["control_dtype"]]
    assert not ok, rows
    assert "kernels_roofline" not in res["metrics"]


def _summary(kernel_us):
    s = trace_reduce.Summary(iters=1, wall_s=1.0, busy_s=0.0, launches=0,
                             syncs=0, device_events=0)
    s.kernel_us = {k: [] for k in trace_reduce.KERNELS}
    s.kernel_us.update(kernel_us)
    return s


def test_kernels_roofline_is_the_summed_bounds_over_the_summed_time():
    # bounds: 3.35e6 B / 3.35e12 B/s = 1 us; 6.7e7 op / 67e12 op/s = 1 us
    ctx = {"dtype": "float32",
           "trace": _summary({"spr_kernel": [20.0, 20.0],
                              "rubber_band_kernel": [5.0, 5.0, 10.0],
                              "node_age_kernel": [4.0]}),
           "models": {"spr": [(3.35e6, 0.0)],
                      "rubber_band": [(0.0, 6.7e7)],
                      "node_age": [(3.35e6, 0.0), (6.7e6, 0.0)],
                      "mig_age": [(3.35e6, 0.0)]}}
    assert opmodels.bound_s(3.35e6, 0.0) == pytest.approx(1e-6)
    # spr 2 x 1 us, rubber band 3 x 1 us, node age 1 x the mean of its
    # two buckets' 1 and 2 us; mig_age has a model and no launch
    got = kernels_roofline.read(ctx)
    assert got["unit"] == "%"
    assert got["value"] == pytest.approx(100.0 * 6.5 / 64.0)


def test_kernels_roofline_without_launches_and_over_100():
    ctx = {"dtype": "float32", "trace": _summary({}),
           "models": {"spr": [(3.35e6, 0.0)]}}
    assert kernels_roofline.read(ctx) is None
    ctx["trace"] = _summary({"spr_kernel": [0.5]})
    with pytest.raises(ValueError, match="above 100"):
        kernels_roofline.read(ctx)
