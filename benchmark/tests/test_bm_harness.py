"""The data generator, the trace arithmetic and the command's refusal
without a card."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import datagen, opmodels, trace_reduce
from benchmark.metrics import _roofline
from benchmark.reference import control

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CTL = os.path.join(ROOT, "benchmark", "configs", "sample-control-file.ctl")


def test_generator_is_deterministic_in_the_seed(tmp_path):
    ctl = control.parse(open(CTL).read())
    a, b, c = (str(tmp_path / n) for n in "abc")
    datagen.write_seq_file(a, ctl, 30, 200, 2 ** 31 + 11)
    datagen.write_seq_file(b, ctl, 30, 200, 2 ** 31 + 11)
    datagen.write_seq_file(c, ctl, 30, 200, 2 ** 31 + 12)
    assert filecmp.cmp(a, b, shallow=False)
    assert not filecmp.cmp(a, c, shallow=False)


def test_generator_writes_what_the_port_reads(tmp_path):
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.io.sequences import build_seq_data, read_seq_file

    ctl = control.parse(open(CTL).read())
    path = str(tmp_path / "seqs.txt")
    datagen.write_seq_file(path, ctl, 40, 500, 9)
    cfg = parse_control_text(open(CTL).read())
    for native in (True, False):
        raw = read_seq_file(path, cfg.sample_names, use_native=native)
        assert raw.num_loci == 40
        seq = build_seq_data(raw, cfg.is_diploid())
        # sites of every locus counted once, and some heterozygous ones
        assert (seq.group_count.sum(axis=1) == 500).all()
        lb = seq.leaf_base
        assert ((lb[:, 0] != lb[:, 1]) & (lb[:, 0] < 4) & (lb[:, 1] < 4)
                & seq.pattern_valid).any()


def test_trace_arithmetic_on_a_synthetic_trace():
    ev = [("cudaLaunchKernel", False, 0.0, 2.0),
          ("aten::add", False, 0.0, 12.0),
          ("void spr_kernel<float>(SweepArgs)", True, 10.0, 30.0),
          ("elementwise_kernel<add>", True, 20.0, 40.0),
          ("cudaStreamSynchronize", False, 45.0, 70.0),
          ("cudaLaunchKernel", False, 52.0, 53.0),
          ("void rubber_band_kernel<float>(SweepArgs)", True, 60.0, 70.0),
          ("Memcpy DtoH", True, 80.0, 90.0)]
    s = trace_reduce.summarize(ev, iters=2, wall_s=100e-6)
    assert s.busy_s == pytest.approx(50e-6)        # [10,40] [60,70] [80,90]
    assert s.tensor_code_busy_s == pytest.approx(30e-6)   # [20,40] [80,90]
    assert (s.launches, s.syncs, s.device_events) == (2, 1, 4)
    assert s.kernel_us["spr_kernel"] == [20.0]
    # the gaps [40, 60] (host in the sync) and [70, 80] (nothing traced)
    assert dict(map(tuple, s.idle_gaps)) == pytest.approx(
        {"cudaStreamSynchronize": 20e-6, "(no host event)": 10e-6})
    ctx = {"trace": s, "dtype": "float32",
           "models": {"spr": [(3.35e6, 0.0)],
                      "rubber_band": [(0.0, 6.7e5)]}}
    # bounds: 3.35e6 B / 3.35e12 B/s = 1 us of 20; 6.7e5 / 67e12 = 0.01 us
    assert _roofline.share(ctx, "spr")["value"] == pytest.approx(5.0)
    assert _roofline.share(ctx, "rubber_band")["value"] == pytest.approx(0.1)
    assert _roofline.share(ctx, "node_age") is None
    # two pattern buckets: a sweep is two launches (20 us each), bounds
    # of 1 us and 3 us
    ctx["models"]["spr"] = [(3.35e6, 0.0), (3.35e6, 2.01e8)]
    assert _roofline.share(ctx, "spr")["value"] == pytest.approx(10.0)
    assert trace_reduce.union_us([(0, 5), (1, 2), (4, 9), (20, 21)]) == 10


def test_a_share_over_100_is_refused():
    s = trace_reduce.summarize(
        [("spr_kernel", True, 0.0, 1.0)], iters=1, wall_s=1e-6)
    ctx = {"trace": s, "dtype": "float32",
           "models": {"spr": [(3.35e7, 0.0)]}}     # 10 us bound in 1 us
    with pytest.raises(ValueError):
        _roofline.share(ctx, "spr")
    assert opmodels.bound_s(3.35e12, 0.0) == pytest.approx(1.0)


def test_run_without_a_card_exits_nonzero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sample_1k.c1", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_every_name_in_the_benchmark_has_its_file():
    import json

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "configs",
                                           cfg["control"]))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    assert np.isfinite([e["bound"] for e in bench["end_to_end"]]).all()
