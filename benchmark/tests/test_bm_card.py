"""On a CUDA card: one short run of each kind of the smallest cell, the
control at its own size on three seeds (benchmark/calibrate.py), and an
update family left out of the program's iteration at the cell's own size
on three seeds.  Skips without a card.
`python -m pytest benchmark/tests -q -s -m card` (-s prints the readings)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_is_correct(trace):
    need_card()
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sample_1k.c1",
         "--seed", "4000000007", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.card
def test_control_fails_at_the_cells_size():
    need_card()
    p = subprocess.run(
        [sys.executable, "benchmark/calibrate.py", "--workload",
         "sample_1k.c1", "--seconds", "2", "--seeds", "11", "12", "13"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    rows = [json.loads(x) for x in p.stdout.splitlines()
            if x.startswith("{")]
    assert len(rows) == 3
    for r in rows:
        assert r["correct"]
        assert not any(c["correct"] for c in r["control"].values())


@pytest.mark.card
@pytest.mark.parametrize("kind", ["spr", "params"])
def test_skipped_updates_fail_at_the_cells_size(kind, monkeypatch):
    """One chunk (the traced run's length) of sample_1k.c1 with the SPR
    sweep, or the theta, migration-rate and mixing updates, left out."""
    need_card()
    from benchmark import harness
    from benchmark.tests.test_bm_correct import skip_updates

    config = harness.load_json(harness.HERE, "configs", "sample_1k.json")
    traffic = harness.load_json(harness.HERE, "traffic", "c1.json")
    skip_updates(kind, monkeypatch)
    for seed in (4900000001, 4900000002, 4900000003):
        res = harness.run_cell(config, traffic, seed, 0.0, False)
        print(kind, seed, json.dumps({n: v for n, v, _ in res["checks"]}))
        assert not res["correct"], res["checks"]
