"""`correct` on runs of the harness on the CPU, at a size a test can
hold: true for the program as it is; false for the control (the
reference in bfloat16 in the program's place) and for the timed path
broken underneath in each way a cell can be: the state returned
unchanged, half of the loci left out, an answer (a locus's lnld, a node's
age) altered where it is produced, and an update family left out inside
the iteration, the state staying consistent (the SPR sweep; the theta,
migration-rate and mixing updates).  The run skips only the harness's look
for a card; the configuration's own limits judge it."""

import json
import os

import pytest
import torch

from benchmark import harness

CONFIG = json.load(open(os.path.join(harness.HERE, "configs",
                                     "sample_1k.json")))
SMALL = dict(CONFIG, num_loci=12, locus_length=300)
TRAFFIC = {"chains": 2, "chunk": 2, "warmup_chunks": 1, "trace_chunks": 1}


def _rows(x, keep, old):
    mask = keep.reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(mask, x, old)


def broken(kind):
    """A step_chunk that runs the real one and then breaks its result."""
    from gphocs_tpu_torch.sampler.driver import Sampler

    orig = Sampler.step_chunk

    def step_chunk(self, n_iters, do_migrate):
        before = (self.gens, self.lnlds, self.lnps, self.conds, self.params)
        out = orig(self, n_iters, do_migrate)
        if kind == "unchanged":
            (self.gens, self.lnlds, self.lnps, self.conds,
             self.params) = before
        elif kind == "half":
            L = self.gen.num_loci
            keep = torch.arange(L) < L // 2
            g = type(self.gen)(*(_rows(x, keep, o) for x, o in
                                 zip(self.gen, before[0][0])))
            self.gens = (g,)
            self.lnlds = (_rows(self.lnld, keep, before[1][0]),)
            self.lnps = (_rows(self.lnp, keep, before[2][0]),)
            self.conds = (_rows(self.cond, keep, before[3][0]),)
        elif kind == "answer":
            lnld = self.lnld.clone()
            lnld[3] += 10.0
            self.lnlds = (lnld,)
        elif kind == "age":
            age = self.gen.age.clone()
            S = self.gen.num_samples
            fa = int(self.gen.father[2, S])
            age[2, S] = 1.5 * age[2, fa]
            self.gens = (self.gen._replace(age=age),)
        return out

    return step_chunk


def skip_updates(kind, monkeypatch):
    """Leave an update family out of the program's iteration: each
    update returns its input, with no move accepted."""
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler import bucketed

    def none(params):
        return torch.zeros(params.theta.shape[:-1], dtype=torch.int64)

    if kind == "spr":
        monkeypatch.setattr(
            sweeps, "spr_sweep",
            lambda gen, params, seq, rng, ctx, lnld, cond, loci_axis=None:
            (gen, rng, lnld, cond, none(params)))
    else:
        def scalar(gen, params, rng, ctx, ft, lnp, stats, loci_axis=None):
            return params, rng, lnp, none(params)

        def mixing(gens, params, seqs, grng, ctx, ft, lnlds, lnps, conds,
                   stats_list, num_cur_pops, loci_axis=None):
            return gens, params, grng, lnlds, lnps, conds, none(params)

        for name in ("update_thetas", "update_mig_rates"):
            monkeypatch.setattr(bucketed, name, scalar)
        monkeypatch.setattr(bucketed, "update_mixing_buckets", mixing)


def run(**kw):
    return harness.run_cell(SMALL, TRAFFIC, 2 ** 31 + 101, 0.0, False,
                            device="cpu", **kw)


def test_sound_run_is_correct_and_control_is_not():
    res = run(controls=(CONFIG["control_dtype"],))
    assert res["correct"], res["checks"]
    assert res["forbidden"] == []
    ok, rows = res["control_checks"][CONFIG["control_dtype"]]
    assert not ok, rows


@pytest.mark.parametrize("route", [
    {"locus_length": {"min": 60, "max": 600}, "sampler": {"buckets": 3}},
    {"sampler": {"rng_mode": "legacy"}},
    {"sampler": {"loci_multiple": 5}}],
    ids=["ragged_buckets", "legacy_rng", "padded"])
def test_other_routes_are_judged_from_data_files(route):
    """Another route of the program, or ragged loci, is a configuration's
    or a traffic mix's data and no edit of the harness: a sound traced run
    there is correct, and its kernels' models are read per bucket."""
    config = dict(SMALL, **{k: v for k, v in route.items()
                            if k != "sampler"})
    traffic = dict(TRAFFIC, chains=1 if "buckets" in route["sampler"]
                   else 2, sampler=route["sampler"])
    res = harness.run_cell(config, traffic, 2 ** 31 + 103, 0.0, True,
                           device="cpu", metrics=("setup.ingest_s",))
    assert res["correct"], res["checks"]
    assert res["metrics"]["setup.ingest_s"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "answer", "age",
                                  "spr", "params"])
def test_broken_timed_path_is_not_correct(kind, monkeypatch):
    from gphocs_tpu_torch.sampler.driver import Sampler

    if kind in ("spr", "params"):
        skip_updates(kind, monkeypatch)
    else:
        monkeypatch.setattr(Sampler, "step_chunk", broken(kind))
    res = run()
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
