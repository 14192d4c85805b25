"""profiling.span inside the port's iteration, on the CPU, without JAX.

With no profiler running a span is one shared null context.  Under
torch.profiler every update family of the iteration appears as a host
range "gphocs.<family>" inside "gphocs.iteration", once per bucket and
genetree sample for the sweeps, with the kernel wrappers' argument blocks
("gphocs.prepare") and the counter RNG's hash ("gphocs.rng_hash") nested
in a family; and the chain's trace and state are the same bits with the
profiler on and off.  Fixture: 12 loci x 200 bp of SAMPLE_AGE_VAR_CTL
(an estimated sample age, VAR locus rates, mixing) with the band made hot,
so that every family but the admixture's runs.
"""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gphocs_tpu_torch import profiling
from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import SAMPLE_AGE_VAR_CTL
from gphocs_tpu_torch.io.simulate import simulate_seq_file
from gphocs_tpu_torch.kernels.common import gen_log_prior
from gphocs_tpu_torch.model import build_poptree
from gphocs_tpu_torch.ops import cuda_lib, sweeps
from gphocs_tpu_torch.sampler.driver import Sampler

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)

SEED = 23
FAMILIES = ("node_age", "mig_age", "spr", "locus_rate", "full_stats",
            "theta", "mig_rate", "tau", "sample_age", "admix", "mixing",
            "sums")
NESTED = ("prepare", "rng_hash")


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / "seqs.txt"
    cfg = parse_control_text(SAMPLE_AGE_VAR_CTL)
    simulate_seq_file(cfg, build_poptree(cfg), str(path), num_loci=12,
                      seq_len=200, seed=7)
    return str(path)


def _sampler(path, buckets=1, genetree_samples=1):
    """An initialized f64 sampler past start-mig, the band hot (2e5)."""
    cfg = parse_control_text(SAMPLE_AGE_VAR_CTL)
    cfg.mcmc.random_seed = SEED
    cfg.mcmc.start_mig = 0
    cfg.mcmc.genetree_samples = genetree_samples
    s = Sampler(cfg, seq_path=path, dtype=torch.float64, device="cpu",
                buckets=buckets)
    s.initialize()
    s._sample_mig_rates_device()
    s.params = s.params._replace(
        mig_rate=torch.full_like(s.params.mig_rate, 2e5))
    s.lnps = tuple(gen_log_prior(g, s.params, s.ctx) for g in s.gens)
    return s


def _spans(prof):
    """[(name, parent)] of the trace's gphocs.* ranges, the parent being
    the innermost other gphocs.* range around each (None for none)."""
    spans = sorted(((e.start_ns(), -e.end_ns(), e.name()[len("gphocs."):])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("gphocs.")))
    out, stack = [], []
    for a, neg_b, name in spans:
        while stack and stack[-1][0] <= a:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((-neg_b, name))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.fixture(scope="module")
def two_iterations(seqs):
    """Two iterations at two genetree samples under the profiler: the
    sampler, the chunk's (totals, trace) and the spans."""
    s = _sampler(seqs, genetree_samples=2)
    out, spans = _profiled(lambda: s.step_chunk(2, do_migrate=True))
    return s, out, spans


def test_span_off_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("tau"), profiling.span("mixing")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("tau") is not a
        with profiling.span("tau"):
            pass
    # an operator-like host event, not a user annotation (which the
    # profiler would mirror onto the device's timeline)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "gphocs.tau"]
    assert not ev.is_user_annotation()


def test_every_family_inside_its_iteration(two_iterations):
    """Each family the expected number of times in two iterations (the
    sweeps and the rate update once per genetree sample, the prior
    refresh once per iteration besides the full_stats pass), each directly
    inside an iteration; the iterations inside the chunk; the hash only
    inside families."""
    _, _, spans = two_iterations
    counts = collections.Counter(name for name, _ in spans)
    want = {"chunk": 1, "iteration": 2, "chunk_totals": 1,
            "node_age": 4, "mig_age": 4, "spr": 4, "locus_rate": 4,
            "full_stats": 4, "theta": 2, "mig_rate": 2, "tau": 2,
            "sample_age": 2, "mixing": 2, "sums": 2}
    assert {k: counts[k] for k in want} == want
    assert counts["admix"] == 0
    assert counts["prepare"] == 0          # the plain versions on the CPU
    assert counts["rng_hash"] > 0
    assert set(counts) <= set(want) | set(NESTED)
    for name, parent in spans:
        if name in FAMILIES:
            assert parent == "iteration", (name, parent)
        elif name in NESTED:
            assert parent in FAMILIES, (name, parent)
        elif name in ("iteration", "chunk_totals"):
            assert parent == "chunk", (name, parent)
        else:
            assert (name, parent) == ("chunk", None)


def test_profiler_changes_no_bit(seqs, two_iterations):
    s, (totals, trace), _ = two_iterations
    t = _sampler(seqs, genetree_samples=2)
    totals0, trace0 = t.step_chunk(2, do_migrate=True)
    pairs = [*zip(totals, totals0), *zip(trace, trace0),
             *zip(s.lnlds + s.lnps + s.conds, t.lnlds + t.lnps + t.conds),
             *((getattr(s.gen, f), getattr(t.gen, f))
               for f in s.gen._fields),
             *((getattr(s.params, f), getattr(t.params, f))
               for f in s.params._fields),
             (s.lrng.key, t.lrng.key), (s.lrng.ctr, t.lrng.ctr),
             (s.grng.ctr, t.grng.ctr)]
    for a, b in pairs:
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


def test_sweeps_once_per_bucket(seqs):
    s = _sampler(seqs, buckets=2)
    assert len(s.gens) == 2
    _, spans = _profiled(lambda: s.step_chunk(1, do_migrate=True))
    counts = collections.Counter(name for name, _ in spans)
    assert counts["iteration"] == 1
    for name in ("node_age", "mig_age", "spr", "locus_rate"):
        assert counts[name] == 2, name
    for name in ("full_stats", "theta", "tau", "mixing", "sums"):
        assert counts[name] == 1, name


def test_prepare_nested_in_the_calling_family(seqs, monkeypatch):
    """The wrappers' CUDA branch, its kernel library's plan entries and
    launches left out: each call makes one prepare range inside the family
    that called it."""
    s = _sampler(seqs)
    monkeypatch.setattr(cuda_lib, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "plan", lambda *args: 0)
    monkeypatch.setattr(sweeps.Prepared, "launch", lambda self, device: None)
    g, sq, r, ctx = s.gens[0], s.seqs[0], s.lrngs[0], s.ctx
    lnld, lnp, cond = s.lnlds[0], s.lnps[0], s.conds[0]
    tau = s.params.tau[..., ctx.root_pop]

    def calls():
        with profiling.span("node_age"):
            sweeps.node_age_sweep(g, s.params, sq, r, ctx, s.ft.coal_time,
                                  lnld, lnp, cond)
        with profiling.span("mig_age"):
            sweeps.mig_age_sweep(g, s.params, r, ctx, s.ft.mig_time, lnp)
        with profiling.span("spr"):
            sweeps.spr_sweep(g, s.params, sq, r, ctx, lnld, cond)
        with profiling.span("tau"):
            sweeps.rubber_band_eval(g, s.params, sq, ctx, ctx.root_pop,
                                    False, tau, tau, tau, tau * 1.01, cond)
        with profiling.span("mixing"):
            sweeps.full_rebuild(g, sq, cond)

    _, spans = _profiled(calls)
    assert [(n, p) for n, p in spans if n == "prepare"] == [
        ("prepare", f) for f in ("node_age", "mig_age", "spr", "tau",
                                 "mixing")]
