"""Chains side by side (`Sampler(chains=C)`) on the CPU, without JAX.

Chain c of a C-chain run is the one-chain run with seed base + 7919 c:
its draws, decisions and states, bit for bit.  The chains share the
data, keep their loci chain-major and their parameters on a leading axis,
and write checkpoints in gphocs_tpu's stacked layout.  Fixture: 8 loci x
200 bp of SAMPLE_AGE_VAR_CTL (an estimated sample age, VAR locus rates,
mixing), start-mig passed and the band made hot, so that every move of the
iteration runs and accepts.
"""

import numpy as np
import pytest
import torch

from gphocs_tpu_torch import cli
from gphocs_tpu_torch import state as TS
from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import SAMPLE_AGE_VAR_CTL, with_settings
from gphocs_tpu_torch.io.simulate import simulate_seq_file
from gphocs_tpu_torch.kernels.common import gen_log_prior
from gphocs_tpu_torch.model import build_poptree
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.rng_fast import FastRngState
from gphocs_tpu_torch.sampler.driver import AcceptCounts, Sampler
from gphocs_tpu_torch.sampler.step import StepStats

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)

BASE = 5
CHAINS = 3


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    path = tmp_path_factory.mktemp("chains") / "seqs.txt"
    cfg = parse_control_text(SAMPLE_AGE_VAR_CTL)
    simulate_seq_file(cfg, build_poptree(cfg), str(path), num_loci=8,
                      seq_len=200, seed=11)
    return str(path)


def _hot(path, seed, chains):
    """An initialized sampler with the band hot (2e5)."""
    cfg = parse_control_text(SAMPLE_AGE_VAR_CTL)
    cfg.mcmc.random_seed = seed
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=path, dtype=torch.float64, device="cpu",
                chains=chains)
    s.initialize()
    s._sample_mig_rates_device()
    s.params = s.params._replace(
        mig_rate=torch.full_like(s.params.mig_rate, 2e5))
    s.lnps = tuple(gen_log_prior(g, s.params, s.ctx) for g in s.gens)
    return s


def test_chain_c_equals_one_chain_run_with_its_seed(seqs):
    """Three chains for three iterations against three one-chain runs with
    seeds base + 7919 c: every integer array, counter and accept count
    equal, and every real (ages, rates, parameters, lnld, lnp,
    conditionals, trace entries) bitwise.  No reduction needed a
    tolerance: a chain's sums (torch.sum over its loci of a [C, L] view)
    give the one-chain sums' bits on the CPU."""
    sc = _hot(seqs, BASE, CHAINS)
    stc, trc = sc.step_chunk(3, do_migrate=True)
    L = sc.num_loci
    assert sc.gen.num_loci == CHAINS * L
    for c in range(CHAINS):
        s1 = _hot(seqs, BASE + 7919 * c, 1)
        st1, tr1 = s1.step_chunk(3, do_migrate=True)
        gen, params = sc.chain_state(c)
        cut = slice(c * L, (c + 1) * L)
        for name, a, b in (
                *((f, getattr(gen, f), getattr(s1.gen, f))
                  for f in gen._fields),
                *((f, getattr(params, f), getattr(s1.params, f))
                  for f in ("theta", "tau", "sample_age", "mig_rate")),
                ("lrng.key", sc.lrng.key[cut], s1.lrng.key),
                ("lrng.ctr", sc.lrng.ctr[c], s1.lrng.ctr),
                ("grng.key", sc.grng.key[c:c + 1], s1.grng.key),
                ("grng.ctr", sc.grng.ctr[c], s1.grng.ctr),
                ("lnld", sc.lnld[cut], s1.lnld),
                ("lnp", sc.lnp[cut], s1.lnp),
                ("cond", sc.cond[cut], s1.cond),
                *((f"totals.{f}", getattr(stc, f)[c], getattr(st1, f))
                  for f in StepStats._fields),
                *((f"trace.{f}", getattr(trc, f)[:, c], getattr(tr1, f))
                  for f in trc._fields)):
            assert torch.equal(a, b), f"chain {c}: {name}"
        assert int(st1.acc_spr) > 0 and int(st1.acc_locus_rate) > 0
        assert int(st1.acc_taus[3]) > 0  # the sample age moved
    assert not torch.equal(trc.theta[:, 0], trc.theta[:, 1])


def test_chain_state_round_trips_the_jax_layout(seqs):
    """to_numpy(chains=C) gives gphocs_tpu's stacked layout ([C, L, ...]
    per locus, [C] counters); from_numpy(chains=True) takes it back."""
    s = _hot(seqs, BASE, 2)
    L = s.num_loci
    gen = TS.to_numpy(s.gen, chains=2)
    assert gen.age.shape == (2, L, s.gen.num_nodes)
    assert gen.root.shape == (2, L)
    rng = TS.to_numpy(s.lrng, chains=2)
    assert rng.key.shape == (2, L) and rng.ctr.shape == (2,)
    back = TS.from_numpy(gen, TS.GenState, chains=True)
    for a, b in zip(back, s.gen):
        assert torch.equal(a, b)
    lrng = TS.from_numpy(rng, FastRngState, chains=True)
    assert torch.equal(lrng.key, s.lrng.key)
    assert torch.equal(lrng.ctr, s.lrng.ctr)


def _ctl(path, trace, iterations, **extra):
    return with_settings(SAMPLE_AGE_VAR_CTL, seq_file=path,
                         trace_file=trace, mcmc_iterations=iterations,
                         iterations_per_log=2, random_seed=BASE, burn_in=1,
                         start_mig=0, **extra)


def test_chain_checkpoint_resumes_bitwise(seqs, tmp_path):
    """Two chains: the run resumed from the checkpoint of iteration 2
    equals the uninterrupted one bit for bit, every chain's rows and every
    array of the final checkpoint, which has gphocs_tpu's stacked layout.
    The uninterrupted run passes the state check at every log point."""
    def run(name, iterations, resume=False, ck=None, **kw):
        text = _ctl(seqs, tmp_path / f"{name}.log", iterations)
        s = Sampler(parse_control_text(text), device="cpu", chains=2)
        s.run(trace_path=str(tmp_path / f"{name}.log"),
              checkpoint_path=str(tmp_path / (ck or f"{name}.npz")),
              checkpoint_every=2, resume=resume, **kw)
        return s

    whole = run("whole", 4, debug_check=True)
    run("first", 2)
    resumed = run("second", 4, resume=True, ck="first.npz")
    for c in range(2):
        assert whole.chain_rows[c].shape[0] == 4
        np.testing.assert_array_equal(whole.chain_rows[c][2:],
                                      resumed.chain_rows[c])
    log = (tmp_path / "whole.log").read_text().splitlines()
    again = (tmp_path / "second.log").read_text().splitlines()
    assert again == [log[0]] + log[3:]
    a = np.load(tmp_path / "whole.npz")
    b = np.load(tmp_path / "first.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    L = whole.num_loci
    assert a["gen_age"].shape == (2, L, whole.gen.num_nodes)
    assert a["cond"].shape[:2] == (2, L) and a["lnld"].shape == (2, L)
    assert a["lrng_key"].shape == (2, L) and a["lrng_ctr"].shape == (2,)
    assert a["grng_key"].shape == (2, 1) and a["params_theta"].shape[0] == 2
    # a checkpoint of two chains does not resume one chain
    one = Sampler(parse_control_text(_ctl(seqs, tmp_path / "x.log", 4)),
                  device="cpu")
    with pytest.raises(ValueError, match="2 chain"):
        one.run(checkpoint_path=str(tmp_path / "first.npz"), resume=True)


def test_chains_refused_with_buckets_and_coal_stats(seqs, tmp_path,
                                                    capsys):
    """As gphocs_tpu: chains only without pattern buckets; and not with a
    coal-stats file, whose writer reads one chain's state."""
    cfg = parse_control_text(_ctl(seqs, tmp_path / "t.log", 2))
    with pytest.raises(ValueError, match="one chain"):
        Sampler(cfg, device="cpu", chains=2, buckets=2)
    text = _ctl(seqs, tmp_path / "t.log", 2,
                coal_stats_file=tmp_path / "coal.txt")
    with pytest.raises(ValueError, match="coal-stats"):
        Sampler(parse_control_text(text), device="cpu", chains=2)
    ctl = tmp_path / "run.ctl"
    ctl.write_text(text)
    with pytest.raises(SystemExit):
        cli.main([str(ctl), "--chains", "2", "--device", "cpu",
                  "--fast-rng"])
    assert "coal-stats file takes one chain" in capsys.readouterr().err
    assert not (tmp_path / "coal.txt").exists()


def test_debug_check_names_the_chain(seqs):
    """check_state() finds nothing on a clean chain state, and names the
    chain of a leaf that left its sample age and of a carried likelihood
    that drifted."""
    s = _hot(seqs, BASE, 2)
    assert s.check_state() == []
    L = s.num_loci
    g = s.gen
    age = g.age.clone()
    age[L, 0] = 0.5 * float(age[L, g.father[L, 0]])  # chain 1's first locus
    s.gen = g._replace(age=age)
    s.cond, s.lnld = full_rebuild_and_lnld(s.gen, s.seq)
    s.lnp = gen_log_prior(s.gen, s.params, s.ctx)
    errs = s.check_state()
    assert errs and all(e.startswith("chain 1: ") for e in errs)
    assert any("leaf age != sample age" in e for e in errs)
    lnld = s.lnld.clone()
    lnld[3] += 1e-3  # chain 0
    s.lnld = lnld
    assert any(e.startswith("chain 0: carried data lnL drift")
               for e in s.check_state())


def test_acceptance_log_shows_the_chains_mean():
    """The log's counts are the chains' mean (gphocs_tpu sums them, which
    puts its percentages C times too high)."""
    c = AcceptCounts()
    c.reset(3)
    n = torch.tensor
    st = StepStats(
        acc_coal_time=n([4, 6]), acc_mig_time=n([1, 3]), acc_spr=n([2, 2]),
        acc_theta=n([3, 5]), acc_mig_rate=n([0, 2]),
        acc_taus=n([[0, 1, 2], [2, 3, 4]]), acc_mixing=n([1, 0]),
        acc_locus_rate=n([6, 8]), rate_var_delta=n([0.0, 0.0]),
        tau_conflicts=n([0, 1]), num_migs_total=n([5, 7]),
        lnld_sum=n([0.0, 0.0]), lnp_sum=n([0.0, 0.0]), acc_admix=n([3, 1]))
    c.add(st, 2)
    assert (c.coal_time, c.mig_time, c.spr, c.theta, c.mig_rate) == (
        5, 2, 2, 4, 1)
    assert c.taus.tolist() == [1, 2, 3]
    assert (c.mixing, c.locus_rate, c.conflicts, c.admix) == (0.5, 7, 0.5, 2)


def test_admixed_chains_equal_one_chain_runs(seqs):
    """ADMIX_CTL (two admixed leaves): two chains for three iterations
    against the one-chain runs with their seeds, bitwise, the coefficients
    [C, A], their accept counts and the leaves' populations included."""
    from gphocs_tpu_torch.config.samples import ADMIX_CTL

    def sampler(seed, chains):
        cfg = parse_control_text(ADMIX_CTL)
        cfg.mcmc.random_seed = seed
        cfg.mcmc.start_mig = 0
        s = Sampler(cfg, seq_path=seqs, dtype=torch.float64, device="cpu",
                    chains=chains)
        s.initialize()
        return s

    sc = sampler(BASE, 2)
    stc, trc = sc.step_chunk(3, do_migrate=True)
    assert sc.params.admix_coeff.shape == (2, 2)
    L = sc.num_loci
    for c in range(2):
        s1 = sampler(BASE + 7919 * c, 1)
        st1, tr1 = s1.step_chunk(3, do_migrate=True)
        gen, params = sc.chain_state(c)
        cut = slice(c * L, (c + 1) * L)
        for f in gen._fields:
            assert torch.equal(getattr(gen, f), getattr(s1.gen, f)), f
        for f in params._fields:
            assert torch.equal(getattr(params, f), getattr(s1.params, f)), f
        assert torch.equal(sc.lnp[cut], s1.lnp)
        assert torch.equal(sc.grng.ctr[c], s1.grng.ctr)
        assert torch.equal(sc.lrng.ctr[c], s1.lrng.ctr)
        for f in StepStats._fields:
            assert torch.equal(getattr(stc, f)[c], getattr(st1, f)), f
        assert torch.equal(trc.admix_coeff[:, c], tr1.admix_coeff)
        assert torch.equal(sc.chunk_in2[cut], s1.chunk_in2)
        assert int(st1.acc_admix) > 0
    assert not torch.equal(trc.admix_coeff[:, 0], trc.admix_coeff[:, 1])
