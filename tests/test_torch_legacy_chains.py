"""The conformance mode with chains (`Sampler(rng_mode="legacy",
chains=C)`) on the CPU.

Chain c of a C-chain legacy run is the one-chain legacy run with seed
base + 7919 c, draw for draw: its Wichmann-Hill streams ([C * L]
per-locus, [C, 1] general), genealogies, parameters, accept counts and
trace entries, bit for bit.  A lane draws only where its own chain's move
asks for it, so a chain's streams do not depend on the other chains'
walks.  Checkpoints take gphocs_tpu's stacked layout (`lrng_*` [C, L],
`grng_*` [C, 1]), and one case holds the port against gphocs_tpu's
vmapped legacy chains.  Fixture: 8 loci x 200 bp, start-mig passed and
the band made hot, so that every move of the iteration runs and accepts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gphocs_tpu_torch import checkpoint as TCK
from gphocs_tpu_torch import rng as TR
from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import (ADMIX_CTL, SAMPLE_AGE_VAR_CTL,
                                             SAMPLE_CTL, with_settings)
from gphocs_tpu_torch.io.simulate import simulate_seq_file
from gphocs_tpu_torch.kernels.common import gen_log_prior
from gphocs_tpu_torch.model import build_poptree
from gphocs_tpu_torch.ops import sweeps
from gphocs_tpu_torch.sampler.driver import Sampler
from gphocs_tpu_torch.sampler.step import StepStats

from tests.torch_twins import F64  # (and one intra-op thread)

BASE = 5
CHAINS = 3
ITERS = 2
CASES = {"plain": SAMPLE_CTL, "sample_age_var": SAMPLE_AGE_VAR_CTL,
         "admix": ADMIX_CTL}


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    path = tmp_path_factory.mktemp("legacy_chains") / "seqs.txt"
    cfg = parse_control_text(SAMPLE_AGE_VAR_CTL)
    simulate_seq_file(cfg, build_poptree(cfg), str(path), num_loci=8,
                      seq_len=200, seed=11)
    return str(path)


def _hot(path, ctl, seed, chains):
    """An initialized legacy sampler with the band hot (2e5)."""
    cfg = parse_control_text(ctl)
    cfg.mcmc.random_seed = seed
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=path, dtype=F64, device="cpu", chains=chains,
                rng_mode="legacy")
    s.initialize()
    s._sample_mig_rates_device()
    s.params = s.params._replace(
        mig_rate=torch.full_like(s.params.mig_rate, 2e5))
    s.lnps = tuple(gen_log_prior(g, s.params, s.ctx) for g in s.gens)
    return s


def _chain_arrays(s, c):
    """Chain c's state of sampler s as (name, tensor) pairs."""
    L = s.num_loci
    cut = slice(c * L, (c + 1) * L)
    one = s.chains == 1
    gen, params = (s.gen, s.params) if one else s.chain_state(c)
    return ([(f, getattr(gen, f)) for f in gen._fields]
            + [(f, getattr(params, f)) for f in params._fields]
            + [(f"lrng.{f}", getattr(s.lrng, f)[cut]) for f in "xyz"]
            + [(f"grng.{f}", getattr(s.grng, f)[slice(None) if one else c])
               for f in "xyz"]
            + [(n, getattr(s, n)[cut]) for n in ("lnld", "lnp", "cond")])


@pytest.mark.parametrize("name", list(CASES))
def test_chain_c_equals_its_one_chain_legacy_run(name, seqs):
    """Three legacy chains against three one-chain legacy runs with seeds
    base + 7919 c: at the initialization and after ITERS iterations every
    integer array, stream state and accept count equal, every real bitwise
    equal (the chains' sums are torch.sum over each chain's [L] view,
    whose bits are the one-chain sums').  The sweeps ran as tensor code,
    once per iteration for all chains, and the rubber band as its
    kernel's plain version."""
    sc = _hot(seqs, CASES[name], BASE, CHAINS)
    ones = [_hot(seqs, CASES[name], BASE + 7919 * c, 1)
            for c in range(CHAINS)]
    assert sc.grng.x.shape == (CHAINS, 1)
    assert sc.lrng.x.shape == (CHAINS * sc.num_loci,)
    for c, s1 in enumerate(ones):
        for (n, a), (_, b) in zip(_chain_arrays(sc, c), _chain_arrays(s1, 0)):
            assert a is None and b is None or torch.equal(a, b), \
                f"initialization, chain {c}: {n}"
    sweeps.reset_launch_counts()
    stc, trc = sc.step_chunk(ITERS, do_migrate=True)
    assert {k: v for k, v in sweeps.LAUNCHES.items() if v} == {
        "node_age_plain": ITERS, "mig_age_plain": ITERS,
        "spr_plain": ITERS}
    for c, s1 in enumerate(ones):
        st1, tr1 = s1.step_chunk(ITERS, do_migrate=True)
        for (n, a), (_, b) in zip(_chain_arrays(sc, c), _chain_arrays(s1, 0)):
            assert a is None and b is None or torch.equal(a, b), \
                f"chain {c}: {n}"
        for f in StepStats._fields:
            assert torch.equal(getattr(stc, f)[c], getattr(st1, f)), \
                f"chain {c}: totals.{f}"
        for f in trc._fields:
            assert torch.equal(getattr(trc, f)[:, c], getattr(tr1, f)), \
                f"chain {c}: trace.{f}"
        assert int(st1.acc_spr) > 0 and int(st1.acc_theta) > 0
        if name == "sample_age_var":
            assert int(st1.acc_locus_rate) > 0
        if name == "admix":
            assert int(st1.acc_admix) > 0
    assert not torch.equal(trc.theta[:, 0], trc.theta[:, 1])


def test_streams_do_not_depend_on_the_other_chains(seqs):
    """Two chains stepped once, then the same two with chain 1's band made
    cold (its SPR walks take other trips and migrate less): chain 0's
    streams and state are bitwise the same in both runs, while chain 1
    ends with fewer migrations.  A lane that does not walk draws
    nothing.  (With the reference's identical seeding the streams sit in
    uint32 wraparound, where a lane's state says little about how often
    it drew, so chain 1 is told apart by its genealogies.)"""
    def run(cold):
        s = _hot(seqs, SAMPLE_CTL, BASE, 2)
        if cold:
            rate = s.params.mig_rate.clone()
            rate[1] = 1e-3
            s.params = s.params._replace(mig_rate=rate)
            s.lnps = tuple(gen_log_prior(g, s.params, s.ctx)
                           for g in s.gens)
        s.step_chunk(1, do_migrate=True)
        return s

    hot, cold = run(False), run(True)
    for (n, a), (_, b) in zip(_chain_arrays(hot, 0), _chain_arrays(cold, 0)):
        assert a is None and b is None or torch.equal(a, b), n
    L = hot.num_loci
    migs = [int((s.gen.mig_branch[L:] >= 0).sum()) for s in (hot, cold)]
    assert migs[0] > migs[1], migs


def _ctl(path, trace, iterations):
    return with_settings(SAMPLE_AGE_VAR_CTL, seq_file=path,
                         trace_file=trace, mcmc_iterations=iterations,
                         iterations_per_log=2, random_seed=BASE, burn_in=1,
                         start_mig=0)


def test_legacy_chain_checkpoint_resumes_bitwise(seqs, tmp_path):
    """Two legacy chains: the run resumed from the checkpoint of iteration
    2 equals the uninterrupted one bit for bit (every chain's rows, every
    array of the final checkpoint), which passes the state check at every
    log point.  The file has gphocs_tpu's stacked legacy layout, and a
    one-chain sampler refuses it."""
    def run(name, iterations, resume=False, ck=None, **kw):
        text = _ctl(seqs, tmp_path / f"{name}.log", iterations)
        s = Sampler(parse_control_text(text), device="cpu", chains=2,
                    rng_mode="legacy")
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
    a = np.load(tmp_path / "whole.npz")
    b = np.load(tmp_path / "first.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    L = whole.num_loci
    for f in "xyz":
        assert a[f"lrng_{f}"].shape == (2, L)
        assert a[f"grng_{f}"].shape == (2, 1)
        assert a[f"grng_{f}"].dtype == np.uint32
    assert "lrng_key" not in a.files
    one = Sampler(parse_control_text(_ctl(seqs, tmp_path / "x.log", 4)),
                  device="cpu", rng_mode="legacy")
    with pytest.raises(ValueError, match="2 chain"):
        one.run(checkpoint_path=str(tmp_path / "first.npz"), resume=True)


def test_jax_legacy_chains_match_the_port(tmp_path):
    """gphocs_tpu's Sampler(chains=2, rng_mode="legacy") at 8 loci x
    100 bp: its checkpoint of the initialization has the port's keys,
    shapes and dtypes (`lrng_*` [2, L], `grng_*` [2, 1]), and loaded into
    the port it equals the port's own initialization (genealogies,
    parameters and streams bitwise; the carried conditionals, lnld and lnp
    within 1e-9 relative: the packages add in different orders).  One
    iteration on both sides from it (JAX's vmapped chunk jitted) gives
    equal accept counts, equal streams and trace entries within 1e-9
    relative.  The port's checkpoint then loads in gphocs_tpu's loader."""
    from gphocs_tpu.checkpoint import load_checkpoint as jax_load
    from gphocs_tpu.checkpoint import save_checkpoint as jax_save
    from gphocs_tpu.config import parse_control_text as jax_parse
    from gphocs_tpu.sampler.driver import Sampler as JaxSampler

    path = str(tmp_path / "seqs.txt")
    cfg = parse_control_text(SAMPLE_CTL)
    simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=8,
                      seq_len=100, seed=11)

    def cfg_of(parse):
        cfg = parse(SAMPLE_CTL)
        cfg.mcmc.random_seed = 17
        cfg.mcmc.start_mig = 0
        cfg.mcmc.seq_file = path
        return cfg

    js = JaxSampler(cfg_of(jax_parse), dtype=jnp.float64,
                    rng_mode="legacy", chains=2)
    js.initialize()
    js._sample_mig_rates_device()
    jck = str(tmp_path / "jax.npz")
    jax_save(js, jck, 0)

    own = Sampler(cfg_of(parse_control_text), dtype=F64, device="cpu",
                  rng_mode="legacy", chains=2)
    own.initialize()
    own._sample_mig_rates_device()
    mine = str(tmp_path / "own.npz")
    TCK.save_checkpoint(own, mine, 0)
    a, b = np.load(jck), np.load(mine)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k in ("cond", "lnld", "lnp"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert a["grng_x"].shape == (2, 1) and a["lrng_x"].shape == (2, 8)

    port = Sampler(cfg_of(parse_control_text), dtype=F64, device="cpu",
                   rng_mode="legacy", chains=2)
    port.initialize()
    assert TCK.load_checkpoint(port, jck) == 0
    assert isinstance(port.grng, TR.WhRngState)
    for f in "xyz":
        assert torch.equal(getattr(port.lrng, f), getattr(own.lrng, f))
        assert torch.equal(getattr(port.grng, f), getattr(own.grng, f))
    for f in port.gen._fields:
        assert torch.equal(getattr(port.gen, f), getattr(own.gen, f)), f

    st_j, tr_j = js.step_chunk(1, do_migrate=True)
    st, tr = port.step_chunk(1, do_migrate=True)
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mig_rate", "acc_taus", "acc_mixing", "tau_conflicts",
              "num_migs_total"):
        np.testing.assert_array_equal(np.asarray(getattr(st_j, f)),
                                      getattr(st, f).numpy(), err_msg=f)
    for f in ("x", "y", "z"):
        np.testing.assert_array_equal(
            np.asarray(getattr(js.lrng, f)).reshape(-1),
            getattr(port.lrng, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(js.grng, f)),
                                      getattr(port.grng, f).numpy(),
                                      err_msg=f)
    for f in ("theta", "tau", "mig_rate", "lnld_sum", "lnp_sum"):
        # JAX's trace is [C, K, ...], the port's [K, C, ...]
        np.testing.assert_allclose(
            getattr(tr, f).numpy(), np.swapaxes(np.asarray(getattr(tr_j, f)),
                                                0, 1),
            rtol=1e-9, atol=0, err_msg=f)
    assert int(st.acc_spr.sum()) > 0

    out = str(tmp_path / "port.npz")
    TCK.save_checkpoint(port, out, 1)
    assert jax_load(js, out) == 1
    for f in ("x", "y", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(js.grng, f)),
                                      getattr(port.grng, f).numpy())
    np.testing.assert_array_equal(np.asarray(js.gen.father),
                                  port.gen.father.numpy().reshape(2, 8, -1))
    np.testing.assert_array_equal(np.asarray(js.params.theta),
                                  port.params.theta.numpy())
