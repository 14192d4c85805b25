"""Admixture in gphocs_tpu_torch against gphocs_tpu's fast-RNG XLA path,
draw for draw at f64: the prior's admixture terms, update_admix_coeffs
(one chain and two side by side), SPR with admixed leaves, the tau update
on an admixed state, three iterations of the whole sampler with its trace
and admixture-trace.out, and a JAX checkpoint of an admixed run resumed in
the port.

Fixture: ADMIX_CTL (SAMPLE_CTL with sample `one` also in B: two admixed
haploid leaves), 24 loci x 300 bp simulated under SAMPLE_CTL, warmed with a
hot band as tests/torch_twins.py does.  The JAX functions run with jit
disabled (last-bit parity, ROADMAP Queue 3).  The tau update is held
against the XLA update_taus, whose prior keeps the admixture terms, not
against the Pallas rubber band, which leaves them out (Queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gphocs_tpu.kernels.admix import update_admix_coeffs as j_admix
from gphocs_tpu.kernels.common import gen_log_prior as j_prior
from gphocs_tpu.kernels.spr import update_spr as j_spr
from gphocs_tpu.kernels.tau import update_taus as j_taus
from gphocs_tpu_torch.config.samples import ADMIX_CTL
from gphocs_tpu_torch.kernels.admix import update_admix_coeffs
from gphocs_tpu_torch.kernels.common import gen_log_prior
from gphocs_tpu_torch.kernels.tau import update_taus_fused
from gphocs_tpu_torch.ops import sweeps
from gphocs_tpu_torch.rng_fast import FastRngState
from gphocs_tpu_torch.state import Params

from tests.torch_twins import carry, close, equal, warm_jax_sampler


# iterations of the sampler test, and of each warm-up chunk of the fixture
ITERS = 3


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    s = warm_jax_sampler(tmp_path_factory.mktemp("torch_admix"),
                         ctl=ADMIX_CTL, chunk=ITERS)
    return s, carry(s)


def _leaf_pops(gen, ctx):
    return np.asarray(gen.node_pop)[:, np.asarray(ctx.admix_slot)]


def test_prior_has_the_admixture_terms(twins):
    """gen_log_prior on a state whose admixed leaves sit in both of their
    populations."""
    s, t = twins
    pops = _leaf_pops(s.gen, s.ctx)
    second = np.asarray(s.ctx.admix_pops)[:, 1]
    assert (pops == second).any() and (pops != second).any()
    with jax.disable_jit():
        want = j_prior(s.gen, s.params, s.ctx)
    close(want, gen_log_prior(t["gen"], t["params"], t["ctx"]), 1e-12)
    # the terms themselves: log c in the second population, log(1 - c) in
    # the first, on top of the genealogy prior
    from gphocs_tpu_torch.kernels.common import full_stats
    from gphocs_tpu_torch.ops.coalstats import genealogy_log_prior

    c = np.asarray(s.params.admix_coeff)
    terms = np.where(pops == second, np.log(c), np.log1p(-c)).sum(axis=1)
    bare = genealogy_log_prior(full_stats(t["gen"], t["params"], t["ctx"]),
                               t["params"])
    close(terms, gen_log_prior(t["gen"], t["params"], t["ctx"]) - bare,
          1e-12)


def test_admix_coeffs_match_jax_one_and_two_chains(twins):
    """update_admix_coeffs draw for draw: coefficients, accept counts, lnp
    within 1e-12 and the general stream's counter; then two chains side by
    side (the second with other coefficients and another general stream),
    each chain equal to JAX's one-chain update of it."""
    s, t = twins
    ft = t["ft"].admix * 20  # moves large enough for some rejections
    jft = s.ft._replace(admix=s.ft.admix * 20)
    p2 = s.params._replace(admix_coeff=jnp.asarray([0.2, 0.9]))
    g2 = s.grng._replace(ctr=s.grng.ctr + 1000)
    chains = []
    for params, grng in ((s.params, s.grng), (p2, g2)):
        with jax.disable_jit():
            chains.append(j_admix(s.gen, params, grng, s.ctx, jft.admix,
                                  s.lnp))
    pj, rj, lpj, aj = chains[0]
    pt, rt, lpt, at = update_admix_coeffs(t["gen"], t["params"], t["grng"],
                                          t["ctx"], ft, t["lnp"])
    close(pj.admix_coeff, pt.admix_coeff, 1e-15)
    assert int(aj) == int(at)
    assert int(rj.ctr) == int(rt.ctr) == int(s.grng.ctr) + 2 * 4
    close(lpj, lpt, 1e-12)

    # two chains: chain-major loci, [2, A] coefficients, [2] streams
    L = t["lnp"].shape[0]
    gen2 = type(t["gen"])(*(torch.cat([x, x]) for x in t["gen"]))
    params2 = Params(*(None if x is None else torch.stack([x, y]) for x, y in
                       zip(t["params"], carry_params(p2))))
    grng2 = FastRngState(key=torch.cat([t["grng"].key, t["grng"].key]),
                         ctr=torch.stack([t["grng"].ctr,
                                          t["grng"].ctr + 1000]))
    pt, rt, lpt, at = update_admix_coeffs(gen2, params2, grng2, t["ctx"], ft,
                                          torch.cat([t["lnp"], t["lnp"]]))
    for c, (pj, rj, lpj, aj) in enumerate(chains):
        close(pj.admix_coeff, pt.admix_coeff[c], 1e-15)
        assert int(aj) == int(at[c])
        assert int(rj.ctr) == int(rt.ctr[c])
        close(lpj, lpt[c * L:(c + 1) * L], 1e-12)
    assert int(at.sum()) > 0


def carry_params(params):
    return Params(*(None if x is None else torch.as_tensor(
        np.array(x), dtype=torch.float64) for x in params))


def test_spr_with_admixture_matches_xla(twins):
    """The plain SPR at global trip synchronization (the CPU route of
    spr_sweep) against the XLA update_spr: equal integer arrays, leaf
    populations included, with some admixed leaf moved to its other
    population."""
    s, t = twins
    with jax.disable_jit():
        g1, r1, ld1, c1, a1 = j_spr(s.gen, s.params, s.seq, s.lrng, s.ctx,
                                    s.lnld, s.cond)
    sweeps.reset_launch_counts()
    g2, r2, ld2, c2, a2 = sweeps.spr_sweep(t["gen"], t["params"], t["seq"],
                                           t["lrng"], t["ctx"], t["lnld"],
                                           t["cond"])
    assert sweeps.LAUNCHES["spr"] == 0  # CPU tensors: the plain version
    assert int(a1) == int(a2) > 0
    assert int(r1.ctr) == int(r2.ctr)
    for f in ("father", "lson", "rson", "root", "node_pop", "mig_branch",
              "mig_band"):
        equal(getattr(g1, f), getattr(g2, f))
    assert (_leaf_pops(g1, s.ctx) != _leaf_pops(s.gen, s.ctx)).any()
    close(g1.age, g2.age, 1e-9)
    close(g1.mig_age, g2.mig_age, 1e-9)
    close(ld1, ld2, 1e-9)
    close(c1, c2, 1e-9)


def test_tau_update_on_an_admixed_state_matches_xla(twins):
    """The tau update (its rubber band on the CPU: the plain version,
    whose prior holds the admixture terms) against the XLA update_taus."""
    s, t = twins
    P, C = s.tree.num_pops, s.tree.num_cur_pops
    # small steps, so that proposals are accepted and the proposal's prior
    # (admixture terms included) is carried
    with jax.disable_jit():
        g1, p1, rs1, ld1, lp1, c1, a1, cf1 = j_taus(
            s.gen, s.params, s.seq, s.grng, s.ctx, s.ft.taus * 0.02, s.lnld,
            s.lnp, s.cond, P, C)
    g2, p2, rs2, ld2, lp2, c2, a2, cf2 = update_taus_fused(
        t["gen"], t["params"], t["seq"], t["grng"], t["ctx"],
        t["ft"].taus * 0.02, t["lnld"], t["lnp"], t["cond"], P, C)
    equal(a1, a2)
    assert int(np.asarray(a1).sum()) > 0
    assert int(cf1) == int(cf2) and int(rs1.ctr) == int(rs2.ctr)
    close(p1.tau, p2.tau, 1e-15)
    close(g1.age, g2.age, 1e-12)
    close(ld1, ld2, 1e-8)
    close(lp1, lp2, 1e-8)


def test_sampler_run_matches_jax_with_admixture_trace(twins, tmp_path):
    """Three iterations of run() on both samplers from the same seed, with
    a trace and one log point: the trace rows (the A... columns included)
    within 1e-9 relative and admixture-trace.out equal.  JAX's chunk runs
    jitted here: it is the chunk the fixture compiled (three iterations,
    start-mig passed), which costs no compilation, where one eager
    iteration holds an eager SPR sweep (~28 s alone, the SPR test above)
    besides the other sweeps.  Compiled XLA contracts and reorders f64
    arithmetic (ROADMAP Queue 3), and a few walks of this run magnify such
    differences (a coalescence time on a segment of low hazard), so the
    rows agree within 1e-9 relative, not to the last bit; every decision
    agrees."""
    from gphocs_tpu.config import parse_control_text as j_parse
    from gphocs_tpu.sampler.driver import Sampler as JaxSampler

    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.sampler.driver import Sampler

    s, _ = twins

    def settings(cfg):
        cfg.mcmc.random_seed = 17
        cfg.mcmc.start_mig = -1
        cfg.mcmc.burn_in = 0
        cfg.mcmc.mcmc_iterations = ITERS
        cfg.mcmc.iterations_per_log = ITERS
        return cfg

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    js = JaxSampler(settings(j_parse(ADMIX_CTL)), seq_path=s.seq_path,
                    dtype=jnp.float64, rng_mode="fast")
    jcols, jrows = js.run(trace_path=str(tmp_path / "jax" / "trace.out"))
    ts = Sampler(settings(parse_control_text(ADMIX_CTL)), seq_path=s.seq_path,
                 dtype=torch.float64, device="cpu")
    tcols, trows = ts.run(trace_path=str(tmp_path / "port" / "trace.out"))
    assert tcols == jcols and [c for c in tcols if c.startswith("A")] == [
        "A0[B]", "A1[B]"]
    np.testing.assert_allclose(trows, jrows, rtol=1e-9, atol=0)
    acol = tcols.index("A0[B]")
    assert len(set(trows[:, acol].tolist())) > 1
    want = (tmp_path / "jax" / "admixture-trace.out").read_text()
    got = (tmp_path / "port" / "admixture-trace.out").read_text()
    assert got == want
    vals = [float(v) for v in got.split()]
    assert vals[0] == ITERS - 1 and len(vals) == 1 + 2 * ts.num_loci
    assert all(0.0 <= v <= 1.0 for v in vals[1:])
    assert len(set(vals[1:])) > 1
    assert not ts.check_state()


def test_jax_checkpoint_of_an_admixed_run_resumes_in_the_port(twins,
                                                              tmp_path):
    """gphocs_tpu's checkpoint of the warmed admixed sampler loads into the
    port (coefficients included, every array equal to the carried state),
    and the port goes on from it with a consistent state."""
    from gphocs_tpu.checkpoint import save_checkpoint as j_save

    from gphocs_tpu_torch.checkpoint import load_checkpoint
    from gphocs_tpu_torch.sampler.driver import Sampler

    s, t = twins
    j_save(s, str(tmp_path / "jax.npz"), 7)
    port = Sampler(s.cfg, seq_path=s.seq_path, dtype=torch.float64,
                   device="cpu")
    port.initialize()
    assert load_checkpoint(port, str(tmp_path / "jax.npz")) == 7
    for k in ("gen", "params", "lrng", "grng", "lnld", "lnp", "cond"):
        for a, b in zip(getattr(port, k), t[k]):
            assert (a is None and b is None) or torch.equal(a, b), k
    assert port.params.admix_coeff.shape == (2,)
    port.ft = t["ft"]
    st, tr = port.step_chunk(1, do_migrate=True)
    assert tr.admix_coeff.shape == (1, 2)
    assert not port.check_state()
