"""The ancient-sample path of gphocs_tpu_torch against gphocs_tpu at f64:
the rubber band's sample-age mode, update_sample_ages_fused, the paired
VAR locus-rate update, and five iterations of the whole sampler on a
configuration with an estimated sample age and `locus-mut-rate VAR`.

Fixture: SAMPLE_AGE_VAR_CTL (SAMPLE_CTL with `age 0.00002 e` on
population D, VAR rates), 24 loci x 300 bp, the band D->B made hot so that
migration events of D exist.  The XLA twins run with jit disabled, so both
sides evaluate the same IEEE-754 operations (see test_torch_sweeps); the
Pallas kernel runs in interpret mode, as in tests/test_sweeps_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gphocs_tpu.kernels.locus_rate import update_locus_rates_paired as j_rates
from gphocs_tpu.kernels.tau import update_sample_ages as j_sample_ages
from gphocs_tpu.ops.sweeps_pallas import rubber_band_eval_pallas
from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import (SAMPLE_AGE_CTL,
                                             SAMPLE_AGE_VAR_CTL)
from gphocs_tpu_torch.kernels.locus_rate import update_locus_rates_paired
from gphocs_tpu_torch.kernels.tau import (rubber_band_eval_plain,
                                          update_sample_ages_fused)
from gphocs_tpu_torch.ops import sweeps
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.sampler.driver import Sampler

from tests.torch_twins import carry, close, equal, warm_jax_sampler

POP_D = 3  # the population with the estimated sample age


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    s = warm_jax_sampler(tmp_path_factory.mktemp("torch_sample_age"),
                         ctl=SAMPLE_AGE_VAR_CTL)
    assert list(s.tree.update_sample_age[:s.tree.num_cur_pops]) == [
        False, False, False, True]
    return s, carry(s)


def _mask(s):
    return [bool(x) for x in s.tree.update_sample_age[:s.tree.num_cur_pops]]


@pytest.mark.parametrize("step", [-0.4, 0.5])
def test_sample_age_eval_matches_pallas(twins, step):
    """rubber_band_eval (the plain version, on CPU tensors) in the
    sample-age mode against rubber_band_eval_pallas(interpret=True), for a
    new age below and above the old one: equal Jacobian counts and conflict
    flag, ages within 1e-12, lnld/lnp within 1e-8, conditionals within
    1e-9 (tests/test_sweeps_pallas.py's tolerances for this kernel)."""
    s, t = twins
    tauold = float(s.params.sample_age[POP_D])
    taub1 = float(s.params.tau[int(s.ctx.father_pop[POP_D])])
    taunew = tauold + step * ((taub1 - tauold) if step > 0 else tauold)
    assert 0.0 < taunew < taub1 and tauold > 0.0
    want = rubber_band_eval_pallas(
        s.gen, s.params, s.seq, s.ctx, POP_D, True, jnp.float64(0.0),
        jnp.float64(taub1), jnp.float64(tauold), jnp.float64(taunew), s.cond,
        interpret=True)
    args = [torch.tensor(x, dtype=torch.float64)
            for x in (0.0, taub1, tauold, taunew)]
    sweeps.reset_launch_counts()
    got = sweeps.rubber_band_eval(t["gen"], t["params"], t["seq"], t["ctx"],
                                  POP_D, True, *args, t["cond"])
    assert sweeps.LAUNCHES["rubber_band_sample_age"] == 0  # CPU: plain
    plain = rubber_band_eval_plain(t["gen"], t["params"], t["seq"], t["ctx"],
                                   POP_D, True, *args, t["cond"])
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert float(want[5]) == float(got[5]) and float(want[6]) == float(got[6])
    assert float(got[5]) + float(got[6]) > 0  # some event of D moved
    assert bool(want[7]) == bool(got[7])
    close(want[0], got[0], 1e-12)
    close(want[1], got[1], 1e-12)
    close(want[2], got[2], 1e-9)
    close(want[3], got[3], 1e-8)
    close(want[4], got[4], 1e-8)
    # the leaves of D sit at the proposed age, the other leaves stay at 0
    leaves = got[0][:, :s.gen.num_samples]
    in_d = t["gen"].node_pop[:, :s.gen.num_samples] == POP_D
    assert bool((leaves[in_d] == taunew).all()) and bool(in_d.any())
    assert bool((leaves[~in_d] == 0).all())


def test_sample_age_sweep_matches_xla(twins):
    """update_sample_ages_fused against the XLA update_sample_ages, draw
    for draw: equal accepts, conflicts and general-stream counter; the
    sample age within 1e-15, ages 1e-12, lnld/lnp 1e-8, conditionals
    1e-9."""
    s, t = twins
    C = s.tree.num_cur_pops
    with jax.disable_jit():
        r1 = j_sample_ages(s.gen, s.params, s.seq, s.grng, s.ctx, s.ft.taus,
                           s.lnld, s.lnp, s.cond, C, _mask(s))
    r2 = update_sample_ages_fused(
        t["gen"], t["params"], t["seq"], t["grng"], t["ctx"], t["ft"].taus,
        t["lnld"], t["lnp"], t["cond"], C, _mask(s))
    g1, p1, rs1, ld1, lp1, c1, a1, cf1 = r1
    g2, p2, rs2, ld2, lp2, c2, a2, cf2 = r2
    equal(a1, a2)
    assert int(cf1) == int(cf2)
    assert int(rs1.ctr) == int(rs2.ctr) > int(s.grng.ctr)
    close(p1.sample_age, p2.sample_age, 1e-15)
    close(p1.tau, p2.tau, 0.0)
    close(g1.age, g2.age, 1e-12)
    close(g1.mig_age, g2.mig_age, 1e-12)
    close(ld1, ld2, 1e-8)
    close(lp1, lp2, 1e-8)
    close(c1, c2, 1e-9)


def test_locus_rates_paired_match_xla(twins):
    """update_locus_rates_paired against gphocs_tpu's: the same matching
    and accepts (so the same loci change rate), equal counter advance,
    rates within 1e-15, lnld within 1e-9, conditionals within 1e-10."""
    s, t = twins
    alpha = s.cfg.mcmc.var_rates_alpha
    with jax.disable_jit():
        g1, r1, ld1, c1, a1, dv1 = j_rates(s.gen, s.seq, s.lrng,
                                           s.ft.locus_rate, s.lnld, alpha,
                                           s.cond)
    g2, r2, ld2, c2, a2, dv2 = update_locus_rates_paired(
        t["gen"], t["seq"], t["lrng"], t["ft"].locus_rate, t["lnld"], alpha,
        t["cond"])
    assert int(a1) == int(a2) > 0
    assert int(r1.ctr) == int(r2.ctr) == int(s.lrng.ctr) + 5
    moved1 = np.asarray(g1.mut_rate) != np.asarray(s.gen.mut_rate)
    moved2 = (g2.mut_rate != t["gen"].mut_rate).numpy()
    np.testing.assert_array_equal(moved1, moved2)
    close(g1.mut_rate, g2.mut_rate, 1e-15)
    close(dv1, dv2, 1e-15)
    close(ld1, ld2, 1e-9)
    close(c1, c2, 1e-10)
    # each pair keeps its rate sum, so the mean stays 1
    assert abs(float(g2.mut_rate.mean()) - 1.0) < 1e-12


def test_five_iterations_sample_age_var_match_jax(twins):
    """Five iterations of both samplers on the sample-age + VAR
    configuration from one carried state: equal accept counts and RNG
    counters, trace rows (theta, tau, sample age, m, lnld, lnp) and the
    rate variance within 1e-9 relative."""
    s, t = twins
    port = Sampler(s.cfg, seq_path=s.seq_path, dtype=torch.float64,
                   device="cpu")
    port.initialize()
    for k in ("gen", "params", "seq", "lrng", "grng", "lnld", "lnp", "cond",
              "ft"):
        setattr(port, k, t[k])
    port.rate_var = s.rate_var
    keep = {k: getattr(s, k) for k in ("gen", "params", "lrng", "grng",
                                       "lnld", "lnp", "cond", "rate_var")}
    try:
        with jax.disable_jit():
            st_j, tr_j = s.step_chunk(5, do_migrate=True)
        ctr_j = (int(s.lrng.ctr), int(s.grng.ctr))
        rate_var_j = s.rate_var
    finally:  # the other tests read the warmed state
        for k, v in keep.items():
            setattr(s, k, v)
    st_t, tr_t = port.step_chunk(5, do_migrate=True)
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mig_rate", "acc_taus", "acc_mixing", "acc_locus_rate",
              "tau_conflicts", "num_migs_total"):
        np.testing.assert_array_equal(np.asarray(getattr(st_j, f)),
                                      getattr(st_t, f).numpy(), err_msg=f)
    assert int(st_t.acc_locus_rate) > 0
    assert ctr_j == (int(port.lrng.ctr), int(port.grng.ctr))
    for f in ("theta", "tau", "sample_age", "mig_rate", "lnld_sum",
              "lnp_sum"):
        np.testing.assert_allclose(getattr(tr_t, f).numpy(),
                                   np.asarray(getattr(tr_j, f)), rtol=1e-9,
                                   atol=0, err_msg=f)
    # the sample age moved within the five iterations, and D's leaves with it
    sa = tr_t.sample_age[:, POP_D]
    assert len(set(sa.tolist())) > 1
    S = port.gen.num_samples
    in_d = port.gen.node_pop[:, :S] == POP_D
    assert bool((port.gen.age[:, :S][in_d]
                 == port.params.sample_age[POP_D]).all())
    np.testing.assert_allclose(port.rate_var, rate_var_j, rtol=1e-9)
    _, ld = full_rebuild_and_lnld(port.gen, port.seq)
    torch.testing.assert_close(ld, port.lnld, rtol=0, atol=1e-9)


@pytest.mark.parametrize("ctl, extra", [
    (SAMPLE_AGE_CTL, []), (SAMPLE_AGE_VAR_CTL, ["Variance-Mut"])],
    ids=["const_rates", "var_rates"])
def test_run_sample_age_writes_trace(tmp_path, twins, ctl, extra):
    """Sampler.run on the CPU with an estimated sample age (and VAR rates):
    a tau_D trace column (and Variance-Mut), a TAU_ column for D in the
    acceptance log, the finetune search reaching D's step size, and a
    carried likelihood equal to a rebuild."""
    s, _ = twins
    cfg = parse_control_text(ctl)
    cfg.mcmc.random_seed = 5
    cfg.mcmc.burn_in = 0
    cfg.mcmc.mcmc_iterations = 6
    cfg.mcmc.iterations_per_log = 3
    cfg.mcmc.start_mig = 1
    cfg.mcmc.find_finetunes = True
    cfg.mcmc.find_finetunes_num_steps = 1
    cfg.mcmc.find_finetunes_samples_per_step = 3
    port = Sampler(cfg, seq_path=s.seq_path, dtype=torch.float64,
                   device="cpu")
    cols, rows = port.run(trace_path=str(tmp_path / "trace.log"))
    assert cols[-len(extra) - 3:-2] == ["tau_D"] + extra
    assert rows.shape == (6, len(cols)) and np.all(np.isfinite(rows))
    assert f"TAU_{POP_D:2d}" in port._log_header()
    assert len(set(rows[:, cols.index("tau_D")])) > 1
    ft0 = cfg.mcmc.finetunes.taus[POP_D] or 1.0
    assert port.ft_taus[POP_D].value != ft0  # the search adjusted it
    if extra:
        assert len(set(rows[:, cols.index("Variance-Mut")])) > 1
        assert abs(float(port.gen.mut_rate.mean()) - 1.0) < 1e-12
    _, ld = full_rebuild_and_lnld(port.gen, port.seq)
    torch.testing.assert_close(ld, port.lnld, rtol=0, atol=1e-9)
