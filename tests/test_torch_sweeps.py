"""Each plain sweep of gphocs_tpu_torch (what ops/sweeps.py runs for CPU
tensors, and what the CUDA kernels are held against) against its JAX XLA
twin, draw for draw, at f64 — with the tolerances of
tests/test_sweeps_pallas.py.  SPR is checked at global trip sync against
the XLA update_spr and at sync_group=8 against spr_sweep_pallas(tile=8)
in interpret mode.

The XLA twins run with jit disabled: both sides then evaluate the same
IEEE-754 operations, and agree to the last bit on this fixture.  (XLA's
compiled scan body contracts and reorders f64 arithmetic; at these
sensitivities, d lnP / d t ~ 2 n / theta ~ 1e5, that alone moves lnp by
~5e-9.)"""

import jax
import numpy as np
import pytest
import torch

from gphocs_tpu.kernels.mig_age import update_mig_ages as j_mig_ages
from gphocs_tpu.kernels.node_age import update_internal_node_ages as j_node
from gphocs_tpu.kernels.spr import update_spr as j_spr
from gphocs_tpu.kernels.tau import update_taus as j_taus
from gphocs_tpu.ops.sweeps_pallas import spr_sweep_pallas
from gphocs_tpu_torch.kernels.spr import update_spr
from gphocs_tpu_torch.kernels.tau import update_taus
from gphocs_tpu_torch.ops import sweeps

from tests.torch_twins import carry, close, equal, warm_jax_sampler


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    s = warm_jax_sampler(tmp_path_factory.mktemp("torch_sweeps"))
    return s, carry(s)


def test_node_age_sweep_matches_xla(twins):
    s, t = twins
    with jax.disable_jit():
        g1, r1, ld1, lp1, c1, a1 = j_node(s.gen, s.params, s.seq, s.lrng,
                                          s.ctx, s.ft.coal_time, s.lnld,
                                          s.lnp, s.cond)
    sweeps.reset_launch_counts()
    g2, r2, ld2, lp2, c2, a2 = sweeps.node_age_sweep(
        t["gen"], t["params"], t["seq"], t["lrng"], t["ctx"],
        t["ft"].coal_time, t["lnld"], t["lnp"], t["cond"])
    assert sweeps.LAUNCHES["node_age"] == 0  # CPU tensors: plain version
    assert int(r1.ctr) == int(r2.ctr)
    assert int(a1) == int(a2) > 0
    close(g1.age, g2.age, 1e-12)
    close(ld1, ld2, 1e-9)
    close(lp1, lp2, 1e-9)
    close(c1, c2, 1e-10)


def test_mig_age_sweep_matches_xla(twins):
    s, t = twins
    with jax.disable_jit():
        g1, r1, lp1, a1 = j_mig_ages(s.gen, s.params, s.lrng, s.ctx,
                                     s.ft.mig_time, s.lnp)
    g2, r2, lp2, a2 = sweeps.mig_age_sweep(t["gen"], t["params"], t["lrng"],
                                           t["ctx"], t["ft"].mig_time,
                                           t["lnp"])
    assert int(r1.ctr) == int(r2.ctr)
    assert int(a1) == int(a2) > 0
    close(g1.mig_age, g2.mig_age, 1e-12)
    close(lp1, lp2, 1e-9)


def test_tau_sweep_matches_xla(twins):
    """update_taus_fused (the iteration's tau step; its rubber-band
    evaluation runs the plain version on the CPU) against the XLA
    update_taus."""
    from gphocs_tpu_torch.kernels.tau import update_taus_fused

    s, t = twins
    P, C = s.tree.num_pops, s.tree.num_cur_pops
    with jax.disable_jit():
        r1 = j_taus(s.gen, s.params, s.seq, s.grng, s.ctx, s.ft.taus,
                    s.lnld, s.lnp, s.cond, P, C)
    args = (t["gen"], t["params"], t["seq"], t["grng"], t["ctx"],
            t["ft"].taus, t["lnld"], t["lnp"], t["cond"], P, C)
    r2 = update_taus_fused(*args)
    r3 = update_taus(*args)
    g1, p1, rs1, ld1, lp1, c1, a1, cf1 = r1
    for g2, p2, rs2, ld2, lp2, c2, a2, cf2 in (r2, r3):
        equal(a1, a2)
        assert int(cf1) == int(cf2)
        assert int(rs1.ctr) == int(rs2.ctr)
        close(p1.tau, p2.tau, 1e-15)
        close(g1.age, g2.age, 1e-12)
        close(g1.mig_age, g2.mig_age, 1e-12)
        close(ld1, ld2, 1e-8)
        close(lp1, lp2, 1e-8)
        close(c1, c2, 1e-9)


def _check_spr(out_j, out_t):
    g1, r1, ld1, c1, a1 = out_j
    g2, r2, ld2, c2, a2 = out_t
    assert int(a1) == int(a2) > 0
    assert int(r1.ctr) == int(r2.ctr)
    for f in ("father", "lson", "rson", "root", "node_pop", "mig_branch",
              "mig_band"):
        equal(getattr(g1, f), getattr(g2, f))
    close(g1.mig_age, g2.mig_age, 1e-12)
    close(g1.age, g2.age, 1e-12)
    close(ld1, ld2, 1e-9)
    close(c1, c2, 1e-10)


def test_spr_sweep_matches_xla(twins):
    """Global trip synchronization (what the CPU route of spr_sweep runs)
    against the XLA update_spr."""
    s, t = twins
    with jax.disable_jit():
        out_j = j_spr(s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld,
                      s.cond)
    out_t = sweeps.spr_sweep(t["gen"], t["params"], t["seq"], t["lrng"],
                             t["ctx"], t["lnld"], t["cond"])
    _check_spr(out_j, out_t)


def test_spr_group_sync_matches_pallas_tiles(twins):
    """sync_group=8 (the CUDA kernel's per-block schedule) against the
    Pallas kernel with 8-lane tiles, in interpret mode: the counter
    advances by the largest draw count over groups."""
    s, t = twins
    out_j = spr_sweep_pallas(s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld,
                             s.cond, tile=8, interpret=True)
    out_t = update_spr(t["gen"], t["params"], t["seq"], t["lrng"], t["ctx"],
                       t["lnld"], t["cond"], sync_group=8)
    _check_spr(out_j, out_t)


def test_wrappers_refuse_what_the_kernels_do_not_take(twins):
    _, t = twins
    meta = t["gen"]._replace(age=t["gen"].age.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        sweeps.mig_age_sweep(meta, t["params"], t["lrng"], t["ctx"],
                             t["ft"].mig_time, t["lnp"])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sweeps.mig_age_sweep(meta, t["params"], t["lrng"]._replace(
            key=t["lrng"].key.to("meta")), t["ctx"], t["ft"].mig_time,
            t["lnp"].to("meta"))
    with pytest.raises(TypeError, match="float32 or float64"):
        sweeps._real_suffix(torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        sweeps._check(t["cond"].transpose(0, 1), "cond", torch.float64,
                      t["cond"].transpose(0, 1).shape)
    assert np.all(t["gen"].valid.numpy())
