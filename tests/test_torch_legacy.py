"""The conformance mode of gphocs_tpu_torch (the Wichmann-Hill streams,
`rng_mode="legacy"`) against gphocs_tpu's legacy XLA path at f64:

  * each module draw for draw, with JAX jit disabled so that both packages
    evaluate the same IEEE-754 operations, on states of the port's legacy
    sampler carried into JAX: equal stream states after the call, equal
    accept counts, reals within 1e-12;
  * a 2-iteration chunk of Sampler(rng_mode="legacy") in both packages
    from their own initializations (whose arrays must agree): plain, with
    D's sample age and VAR locus rates, and admixed; accept counts and
    streams equal, trace rows within 1e-9 relative;
  * checkpoints across the packages: gphocs_tpu's legacy checkpoint
    resumed in the port, and the port's read by gphocs_tpu's loader.

gphocs_tpu's chunks run jitted, once per workload (the module fixture
`jax_runs`): eagerly, one of its iterations costs 7-12 s of dispatch on
the CPU and the first 30 s, three times this file's budget for them.
Jitted, XLA's f64 arithmetic (its division is not IEEE's:
gphocs_tpu/rng.py:_div) moves the admixed chunk's lnp by 2e-10 relative
in two iterations; the streams and every decision stay equal.  Eagerly
the chunks agree to the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gphocs_tpu import rng as JR
from gphocs_tpu import state as JS
from gphocs_tpu.checkpoint import load_checkpoint as jax_load
from gphocs_tpu.checkpoint import save_checkpoint as jax_save
from gphocs_tpu.config import parse_control_text as jax_parse
from gphocs_tpu.kernels import common as JC
from gphocs_tpu.model import build_poptree as jax_tree
from gphocs_tpu.sampler.driver import Sampler as JaxSampler

from gphocs_tpu_torch import checkpoint as TCK
from gphocs_tpu_torch import rng as TR
from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import (ADMIX_CTL, SAMPLE_AGE_VAR_CTL,
                                             SAMPLE_CTL)
from gphocs_tpu_torch.io.simulate import simulate_seq_file
from gphocs_tpu_torch.kernels import common as TC
from gphocs_tpu_torch.model import build_poptree
from gphocs_tpu_torch.ops import sweeps
from gphocs_tpu_torch.sampler.driver import Sampler

from tests.torch_twins import F64  # (and one intra-op thread)

CASES = {"plain": SAMPLE_CTL, "sample_age_var": SAMPLE_AGE_VAR_CTL,
         "admix": ADMIX_CTL}
ITERS = 2
STAT_FIELDS = ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
               "acc_mig_rate", "acc_taus", "acc_mixing", "acc_locus_rate",
               "acc_admix", "tau_conflicts", "num_migs_total")
TRACE_FIELDS = ("theta", "tau", "sample_age", "mig_rate", "admix_coeff",
                "lnld_sum", "lnp_sum")


def _cfg(parse, name, seqs):
    cfg = parse(CASES[name])
    cfg.mcmc.random_seed = 17
    cfg.mcmc.start_mig = 0
    cfg.mcmc.seq_file = seqs
    return cfg


def _port(name, seqs):
    """The port's legacy sampler of a workload, initialized, with its
    migration rates drawn (the start-mig step)."""
    s = Sampler(_cfg(parse_control_text, name, seqs), dtype=torch.float64,
                device="cpu", rng_mode="legacy")
    s.initialize()
    s._sample_mig_rates_device()
    return s


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("legacy") / "seqs.txt")
    cfg = parse_control_text(SAMPLE_CTL)
    simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=24,
                      seq_len=300, seed=11)
    return path


@pytest.fixture(scope="module")
def jax_runs(seqs, tmp_path_factory):
    """Per workload, on first use: gphocs_tpu's legacy sampler,
    initialized, checkpointed (iteration 0), then ITERS iterations (one
    jitted chunk).  Gives (sampler, checkpoint path, stats, trace)."""
    out = {}
    tmp = tmp_path_factory.mktemp("legacy_ck")

    def get(name):
        if name not in out:
            js = JaxSampler(_cfg(jax_parse, name, seqs), dtype=jnp.float64,
                            rng_mode="legacy")
            ck = str(tmp / f"{name}.npz")
            js.initialize()
            js._sample_mig_rates_device()
            jax_save(js, ck, 0)
            st, tr = js.step_chunk(ITERS, do_migrate=True)
            out[name] = (js, ck, st, tr)
        return out[name]

    return get


def _same_streams(j, t):
    for f in ("x", "y", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)


def _match_chunk(run, port, st, tr):
    """Equal accept counts and streams; trace rows within 1e-9 relative."""
    js, _, st_j, tr_j = run
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(st_j, f)),
                                      getattr(st, f).numpy(), err_msg=f)
    _same_streams(js.lrng, port.lrng)
    _same_streams(js.grng, port.grng)
    for f in TRACE_FIELDS:
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(tr_j, f)), rtol=1e-9,
                                   atol=0, err_msg=f)
    np.testing.assert_allclose(port.rate_var, js.rate_var, rtol=1e-9)


@pytest.mark.parametrize("name", list(CASES))
def test_two_iterations_match_jax(name, seqs, jax_runs):
    """The two packages' legacy initializations are equal (genealogies,
    parameters, streams), and so are ITERS iterations from them (the
    criteria of _match_chunk).  The node-age, migration-age and SPR sweeps
    ran as tensor code, their kernels never."""
    run = jax_runs(name)
    js = run[0]
    port = _port(name, seqs)
    sweeps.reset_launch_counts()
    st, tr = port.step_chunk(ITERS, do_migrate=True)
    assert {k: v for k, v in sweeps.LAUNCHES.items() if v} == {
        "node_age_plain": ITERS, "mig_age_plain": ITERS,
        "spr_plain": ITERS}
    _match_chunk(run, port, st, tr)
    # the genealogies' integer arrays at the end
    for f in ("father", "lson", "rson", "node_pop", "root", "mig_branch",
              "mig_band"):
        np.testing.assert_array_equal(np.asarray(getattr(js.gen, f)),
                                      getattr(port.gen, f).numpy(),
                                      err_msg=f)


def test_initializations_are_equal(seqs, jax_runs):
    """Before any iteration: gphocs_tpu's legacy initialization (its
    checkpoint of iteration 0) and the port's have the same arrays, of the
    same dtypes: genealogies, parameters and streams equal, the carried
    conditionals, lnld and lnp within 1e-9 relative (the two packages add
    their sums in different orders)."""
    _, ck, _, _ = jax_runs("admix")
    port = _port("admix", seqs)
    mine = str(ck) + ".port.npz"
    TCK.save_checkpoint(port, mine, 0)
    a, b = np.load(ck), np.load(mine)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        if k in ("cond", "lnld", "lnp"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_jax_legacy_checkpoint_resumes_in_the_port(name, seqs, jax_runs):
    """gphocs_tpu's legacy checkpoint of iteration 0 (lrng_x/y/z,
    grng_x/y/z), loaded into the port's sampler, goes on as gphocs_tpu's
    run from it does."""
    run = jax_runs(name)
    port = Sampler(_cfg(parse_control_text, name, seqs), dtype=torch.float64,
                   device="cpu", rng_mode="legacy")
    port.initialize()
    assert TCK.load_checkpoint(port, run[1]) == 0
    assert isinstance(port.lrng, TR.WhRngState)
    st, tr = port.step_chunk(ITERS, do_migrate=True)
    _match_chunk(run, port, st, tr)


def test_port_legacy_checkpoint_loads_in_jax(seqs, jax_runs, tmp_path):
    """The port's legacy checkpoint after ITERS iterations has the keys and
    dtypes of gphocs_tpu's, and gphocs_tpu's loader restores the port's
    state from it."""
    js, ck, _, _ = jax_runs("plain")
    port = _port("plain", seqs)
    port.step_chunk(ITERS, do_migrate=True)
    path = str(tmp_path / "port.npz")
    TCK.save_checkpoint(port, path, ITERS)
    a, b = np.load(ck), np.load(path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    assert jax_load(js, path) == ITERS
    _same_streams(js.lrng, port.lrng)
    _same_streams(js.grng, port.grng)
    np.testing.assert_array_equal(np.asarray(js.gen.father),
                                  port.gen.father.numpy())
    np.testing.assert_array_equal(np.asarray(js.cond), port.cond.numpy())
    np.testing.assert_array_equal(np.asarray(js.params.theta),
                                  port.params.theta.numpy())


def test_legacy_state_refuses_the_kernels(seqs):
    """The node-age, migration-age and SPR kernel wrappers raise TypeError
    on a Wichmann-Hill state, on the CPU too: nothing falls back."""
    s = _port("plain", seqs)
    args = dict(node_age=(s.gen, s.params, s.seq, s.lrng, s.ctx,
                          s.ft.coal_time, s.lnld, s.lnp, s.cond),
                mig_age=(s.gen, s.params, s.lrng, s.ctx, s.ft.mig_time,
                         s.lnp),
                spr=(s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld, s.cond))
    for kernel, a in args.items():
        with pytest.raises(TypeError, match="Wichmann-Hill"):
            getattr(sweeps, f"{kernel}_sweep")(*a)


# ---- the modules, draw for draw, on carried states ----------------------

def to_jax(obj, cls):
    """A port NamedTuple as gphocs_tpu's `cls`: int32 indices, int8 bases,
    uint32 streams."""
    def conv(name, t):
        if t is None:
            return None
        a = t.detach().cpu().numpy()
        if a.dtype == np.int64:
            a = a.astype(np.uint32 if cls is JR.RngState
                         else np.int8 if name == "leaf_base" else np.int32)
        return jnp.asarray(a)

    return cls(*(conv(f, getattr(obj, f)) for f in cls._fields))


@pytest.fixture(scope="module")
def hot(seqs):
    """The port's legacy sampler on SAMPLE_CTL with a hot band, stepped
    until migration events are present, and its state as JAX arrays."""
    s = _port("plain", seqs)
    s.params = s.params._replace(
        mig_rate=torch.full_like(s.params.mig_rate, 2e5))
    s.lnp = TC.gen_log_prior(s.gen, s.params, s.ctx)
    for _ in range(6):
        s.step_chunk(1, do_migrate=True)
        if int((s.gen.mig_branch >= 0).sum()) > 5:
            break
    assert int((s.gen.mig_branch >= 0).sum()) > 5
    return _twins(s, SAMPLE_CTL)


def _twins(s, ctl):
    from gphocs_tpu.kernels.common import make_context

    return s, dict(gen=to_jax(s.gen, JS.GenState),
                   params=to_jax(s.params, JS.Params),
                   seq=to_jax(s.seq, JS.SeqData),
                   lrng=to_jax(s.lrng, JR.RngState),
                   grng=to_jax(s.grng, JR.RngState),
                   ctx=make_context(jax_tree(jax_parse(ctl)), jnp.float64),
                   lnld=jnp.asarray(s.lnld.numpy()),
                   lnp=jnp.asarray(s.lnp.numpy()),
                   cond=jnp.asarray(s.cond.numpy()))


@pytest.fixture(scope="module")
def sample_age_state(seqs):
    s = _port("sample_age_var", seqs)
    s.step_chunk(1, do_migrate=True)
    return _twins(s, SAMPLE_AGE_VAR_CTL)


@pytest.fixture(scope="module")
def admix_state(seqs):
    s = _port("admix", seqs)
    s.step_chunk(1, do_migrate=True)
    return _twins(s, ADMIX_CTL)


def _close(j, t, tol=1e-12):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _same_gen(j, t):
    for f in t._fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_mh_accepts_draw_where_the_reference_does(hot):
    """draw_accept and scalar_mh_accept against gphocs_tpu's mh_accept and
    scalar_mh_accept: the uniform only on the mask where lnacc < 0, and on
    the general stream only without a conflict and where lnacc < 0."""
    s, j = hot
    L = s.gen.num_loci
    r = np.random.default_rng(3)
    lnacc = r.normal(0.0, 1.0, L)
    mask = r.random(L) < 0.7
    with jax.disable_jit():
        acc_j, rng_j = JC.mh_accept(j["lrng"], jnp.asarray(lnacc),
                                    jnp.asarray(mask))
    acc_t, _, rng_t = TC.draw_accept(s.lrng, torch.as_tensor(lnacc),
                                     torch.as_tensor(mask))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    _same_streams(rng_j, rng_t)
    assert not np.array_equal(np.asarray(rng_j.x), s.lrng.x.numpy())
    g_j, g_t = j["grng"], s.grng
    for lnacc, conflict in ((-0.5, False), (0.3, False), (-2.0, True),
                            (-0.1, False), (-30.0, False)):
        with jax.disable_jit():
            a_j, g_j = JC.scalar_mh_accept(g_j, jnp.float64(lnacc),
                                           jnp.asarray(conflict))
        a_t, g_t = TC.scalar_mh_accept(g_t, torch.tensor(lnacc,
                                                         dtype=F64),
                                       conflict)
        assert bool(a_t) == bool(a_j)
        _same_streams(g_j, g_t)


def test_node_ages_match_jax(hot):
    from gphocs_tpu.kernels.node_age import update_internal_node_ages as J
    from gphocs_tpu_torch.kernels.node_age import (
        update_internal_node_ages as T)

    s, j = hot
    with jax.disable_jit():
        out_j = J(j["gen"], j["params"], j["seq"], j["lrng"], j["ctx"],
                  jnp.float64(float(s.ft.coal_time)), j["lnld"], j["lnp"],
                  j["cond"])
    out_t = T(s.gen, s.params, s.seq, s.lrng, s.ctx, s.ft.coal_time, s.lnld,
              s.lnp, s.cond)
    _same_gen(out_j[0], out_t[0])
    _same_streams(out_j[1], out_t[1])
    for a, b in zip(out_j[2:5], out_t[2:5]):
        _close(a, b)
    assert int(out_t[5]) == int(out_j[5]) > 0


def test_mig_ages_match_jax(hot):
    from gphocs_tpu.kernels.mig_age import update_mig_ages as J
    from gphocs_tpu_torch.kernels.mig_age import update_mig_ages as T

    s, j = hot
    with jax.disable_jit():
        out_j = J(j["gen"], j["params"], j["lrng"], j["ctx"],
                  jnp.float64(float(s.ft.mig_time)), j["lnp"])
    out_t = T(s.gen, s.params, s.lrng, s.ctx, s.ft.mig_time, s.lnp)
    _same_gen(out_j[0], out_t[0])
    _same_streams(out_j[1], out_t[1])
    _close(out_j[2], out_t[2])
    assert int(out_t[3]) == int(out_j[3]) > 0


@pytest.mark.parametrize("state", ["hot", "admix_state"])
def test_spr_matches_jax(state, request):
    """gphocs_tpu's XLA update_spr against the port's plain SPR sweep, on
    the hot state and on an admixed one (the admixed leaves' uniform on
    their own steps only)."""
    from gphocs_tpu.kernels.spr import update_spr as J

    s, j = request.getfixturevalue(state)
    with jax.disable_jit():
        out_j = J(j["gen"], j["params"], j["seq"], j["lrng"], j["ctx"],
                  j["lnld"], j["cond"])
    out_t = sweeps.spr_sweep_plain(s.gen, s.params, s.seq, s.lrng, s.ctx,
                                   s.lnld, s.cond)
    _same_gen(out_j[0], out_t[0])
    _same_streams(out_j[1], out_t[1])
    _close(out_j[2], out_t[2])
    _close(out_j[3], out_t[3])
    assert int(out_t[4]) == int(out_j[4]) > 0


def test_taus_and_sample_ages_match_jax(sample_age_state):
    """gphocs_tpu's XLA update_taus and update_sample_ages (the legacy
    path's) against the port's, whose evaluation is the rubber band's
    plain version here (its kernel on the card)."""
    from gphocs_tpu.kernels.tau import update_sample_ages as JSA
    from gphocs_tpu.kernels.tau import update_taus as JT
    from gphocs_tpu_torch.kernels.tau import (update_sample_ages_fused,
                                              update_taus_fused)

    s, j = sample_age_state
    P, Pc = s.tree.num_pops, s.tree.num_cur_pops
    mask = [bool(x) for x in s.tree.update_sample_age[:Pc]]
    ft = jnp.asarray(s.ft.taus.numpy())
    with jax.disable_jit():
        out_j = JT(j["gen"], j["params"], j["seq"], j["grng"], j["ctx"], ft,
                   j["lnld"], j["lnp"], j["cond"], P, Pc)
        out_j2 = JSA(out_j[0], out_j[1], j["seq"], out_j[2], j["ctx"], ft,
                     out_j[3], out_j[4], out_j[5], Pc, mask)
    out_t = update_taus_fused(s.gen, s.params, s.seq, s.grng, s.ctx,
                              s.ft.taus, s.lnld, s.lnp, s.cond, P, Pc)
    out_t2 = update_sample_ages_fused(*out_t[:2], s.seq, out_t[2], s.ctx,
                                      s.ft.taus, *out_t[3:6], Pc, mask)
    for oj, ot in ((out_j, out_t), (out_j2, out_t2)):
        _same_gen(oj[0], ot[0])
        for f in ("tau", "sample_age"):
            _close(getattr(oj[1], f), getattr(ot[1], f))
        _same_streams(oj[2], ot[2])
        for a, b in zip(oj[3:6], ot[3:6]):
            _close(a, b, 1e-10)
        np.testing.assert_array_equal(ot[6].numpy(), np.asarray(oj[6]))
        assert int(ot[7]) == int(oj[7])
    assert int(out_t2[6][3]) + int(out_t[6].sum()) > 0


def test_thetas_mig_rates_and_mixing_match_jax(hot):
    """The sequential theta and migration-rate scans and mixing on the
    general stream, one after another as in the iteration."""
    from gphocs_tpu.kernels.common import full_stats as jstats
    from gphocs_tpu.kernels.mixing import update_mixing as JMIX
    from gphocs_tpu.kernels.scalar_params import update_mig_rates as JM
    from gphocs_tpu.kernels.scalar_params import update_thetas as JTH
    from gphocs_tpu_torch.kernels.mixing import update_mixing_buckets
    from gphocs_tpu_torch.kernels.scalar_params import (update_mig_rates,
                                                        update_thetas)

    s, j = hot
    f = {k: float(getattr(s.ft, k)) for k in ("theta", "mig_rate",
                                              "mixing")}
    with jax.disable_jit():
        st_j = jstats(j["gen"], j["params"], j["ctx"])
        pj, gj, lpj, athj = JTH(j["gen"], j["params"], j["grng"], j["ctx"],
                                jnp.float64(f["theta"]), j["lnp"], st_j)
        pj, gj, lpj, amj = JM(j["gen"], pj, gj, j["ctx"],
                              jnp.float64(f["mig_rate"]), lpj, st_j)
        mix_j = JMIX(j["gen"], pj, j["seq"], gj, j["ctx"],
                     jnp.float64(f["mixing"]), j["lnld"], lpj, j["cond"],
                     st_j, s.tree.num_cur_pops)
    st_t = TC.full_stats(s.gen, s.params, s.ctx)
    pt, gt, lpt, atht = update_thetas(s.gen, s.params, s.grng, s.ctx,
                                      s.ft.theta, s.lnp, st_t)
    pt, gt, lpt, amt = update_mig_rates(s.gen, pt, gt, s.ctx,
                                        s.ft.mig_rate, lpt, st_t)
    assert (int(atht), int(amt)) == (int(athj), int(amj))
    assert int(atht) > 0
    for fld in ("theta", "mig_rate"):
        _close(getattr(pj, fld), getattr(pt, fld))
    _close(lpj, lpt)
    _same_streams(gj, gt)
    gens, pt, gt, lnlds, lnps, conds, amix = update_mixing_buckets(
        [s.gen], pt, [s.seq], gt, s.ctx, s.ft.mixing, [s.lnld], [lpt],
        [s.cond], [st_t], s.tree.num_cur_pops)
    _same_gen(mix_j[0], gens[0])
    _close(mix_j[1].tau, pt.tau)
    _same_streams(mix_j[2], gt)
    _close(mix_j[3], lnlds[0], 1e-10)
    _close(mix_j[4], lnps[0], 1e-10)
    assert int(amix) == int(mix_j[6])


def test_admix_coeffs_match_jax(admix_state):
    from gphocs_tpu.kernels.admix import update_admix_coeffs as J
    from gphocs_tpu_torch.kernels.admix import update_admix_coeffs as T

    s, j = admix_state
    with jax.disable_jit():
        out_j = J(j["gen"], j["params"], j["grng"], j["ctx"],
                  jnp.float64(float(s.ft.admix)), j["lnp"])
    out_t = T(s.gen, s.params, s.grng, s.ctx, s.ft.admix, s.lnp)
    _close(out_j[0].admix_coeff, out_t[0].admix_coeff)
    _same_streams(out_j[1], out_t[1])
    _close(out_j[2], out_t[2])
    assert int(out_t[3]) == int(out_j[3])


def test_serial_locus_rates_match_jax(sample_age_state):
    """The serial, reference-coupled rate sweep: each locus's proposal on
    its own stream, the pair likelihood, the variance."""
    from gphocs_tpu.kernels.locus_rate import update_locus_rates as J
    from gphocs_tpu_torch.kernels.locus_rate import update_locus_rates as T

    s, j = sample_age_state
    with jax.disable_jit():
        out_j = J(j["gen"], j["seq"], j["lrng"],
                  jnp.float64(float(s.ft.locus_rate)), j["lnld"], 1.0)
    out_t = T(s.gen, s.seq, s.lrng, s.ft.locus_rate, s.lnld, 1.0)
    _close(out_j[0].mut_rate, out_t[0].mut_rate)
    _same_streams(out_j[1], out_t[1])
    _close(out_j[2], out_t[2], 1e-10)
    assert int(out_t[3]) == int(out_j[3]) > 0
    _close(out_j[4], out_t[4])
