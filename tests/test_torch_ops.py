"""gphocs_tpu_torch pruning, likelihood cache, coalescent statistics and
shared kernel math against gphocs_tpu at f64, on a warmed JAX state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gphocs_tpu.kernels import common as JC
from gphocs_tpu.ops import coalstats as JS
from gphocs_tpu.ops import likelihood_cache as JL
from gphocs_tpu.ops import pruning as JP
from gphocs_tpu.utils import reflect as j_reflect
from gphocs_tpu_torch.kernels import common as TC
from gphocs_tpu_torch.ops import coalstats as TS
from gphocs_tpu_torch.ops import likelihood_cache as TL
from gphocs_tpu_torch.ops import pruning as TP
from gphocs_tpu_torch.utils import log_gamma_density, reflect

from tests.torch_twins import carry, close, equal, warm_jax_sampler


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    s = warm_jax_sampler(tmp_path_factory.mktemp("torch_ops"))
    return s, carry(s)


def test_full_build_and_lnld(twins):
    s, t = twins
    c_j, ld_j = JL.full_rebuild_and_lnld(s.gen, s.seq)
    c_t, ld_t = TL.full_rebuild_and_lnld(t["gen"], t["seq"])
    close(c_j, c_t, 1e-10)
    close(ld_j, ld_t, 1e-10)
    close(JP.data_log_likelihood(s.gen, s.seq),
          TP.data_log_likelihood(t["gen"], t["seq"]), 1e-10)
    # the carried state is consistent
    close(s.lnld, ld_t, 1e-9)


def test_refresh_after_age_move(twins):
    """Refresh of two dirty seeds after moving their ages matches JAX."""
    s, t = twins
    S = s.gen.num_samples
    rs = np.random.default_rng(3)
    L = s.gen.num_loci
    nodes = rs.integers(S, 2 * S - 1, size=(L, 2))
    scale = 1.0 + 0.01 * rs.random((L, 2))
    age = np.array(s.gen.age)
    for k in range(2):
        age[np.arange(L), nodes[:, k]] *= scale[:, k]
    dirty = np.zeros(age.shape, bool)
    dirty[np.arange(L)[:, None], nodes] = True
    g_j = s.gen._replace(age=jnp.asarray(age))
    g_t = t["gen"]._replace(age=torch.as_tensor(age))
    c_j, ld_j = JL.refresh_and_lnld(s.cond, g_j, s.seq, jnp.asarray(dirty))
    c_t, ld_t = TL.refresh_and_lnld(t["cond"], g_t, t["seq"],
                                    torch.as_tensor(dirty))
    close(c_j, c_t, 1e-10)
    close(ld_j, ld_t, 1e-10)


def test_edge_p_and_leaves():
    x = np.concatenate([np.linspace(-1e-3, 2.0, 101), [1e-120, 1e-90]])
    close(JP._edge_p(jnp.asarray(x)), TP.edge_p(torch.as_tensor(x)), 1e-16)
    codes = np.random.default_rng(1).integers(0, 5, size=(3, 8, 11))
    equal(JP.leaf_conditionals(jnp.asarray(codes, jnp.int8), jnp.float64),
          TP.leaf_conditionals(torch.as_tensor(codes), torch.float64))


def test_sufficient_stats_and_prior(twins):
    s, t = twins
    st_j = JC.full_stats(s.gen, s.params, s.ctx)
    st_t = TC.full_stats(t["gen"], t["params"], t["ctx"])
    for f in ("coal_stats", "mig_stats"):
        close(getattr(st_j, f), getattr(st_t, f), 1e-10)
    for f in ("num_coals", "num_migs"):
        equal(getattr(st_j, f), getattr(st_t, f))
    close(JS.genealogy_log_prior(st_j, s.params),
          TS.genealogy_log_prior(st_t, t["params"]), 1e-10)
    close(s.lnp, TC.gen_log_prior(t["gen"], t["params"], t["ctx"]), 1e-9)
    seg_j = JS.segments(s.gen, s.ctx.band_source)
    seg_t = TS.segments(t["gen"], t["ctx"].band_source)
    for f in seg_j._fields:
        close(getattr(seg_j, f), getattr(seg_t, f), 0.0)


def test_move_deltas_and_presence(twins):
    s, t = twins
    rs = np.random.default_rng(7)
    L, N = s.gen.age.shape
    S = (N + 1) // 2
    bs_j, be_j = JC.band_windows(s.ctx, s.params.tau)
    bs_t, be_t = TC.band_windows(t["ctx"], t["params"].tau)
    close(bs_j, bs_t, 0.0)
    close(be_j, be_t, 0.0)
    inode = rs.integers(S, N, size=L)
    t_old = np.asarray(s.gen.age)[np.arange(L), inode]
    tnew = t_old * (1.0 + 0.2 * (rs.random(L) - 0.5))
    d_j = JS.node_age_move_delta(s.gen, s.params, s.ctx, jnp.asarray(inode),
                                 jnp.asarray(tnew), bs_j, be_j)
    d_t = TS.node_age_move_delta(t["gen"], t["params"], t["ctx"],
                                 torch.as_tensor(inode), torch.as_tensor(tnew),
                                 bs_t, be_t)
    close(d_j, d_t, 1e-10)
    M = s.gen.max_migs
    for slot in range(M):
        mnew = np.asarray(s.gen.mig_age)[:, slot] * 1.05 + 1e-6
        d_j = JS.mig_age_move_delta(s.gen, s.params, s.ctx, slot,
                                    jnp.asarray(mnew), bs_j, be_j)
        d_t = TS.mig_age_move_delta(t["gen"], t["params"], t["ctx"], slot,
                                    torch.as_tensor(mnew), bs_t, be_t)
        close(d_j, d_t, 1e-10)
    pop = rs.integers(0, s.ctx.num_pops, size=L)
    w0 = rs.random(L) * 1e-4
    w1 = w0 + rs.random(L) * 1e-3
    excl = rs.integers(0, N, size=L)
    pend_j = JC.pop_end(s.ctx, s.params.tau)
    pend_t = TC.pop_end(t["ctx"], t["params"].tau)
    i_j = JS.lineage_presence_integral(
        s.gen, s.ctx.band_source, jnp.asarray(pop), jnp.asarray(w0),
        jnp.asarray(w1), s.params.tau, pend_j, s.ctx.is_ancestral,
        exclude_edge=jnp.asarray(excl, jnp.int32))
    i_t = TS.lineage_presence_integral(
        t["gen"], t["ctx"].band_source, torch.as_tensor(pop),
        torch.as_tensor(w0), torch.as_tensor(w1), t["params"].tau, pend_t,
        t["ctx"].is_ancestral, exclude_edge=torch.as_tensor(excl))
    close(i_j, i_t, 1e-12)


def test_mig_neighbours(twins):
    s, t = twins
    L = s.gen.num_loci
    node = np.random.default_rng(2).integers(0, s.gen.num_nodes, size=L)
    for age in (np.full(L, -np.inf), np.full(L, np.inf),
                np.asarray(s.gen.mig_age).mean(axis=1)):
        close(JC.first_mig_above(s.gen, jnp.asarray(node, jnp.int32),
                                 jnp.asarray(age)),
              TC.first_mig_above(t["gen"], torch.as_tensor(node),
                                 torch.as_tensor(age)), 0.0)
        close(JC.last_mig_below(s.gen, jnp.asarray(node, jnp.int32),
                                jnp.asarray(age)),
              TC.last_mig_below(t["gen"], torch.as_tensor(node),
                                torch.as_tensor(age)), 0.0)


def test_reflect_and_gamma_density():
    rs = np.random.default_rng(4)
    a = rs.random(500) - 0.5
    b = a + rs.random(500) * rs.choice([1e-12, 1e-3, 1.0], size=500)
    x = a + (rs.random(500) - 0.5) * rs.choice([0.1, 10.0, 1e3], size=500)
    close(j_reflect(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)),
          reflect(torch.as_tensor(x), torch.as_tensor(a),
                  torch.as_tensor(b)), 1e-12)
    from gphocs_tpu.utils import log_gamma_density as j_lgd

    al = np.array([1.0, 2.0, 0.002, 3.5])
    be = np.array([10000.0, 20000.0, 1e-5, 2.0])
    v = np.array([1e-4, 5e-5, 0.3, 1.7])
    close(j_lgd(jnp.asarray(al), jnp.asarray(be), jnp.asarray(v)),
          log_gamma_density(torch.as_tensor(al), torch.as_tensor(be),
                            torch.as_tensor(v)), 1e-9, rtol=1e-12)
