"""Pattern buckets, checkpoints and the coal-stats file of
gphocs_tpu_torch against gphocs_tpu at f64 (fast RNG).

Fixture: 15 loci of the ragged workload (config/samples.py RAGGED_*: loci
of 100 to 4,000 bp) under SAMPLE_AGE_VAR_CTL (an estimated sample age on
D, VAR rates, mixing on) in 3 buckets, the band made hot.  The loci are
five each of three phased-pattern counts, so the buckets hold 5 loci each
at P = 3, 7 and 12.  The JAX sampler runs its bucketed iterations with jit
disabled, so both sides evaluate the same IEEE-754 operations (see
test_torch_sweeps); JAX then compiles every primitive once per shape, and
buckets of one size share every compilation that does not depend on P
(half of the file's time).  Its bucketed mode takes the XLA sweeps on the
CPU, which the port's plain versions equal.  Both samplers are built and
stepped once, in the module fixture: JAX initializes, takes 2 iterations
and writes a checkpoint, the port resumes from it, and both take 2 more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gphocs_tpu import checkpoint as j_ckpt
from gphocs_tpu.config import parse_control_text as j_parse
from gphocs_tpu.kernels.common import gen_log_prior as j_prior
from gphocs_tpu.ops.likelihood_cache import lnld_from_cond as j_lnld
from gphocs_tpu.sampler.driver import Sampler as JSampler
from gphocs_tpu.tools.coalstats_out import write_coal_stats_row as j_cs_row
from gphocs_tpu_torch import checkpoint as t_ckpt
from gphocs_tpu_torch import state as TS
from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import SAMPLE_AGE_VAR_CTL
from gphocs_tpu_torch.io.sequences import (build_seq_data, group_members,
                                           read_seq_file)
from gphocs_tpu_torch.io.simulate import simulate_ragged_file
from gphocs_tpu_torch.kernels.common import gen_log_prior, make_context
from gphocs_tpu_torch.ops.likelihood_cache import lnld_from_cond
from gphocs_tpu_torch.sampler.driver import Sampler
from gphocs_tpu_torch.tools.coalstats_out import write_coal_stats_row

from tests.torch_twins import close, equal

K = 3
# five loci of each phased-pattern count class, from the first 80 loci
CLASSES = ((3,), (7,), (11, 12))
PER_CLASS = 5
INT_FIELDS = ("father", "lson", "rson", "node_pop", "root", "mig_branch",
              "mig_band", "valid")


def _heat_jax(s):
    """Band rate 2e5 and every bucket's prior refreshed."""
    s.params = s.params._replace(
        mig_rate=jnp.full_like(s.params.mig_rate, 2e5))
    s.lnps = tuple(j_prior(g, s.params, s.ctx) for g in s.gens)


def _snapshot(s):
    """Host copies of a sampler's per-bucket state (either package)."""
    conv = TS.to_numpy
    return dict(gens=[conv(g) for g in s.gens],
                keys=[np.asarray(conv(r.key)) for r in s.lrngs],
                ctrs=[int(r.ctr) for r in s.lrngs],
                conds=[np.asarray(conv(c)) for c in s.conds],
                lnlds=[np.asarray(conv(x)) for x in s.lnlds],
                lnps=[np.asarray(conv(x)) for x in s.lnps])


def _ragged_subset(src: str, path: str, cfg) -> None:
    """Write to `path` the first PER_CLASS loci of `src` in each pattern
    count class of CLASSES, in file order."""
    raw = read_seq_file(src, cfg.sample_names, 0)
    counts = build_seq_data(raw, cfg.is_diploid()).pattern_valid.sum(1)
    pick = []
    for cls in CLASSES:
        idx = [i for i, c in enumerate(counts) if c in cls][:PER_CLASS]
        assert len(idx) == PER_CLASS, cls
        pick += idx
    lines = open(src).read().splitlines()
    blocks, i = [], 1
    while i < len(lines):
        n = int(lines[i].split()[1])
        blocks.append(lines[i:i + 1 + n])
        i += 1 + n
    out = [str(len(pick))] + sum((blocks[j] for j in sorted(pick)), [])
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bucketed")
    path = str(d / "seqs.txt")
    simulate_ragged_file(str(d / "ragged.txt"), num_loci=80)
    _ragged_subset(str(d / "ragged.txt"), path,
                   parse_control_text(SAMPLE_AGE_VAR_CTL))
    cfg = j_parse(SAMPLE_AGE_VAR_CTL)
    cfg.mcmc.random_seed = 17
    cfg.mcmc.start_mig = 0
    js = JSampler(cfg, seq_path=path, dtype=jnp.float64, rng_mode="fast",
                  buckets=K)
    js.initialize()
    pcfg = parse_control_text(SAMPLE_AGE_VAR_CTL)
    pcfg.mcmc.random_seed = 17
    pcfg.mcmc.start_mig = 0
    ts = Sampler(pcfg, seq_path=path, device="cpu", buckets=K)
    ts.initialize()
    out = dict(js_init=_snapshot(js), ts_init=_snapshot(ts), js=js, ts=ts,
               j_seqs=[TS.to_numpy(q) for q in js.seqs],
               j_perm=np.asarray(js.bucket_perm), j_sizes=js.bucket_sizes)

    _heat_jax(js)
    with jax.disable_jit():
        js.step_chunk(2, do_migrate=True)
    j_ckpt.save_checkpoint(js, str(d / "jax.npz"), 2)
    # the port resumes from the JAX file and writes its own on that state
    ts2 = Sampler(pcfg, seq_path=path, device="cpu", buckets=K)
    ts2.initialize()
    assert t_ckpt.load_checkpoint(ts2, str(d / "jax.npz")) == 2
    t_ckpt.save_checkpoint(ts2, str(d / "port.npz"), 2)
    with jax.disable_jit():
        st_j, tr_j = js.step_chunk(2, do_migrate=True)
    st_t, tr_t = ts2.step_chunk(2, do_migrate=True)
    out.update(ts2=ts2, st_j=st_j, tr_j=tr_j, st_t=st_t, tr_t=tr_t,
               ckpt_j=np.load(d / "jax.npz"), ckpt_t=np.load(d / "port.npz"))
    return out


def test_bucketed_initialize_matches_jax(run):
    """The same permutation and bucket sizes, per-bucket keys and counters
    and SeqData; the genealogies' integer arrays equal, their reals within
    1e-12, the conditionals (up to ~1e4 with the x4 rescale), lnld and lnp
    within 1e-12 relative (JAX builds them in one compiled call)."""
    ts, j, t = run["ts"], run["js_init"], run["ts_init"]
    assert ts.buckets == K and ts.bucket_sizes == [PER_CLASS] * K
    np.testing.assert_array_equal(run["j_perm"], ts.bucket_perm)
    assert list(run["j_sizes"]) == ts.bucket_sizes
    caps = [q.group_id.shape[1] for q in ts.seqs]
    assert caps == sorted(caps) and caps[0] < caps[-1]
    for k in range(K):
        # every field of JAX's SeqData, then the port's own gather table
        for f in run["j_seqs"][k]._fields:
            np.testing.assert_array_equal(
                getattr(run["j_seqs"][k], f),
                getattr(TS.to_numpy(ts.seqs[k]), f), err_msg=f)
        np.testing.assert_array_equal(
            group_members(run["j_seqs"][k].group_id),
            ts.seqs[k].group_members.numpy())
        np.testing.assert_array_equal(j["keys"][k], t["keys"][k])
        assert j["ctrs"][k] == t["ctrs"][k] == 0
        for f in TS.GenState._fields:
            a, b = getattr(j["gens"][k], f), getattr(t["gens"][k], f)
            if f in INT_FIELDS:
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12,
                                           err_msg=f)
        np.testing.assert_allclose(j["conds"][k], t["conds"][k],
                                   rtol=1e-12, atol=1e-12)
        for f in ("lnlds", "lnps"):
            np.testing.assert_allclose(j[f][k], t[f][k], rtol=1e-12, atol=0,
                                       err_msg=f)


def test_jax_checkpoint_resumes_draw_for_draw(run):
    """From a checkpoint gphocs_tpu wrote after 2 bucketed iterations, 2
    more iterations of each package: equal counters and accepts, equal
    topologies and migration integer arrays, ages within 1e-12, lnld/lnp
    within 1e-9, theta/tau within 1e-12."""
    js, ts = run["js"], run["ts2"]
    st_j, st_t, tr_j, tr_t = run["st_j"], run["st_t"], run["tr_j"], run["tr_t"]
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mig_rate", "acc_taus", "acc_mixing", "acc_locus_rate",
              "tau_conflicts", "num_migs_total"):
        equal(getattr(st_j, f), getattr(st_t, f))
    assert int(st_t.acc_coal_time) > 0 and int(st_t.acc_spr) > 0
    assert int(st_t.num_migs_total) > 0 and int(st_t.acc_locus_rate) > 0
    assert int(js.grng.ctr) == int(ts.grng.ctr)
    for k in range(K):
        assert int(js.lrngs[k].ctr) == int(ts.lrngs[k].ctr)
        for f in INT_FIELDS:
            equal(getattr(js.gens[k], f), getattr(ts.gens[k], f))
        for f in ("age", "mig_age", "mut_rate"):
            close(getattr(js.gens[k], f), getattr(ts.gens[k], f), 1e-12)
        close(js.lnlds[k], ts.lnlds[k], 1e-9)
        close(js.lnps[k], ts.lnps[k], 1e-9)
    for f in ("theta", "tau", "sample_age"):
        close(getattr(tr_j, f), getattr(tr_t, f), 1e-12)
    close(tr_j.lnld_sum, tr_t.lnld_sum, 1e-9)
    assert abs(js.rate_var - ts.rate_var) <= 1e-12


def test_checkpoint_keys_and_dtypes_match_jax(run):
    """The port writes gphocs_tpu's keys with gphocs_tpu's dtypes, and on
    the state it loaded from a JAX file the same values."""
    a, b = run["ckpt_j"], run["ckpt_t"]
    assert sorted(a.files) == sorted(b.files)
    assert "b2_cond" in a.files and "b0_lrng_key" in a.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_coal_stats_row_matches_jax(run, tmp_path):
    """write_coal_stats_row on one unbucketed state (the JAX sampler's
    largest bucket), two partitions: the same text."""
    js = run["js"]
    g, params = js.gens[-1], js.params
    with open(tmp_path / "j.txt", "w") as f:
        j_cs_row(f, 7, g, params, js.ctx, js.tree, 2)
    conv = dict(device="cpu", dtype=torch.float64)
    with open(tmp_path / "t.txt", "w") as f:
        write_coal_stats_row(
            f, 7, [TS.from_numpy(g, TS.GenState, **conv)],
            TS.from_numpy(params._replace(admix_coeff=None), TS.Params,
                          **conv),
            make_context(run["ts"].tree, torch.float64), run["ts"].tree, 2)
    want = (tmp_path / "j.txt").read_text()
    assert len(want.split("\t")) > 10
    assert (tmp_path / "t.txt").read_text() == want


def test_lnld_from_cond_matches_jax(run):
    """The group reduction of lnld_from_cond (sums in pattern order, no
    scatter) on the bucket with het patterns phased into several patterns
    of one group."""
    js = run["js"]
    g, q, c = js.gens[-1], js.seqs[-1], js.conds[-1]
    gid = np.asarray(q.group_id)
    valid = np.asarray(q.pattern_valid)
    repeats = [np.bincount(gid[l][valid[l]]).max() for l in range(len(gid))]
    assert max(repeats) > 1
    conv = dict(device="cpu", dtype=torch.float64)
    got = lnld_from_cond(TS.from_numpy(c, **conv),
                         TS.from_numpy(g, TS.GenState, **conv),
                         TS.from_numpy(q, TS.SeqData, **conv))
    np.testing.assert_allclose(np.asarray(j_lnld(c, g, q)), got.numpy(),
                               rtol=1e-14, atol=0)
    # and the port's own carried lnld of that bucket equals a rebuild
    ts = run["ts2"]
    torch.testing.assert_close(
        lnld_from_cond(ts.conds[-1], ts.gens[-1], ts.seqs[-1]),
        ts.lnlds[-1], rtol=0, atol=1e-9)
    torch.testing.assert_close(gen_log_prior(ts.gens[-1], ts.params, ts.ctx),
                               ts.lnps[-1], rtol=0, atol=1e-9)
