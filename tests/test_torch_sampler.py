"""The whole slice: gphocs_tpu_torch's Sampler against gphocs_tpu's
Sampler (f64, fast RNG) from the same carried state, in one process and
sharded over two gloo ranks (tests/mesh_rank.py); plus the package's
import boundary and the driver's refusals."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import SAMPLE_CTL
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.parallel.mesh import LociMesh
from gphocs_tpu_torch.sampler.driver import Sampler

from tests.mesh_rank import run_ranks
from tests.torch_twins import carry, warm_jax_sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    s = warm_jax_sampler(tmp_path_factory.mktemp("torch_sampler"))
    return s, carry(s)


@pytest.fixture(scope="module")
def jax_chunk(twins):
    """Five fused iterations of the JAX sampler, once for the module, from
    the carried state, which is taken before them.  The chunk runs with jit
    disabled, so that JAX and the port evaluate the same IEEE-754
    operations (see test_torch_sweeps).  Returns (carried state, stats,
    trace, per-locus counter, general counter)."""
    s, t = twins
    with jax.disable_jit():
        st_j, tr_j = s.step_chunk(5, do_migrate=True)
    return t, st_j, tr_j, int(s.lrng.ctr), int(s.grng.ctr)


def _match_jax(jax_chunk, st_t, tr_t, lctr, gctr):
    """Equal accept counts and RNG counters, trace rows (theta, tau, m,
    lnld, lnp) within 1e-9 relative."""
    _, st_j, tr_j, lctr_j, gctr_j = jax_chunk
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mig_rate", "acc_taus", "acc_mixing", "tau_conflicts",
              "num_migs_total"):
        np.testing.assert_array_equal(np.asarray(getattr(st_j, f)),
                                      getattr(st_t, f).numpy(), err_msg=f)
    assert (lctr, gctr) == (lctr_j, gctr_j)
    for f in ("theta", "tau", "mig_rate", "lnld_sum", "lnp_sum"):
        np.testing.assert_allclose(getattr(tr_t, f).numpy(),
                                   np.asarray(getattr(tr_j, f)), rtol=1e-9,
                                   atol=0, err_msg=f)


def test_five_iterations_match_jax(twins, jax_chunk):
    """Five fused iterations of both samplers from one carried state
    (_match_jax's criteria)."""
    s, _ = twins
    t = jax_chunk[0]
    port = Sampler(s.cfg, seq_path=s.seq_path, dtype=torch.float64,
                   device="cpu")
    port.initialize()
    for k in ("gen", "params", "seq", "lrng", "grng", "lnld", "lnp", "cond",
              "ft"):
        setattr(port, k, t[k])
    st_t, tr_t = port.step_chunk(5, do_migrate=True)
    _match_jax(jax_chunk, st_t, tr_t, int(port.lrng.ctr),
               int(port.grng.ctr))
    # the carried conditionals stay consistent with the genealogies
    c, ld = full_rebuild_and_lnld(port.gen, port.seq)
    torch.testing.assert_close(ld, port.lnld, rtol=0, atol=1e-9)


@pytest.mark.timeout(120)
def test_five_iterations_on_two_ranks_match_jax(twins, jax_chunk, tmp_path):
    """The port sharded over two gloo ranks (12 loci each) from the same
    carried state, saved with torch.save and each rank keeping its block,
    against JAX's unsharded chunk (_match_jax's criteria): SPR's trip
    groups span the ranks and the sums cross them in all-reduces, so the
    sharded run draws and decides as the unsharded one."""
    s, _ = twins
    torch.save(jax_chunk[0], tmp_path / "state.pt")
    spec = dict(case="carried", ctl="SAMPLE_CTL", seqs=s.seq_path, iters=5,
                world=2, state=str(tmp_path / "state.pt"),
                out=str(tmp_path / "out.pt"))
    run_ranks(spec, tmp_path)
    got = torch.load(spec["out"], weights_only=False)
    _match_jax(jax_chunk, got["stats"], got["trace"],
               int(got["state"]["ctrs"][0]), int(got["state"]["grng"].ctr))


def test_run_writes_trace(tmp_path, twins):
    """Sampler.run on the CPU: trace rows for every sample, the acceptance
    log, and a carried likelihood equal to a rebuild."""
    s, _ = twins
    cfg = parse_control_text(SAMPLE_CTL)
    cfg.mcmc.random_seed = 5
    cfg.mcmc.burn_in = 2
    cfg.mcmc.mcmc_iterations = 6
    cfg.mcmc.iterations_per_log = 3
    cfg.mcmc.start_mig = 1
    port = Sampler(cfg, seq_path=s.seq_path, dtype=torch.float64,
                   device="cpu")
    path = tmp_path / "trace.log"
    cols, rows = port.run(trace_path=str(path), progress=True)
    assert rows.shape == (6, len(cols))
    lines = path.read_text().splitlines()
    assert lines[0].split("\t") == cols and len(lines) == 7
    assert np.all(np.isfinite(rows))
    _, ld = full_rebuild_and_lnld(port.gen, port.seq)
    torch.testing.assert_close(ld, port.lnld, rtol=0, atol=1e-9)
    assert float(port.params.mig_rate[0]) > 0  # sampled at start-mig


def test_package_never_imports_jax():
    code = ("import sys\n"
            "import gphocs_tpu_torch\n"
            "import gphocs_tpu_torch.sampler.driver\n"
            "import gphocs_tpu_torch.sampler.bucketed\n"
            "import gphocs_tpu_torch.checkpoint\n"
            "import gphocs_tpu_torch.debugcheck\n"
            "import gphocs_tpu_torch.cli\n"
            "import gphocs_tpu_torch.tools.coalstats_out\n"
            "import gphocs_tpu_torch.tools.readtrace\n"
            "import gphocs_tpu_torch.tools.convergence\n"
            "import gphocs_tpu_torch.tools.posterior_gate\n"
            "import gphocs_tpu_torch.tools.node_age_probe\n"
            "import gphocs_tpu_torch.tools.alignstats\n"
            "import gphocs_tpu_torch.tools.controlgen\n"
            "import gphocs_tpu_torch.profiling\n"
            "import gphocs_tpu_torch.io.native\n"
            "import gphocs_tpu_torch.ops.sweeps\n"
            "import gphocs_tpu_torch.io.simulate\n"
            "import gphocs_tpu_torch.config.samples\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m.startswith('gphocs_tpu.') or m == 'gphocs_tpu'"
            " for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_cuda_sampler_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = parse_control_text(SAMPLE_CTL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler(cfg, num_loci=4)


@pytest.mark.parametrize("kwargs, item", [
    # the legacy RNG is ported with chains and on a mesh, for one bucket
    (dict(rng_mode="legacy", buckets=2), "require the fast RNG"),
    # chains are ported; with pattern buckets they are refused (a
    # ValueError), as in gphocs_tpu
    (dict(chains=2, buckets=2), "one chain"),
    # admixture is ported; with pattern buckets it is refused (a
    # ValueError), as in gphocs_tpu
    (dict(admixed=[("five", 3, 1, "d")], buckets=2), "one pattern bucket"),
])
def test_unported_options_raise(kwargs, item):
    cfg = parse_control_text(SAMPLE_CTL)
    kwargs = dict(kwargs)
    cfg.admixed = kwargs.pop("admixed", [])
    with pytest.raises(ValueError, match=item):
        Sampler(cfg, num_loci=4, device="cpu", **kwargs)


@pytest.mark.parametrize("chains", [1, 2])
def test_meshed_legacy_sampler_holds_its_block(chains):
    """Sampler(rng_mode="legacy", mesh=...) builds (it raised before the
    legacy RNG ran on a mesh): rank 1 of 2, a prior-only run of 5 loci
    per chain padded to 6, holds rows [3, 6) of every chain of the
    one-process state with loci_multiple=2 (genealogies and Wichmann-Hill
    streams, [C * 3]), the general streams whole, and locus 0's data
    row."""
    cfg = parse_text(SAMPLE_CTL, 23)
    cfg.mcmc.seq_file = "NONE"
    mesh = LociMesh(rank=1, world=2, backend="gloo",
                    device=torch.device("cpu"))
    s = Sampler(cfg, num_loci=5, device="cpu", rng_mode="legacy",
                mesh=mesh, chains=chains)
    one = Sampler(cfg, num_loci=5, device="cpu", rng_mode="legacy",
                  loci_multiple=2, chains=chains)
    s.initialize()
    one.initialize()
    rows = mesh.chain_block(6, chains)
    assert (s.num_loci, s.pad_loci, s.gen.num_loci) == (6, 1, 3 * chains)
    for f in s.gen._fields:
        assert torch.equal(getattr(s.gen, f), getattr(one.gen, f)[rows]), f
    for a, b in zip(s.lrng, one.lrng):
        assert a.shape == (3 * chains,) and torch.equal(a, b[rows])
    for a, b in zip(s.grng, one.grng):
        assert torch.equal(a, b)
    assert not s.gen.valid.view(chains, 3)[:, 2].any()
    for a, b in zip(s.ref_seq, one.seq):
        assert a is None or torch.equal(a, b[:1])


def test_legacy_chains_run():
    """Sampler(rng_mode="legacy", chains=2) runs (it raised before the
    legacy RNG took chains): a prior-only iteration of two chains, with
    per-locus streams [2 L] and general streams [2, 1] that moved."""
    cfg = parse_text(SAMPLE_CTL, 23)
    cfg.mcmc.seq_file = "NONE"
    s = Sampler(cfg, num_loci=4, device="cpu", rng_mode="legacy", chains=2)
    s.initialize()
    g0 = s.grng
    st, tr = s.step_chunk(1, do_migrate=False)
    assert s.lrng.x.shape == (8,) and s.grng.x.shape == (2, 1)
    assert not torch.equal(s.grng.z, g0.z)
    assert st.acc_theta.shape == (2,) and tr.theta.shape == (1, 2, 7)


def test_two_chains_match_jax_vmapped_chains(tmp_path):
    """gphocs_tpu's vmapped chains (Sampler(chains=2), fast RNG) carried
    into the port's chain layout through gphocs_tpu's checkpoint file
    (equal to state.from_numpy's carry) and stepped on both sides for three
    iterations from a hot band: equal accept counts per chain and equal
    counters, each chain's trace rows (theta, tau, m, lnld, lnp) within
    1e-9 relative, as the one-chain twin above.  JAX's chunk runs jitted:
    under jax.disable_jit() vmap batches every eager primitive, and one
    iteration took ~2 minutes on the test machine's CPU.  Compiled XLA
    contracts and reorders f64 arithmetic (~5e-9 on a node-age lnp of
    ~1e3, ROADMAP Queue 3), so the values agree to ~1e-11 relative, not
    bit for bit, well inside 1e-9; every decision agrees."""
    import jax.numpy as jnp
    from gphocs_tpu.checkpoint import save_checkpoint as jax_save
    from gphocs_tpu.config import parse_control_text as jax_parse
    from gphocs_tpu.io.simulate import simulate_seq_file
    from gphocs_tpu.kernels.common import gen_log_prior as jax_prior
    from gphocs_tpu.model import build_poptree
    from gphocs_tpu.sampler.driver import Sampler as JaxSampler

    from gphocs_tpu_torch.checkpoint import load_checkpoint
    from tests.torch_twins import carry

    cfg = jax_parse(SAMPLE_CTL)
    path = str(tmp_path / "seqs.txt")
    simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=6,
                      seq_len=300, seed=11)
    cfg = jax_parse(SAMPLE_CTL)
    cfg.mcmc.random_seed = 23
    cfg.mcmc.start_mig = 0
    s = JaxSampler(cfg, seq_path=path, dtype=jnp.float64, rng_mode="fast",
                   chains=2)
    s.initialize()
    s.params = s.params._replace(
        mig_rate=jnp.full_like(s.params.mig_rate, 2e5))
    s.lnp = jax.jit(jax.vmap(lambda g, p: jax_prior(g, p, s.ctx)))(
        s.gen, s.params)
    t = carry(s)
    port = Sampler(parse_text(SAMPLE_CTL, 23), seq_path=path,
                   dtype=torch.float64, device="cpu", chains=2)
    port.initialize()
    # gphocs_tpu's chain checkpoint loads into the port's chain layout
    jax_save(s, str(tmp_path / "jax.npz"), 0)
    assert load_checkpoint(port, str(tmp_path / "jax.npz")) == 0
    for k in ("gen", "params", "lrng", "grng", "lnld", "lnp", "cond"):
        for a, b in zip(getattr(port, k), t[k]):
            assert (a is None and b is None) or torch.equal(a, b), k
    port.ft = t["ft"]
    st_j, tr_j = s.step_chunk(3, do_migrate=True)
    st_t, tr_t = port.step_chunk(3, do_migrate=True)
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mig_rate", "acc_taus", "acc_mixing", "tau_conflicts",
              "num_migs_total"):
        np.testing.assert_array_equal(np.asarray(getattr(st_j, f)),
                                      getattr(st_t, f).numpy(), err_msg=f)
    assert int(np.asarray(st_j.acc_spr).min()) > 0
    np.testing.assert_array_equal(np.asarray(s.lrng.ctr),
                                  port.lrng.ctr.numpy())
    np.testing.assert_array_equal(np.asarray(s.grng.ctr),
                                  port.grng.ctr.numpy())
    for f in ("theta", "tau", "mig_rate", "lnld_sum", "lnp_sum"):
        # JAX's trace is [C, K, ...], the port's chunk [K, C, ...]
        np.testing.assert_allclose(getattr(tr_t, f).numpy(),
                                   np.swapaxes(np.asarray(getattr(tr_j, f)),
                                               0, 1),
                                   rtol=1e-9, atol=0, err_msg=f)


def parse_text(text, seed):
    cfg = parse_control_text(text)
    cfg.mcmc.random_seed = seed
    cfg.mcmc.start_mig = 0
    return cfg
