"""The whole slice: gphocs_tpu_torch's Sampler against gphocs_tpu's
Sampler (f64, fast RNG) from the same carried state; plus the package's
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
from gphocs_tpu_torch.sampler.driver import Sampler

from tests.torch_twins import carry, warm_jax_sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    s = warm_jax_sampler(tmp_path_factory.mktemp("torch_sampler"))
    return s, carry(s)


def test_five_iterations_match_jax(twins):
    """Five fused iterations of both samplers from one carried state: equal
    accept counts and RNG counters, trace rows (theta, tau, m, lnld, lnp)
    within 1e-9 relative.  The JAX chunk runs with jit disabled, so both
    sides evaluate the same IEEE-754 operations (see test_torch_sweeps)."""
    s, t = twins
    port = Sampler(s.cfg, seq_path=s.seq_path, dtype=torch.float64,
                   device="cpu")
    port.initialize()
    for k in ("gen", "params", "seq", "lrng", "grng", "lnld", "lnp", "cond",
              "ft"):
        setattr(port, k, t[k])
    with jax.disable_jit():
        st_j, tr_j = s.step_chunk(5, do_migrate=True)
    st_t, tr_t = port.step_chunk(5, do_migrate=True)
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mig_rate", "acc_taus", "acc_mixing", "tau_conflicts",
              "num_migs_total"):
        np.testing.assert_array_equal(np.asarray(getattr(st_j, f)),
                                      getattr(st_t, f).numpy(), err_msg=f)
    assert int(s.lrng.ctr) == int(port.lrng.ctr)
    assert int(s.grng.ctr) == int(port.grng.ctr)
    for f in ("theta", "tau", "mig_rate", "lnld_sum", "lnp_sum"):
        np.testing.assert_allclose(getattr(tr_t, f).numpy(),
                                   np.asarray(getattr(tr_j, f)), rtol=1e-9,
                                   atol=0, err_msg=f)
    # the carried conditionals stay consistent with the genealogies
    c, ld = full_rebuild_and_lnld(port.gen, port.seq)
    torch.testing.assert_close(ld, port.lnld, rtol=0, atol=1e-9)


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
    (dict(rng_mode="legacy"), "item 17"),
    # chains are ported; with pattern buckets they are refused (a
    # ValueError), as in gphocs_tpu
    (dict(chains=2, buckets=2), "one chain"),
    (dict(admixed=[("five", 3, 1, "d")]), "item 10b"),
    (dict(mesh=object()), "item 15"),
])
def test_unported_options_raise(kwargs, item):
    cfg = parse_control_text(SAMPLE_CTL)
    kwargs = dict(kwargs)
    cfg.admixed = kwargs.pop("admixed", [])
    err = ValueError if "chains" in kwargs else NotImplementedError
    with pytest.raises(err, match=item):
        Sampler(cfg, num_loci=4, device="cpu", **kwargs)


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
