"""The user's run of gphocs_tpu_torch on the CPU, without JAX: the command
line, checkpoints and resume, the state check of --debug-check, and the
coal-stats file, on a small ragged sequence file (the first loci of the
ragged workload of config/samples.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gphocs_tpu_torch import cli
from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import (SAMPLE_AGE_VAR_CTL, SAMPLE_CTL,
                                             with_settings)
from gphocs_tpu_torch.debugcheck import check_gen_state_slow
from gphocs_tpu_torch.io.simulate import simulate_ragged_file
from gphocs_tpu_torch.kernels.common import gen_log_prior
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.sampler.driver import Sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one intra-op thread, here and in the command's process (tests/torch_twins.py
# says why)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    path = tmp_path_factory.mktemp("ragged") / "seqs.txt"
    simulate_ragged_file(str(path), num_loci=10)
    return str(path)


def _ctl(text, seq, trace, iterations, per_log, **extra):
    """A control text on `seq` and `trace` with a short run."""
    return with_settings(text, seq_file=seq, trace_file=trace,
                         mcmc_iterations=iterations,
                         iterations_per_log=per_log, random_seed=7,
                         burn_in=1, start_mig=0, **extra)


def test_cli_run_equals_sampler_run(ragged, tmp_path):
    """`python -m gphocs_tpu_torch ctl --device cpu --buckets 2` exits 0,
    and its trace file equals, byte for byte, that of Sampler.run in this
    process on the same control file."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(_ctl(SAMPLE_CTL, ragged, tmp_path / "cli.log", 4, 2))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
         "cpu", "--buckets", "2", "-n", "4"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "gphocs_tpu_torch on cpu, float64, fast RNG" in out.stdout
    assert "2 pattern buckets" in out.stdout
    cfg = parse_control_text(ctl.read_text())
    s = Sampler(cfg, device="cpu", buckets=2)
    s.run(trace_path=str(tmp_path / "here.log"))
    cli_trace = (tmp_path / "cli.log").read_text()
    assert len(cli_trace.splitlines()) == 5
    assert cli_trace == (tmp_path / "here.log").read_text()


@pytest.mark.parametrize("flags, item", [
    (["--legacy-rng"], "item 17"),
    # chains are ported; with pattern buckets the command line refuses
    # them (a usage error, as gphocs_tpu's)
    (["--chains", "2", "--buckets", "2"], "requires one chain"),
    (["--mesh"], "item 15"),
    (["--distributed", "host:2:0"], "item 15"),
])
def test_unported_flags_raise_before_reading_files(flags, item, tmp_path,
                                                   capsys):
    if "--chains" in flags:
        with pytest.raises(SystemExit):
            cli.main([str(tmp_path / "no-such-file.ctl"), *flags])
        assert item in capsys.readouterr().err
        return
    with pytest.raises(NotImplementedError, match=item):
        cli.main([str(tmp_path / "no-such-file.ctl"), *flags])


def test_cuda_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    ctl = tmp_path / "run.ctl"
    ctl.write_text(SAMPLE_CTL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(ctl)])


@pytest.mark.parametrize("buckets", [1, 3])
def test_resume_equals_uninterrupted_run(buckets, ragged, tmp_path):
    """Save, load and go on: the rows of a run resumed from the checkpoint
    of iteration 2 equal those of the uninterrupted run, bit for bit, and
    so does the state each saves at its end (sample ages, VAR rates,
    mixing and the finetune state included).  The uninterrupted run also
    passes --debug-check at every log point and writes one coal-stats
    row per iteration."""
    def run(name, iterations, resume=False, ck=None, **kw):
        text = _ctl(SAMPLE_AGE_VAR_CTL, ragged, tmp_path / f"{name}.log",
                    iterations, 2, **kw.pop("extra", {}))
        s = Sampler(parse_control_text(text), device="cpu", buckets=buckets)
        s.run(trace_path=str(tmp_path / f"{name}.log"),
              checkpoint_path=str(tmp_path / (ck or f"{name}.npz")),
              checkpoint_every=2, resume=resume, **kw)
        return (tmp_path / f"{name}.log").read_text().splitlines()

    cs = tmp_path / "coal.txt"
    whole = run("whole", 4, debug_check=True,
                extra=dict(coal_stats_file=cs))
    run("first", 2)
    resumed = run("second", 4, resume=True, ck="first.npz")
    assert len(whole) == 5 and len(resumed) == 3
    assert resumed == [whole[0]] + whole[3:]
    a = np.load(tmp_path / "whole.npz")
    b = np.load(tmp_path / "first.npz")
    assert sorted(a.files) == sorted(b.files)
    assert int(b["iteration"]) == 4 and int(b["n_buckets"]) == buckets
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rows = cs.read_text().splitlines()
    assert len(rows) == 1 + 5  # header, burn-in and 4 iterations
    vals = np.array([r.split("\t") for r in rows[1:]], float)
    assert list(vals[:, 0]) == [-1, 0, 1, 2, 3]
    assert np.all(np.isfinite(vals))


def test_debug_check_names_the_bucket(ragged, tmp_path):
    """check_state() finds nothing on a clean bucketed state and names the
    bucket and the violation where a leaf left its sample age; so does the
    per-locus oracle check_gen_state_slow."""
    text = _ctl(SAMPLE_CTL, ragged, tmp_path / "t.log", 2, 2)
    s = Sampler(parse_control_text(text), device="cpu", buckets=3)
    s.initialize()
    assert s.buckets == 3 and s.check_state() == []
    g = s.gens[1]
    age = g.age.clone()
    age[0, 0] = 0.5 * float(age[0, g.father[0, 0]])
    g = g._replace(age=age)
    cond, lnld = full_rebuild_and_lnld(g, s.seqs[1])
    s.gens = (s.gens[0], g, s.gens[2])
    s.conds = (s.conds[0], cond, s.conds[2])
    s.lnlds = (s.lnlds[0], lnld, s.lnlds[2])
    s.lnps = (s.lnps[0], gen_log_prior(g, s.params, s.ctx), s.lnps[2])
    errs = s.check_state()
    assert errs and all(e.startswith("bucket 1: ") for e in errs)
    assert any("leaf age != sample age" in e for e in errs)
    # the per-locus loops of the slow checker find the same leaf
    assert check_gen_state_slow(s.gens[0], s.params, s.tree) == []
    assert any("locus 0: leaf 0 age" in e
               for e in check_gen_state_slow(g, s.params, s.tree))
    # a carried likelihood that disagrees with its genealogies
    s.lnlds = (s.lnlds[0], s.lnlds[1], s.lnlds[2] + 1e-3)
    assert any(e.startswith("bucket 2: carried data lnL drift")
               for e in s.check_state())


def test_cli_runs_chains_with_debug_check(ragged, tmp_path):
    """`python -m gphocs_tpu_torch ctl --chains 2 --device cpu
    --debug-check` exits 0; the trace is chain 0's, one row per iteration,
    and chain 0 equals the one-chain run with the base seed (CONST rates:
    with VAR rates the trace's variance is the chains' mean, as in
    gphocs_tpu)."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(_ctl(SAMPLE_CTL, ragged, tmp_path / "cli.log", 4, 2))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--chains",
         "2", "--device", "cpu", "--debug-check"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "2 chains, seeds 7 + 7919 c" in out.stdout
    s = Sampler(parse_control_text(ctl.read_text()), device="cpu")
    s.run(trace_path=str(tmp_path / "one.log"))
    cli_trace = (tmp_path / "cli.log").read_text()
    assert len(cli_trace.splitlines()) == 5
    assert cli_trace == (tmp_path / "one.log").read_text()
