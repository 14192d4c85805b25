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
    """`python -m gphocs_tpu_torch ctl --device cpu --fast-rng --buckets 2`
    exits 0, and its trace file equals, byte for byte, that of Sampler.run
    in this process on the same control file."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(_ctl(SAMPLE_CTL, ragged, tmp_path / "cli.log", 4, 2))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
         "cpu", "--fast-rng", "--buckets", "2", "-n", "4"],
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


@pytest.mark.parametrize("flags", [["--legacy-rng"], []])
def test_cli_legacy_run_equals_sampler_run(flags, ragged, tmp_path):
    """`python -m gphocs_tpu_torch ctl --device cpu` runs the conformance
    mode, with or without --legacy-rng (the CPU's default, as in
    gphocs_tpu), names it in its start line, and writes the trace of
    Sampler(rng_mode="legacy").run in this process, byte for byte."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(_ctl(SAMPLE_AGE_VAR_CTL, ragged, tmp_path / "cli.log", 4,
                        2))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
         "cpu", "-v", *flags],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("gphocs_tpu_torch on cpu, float64, legacy RNG: node-age/"
            "migration-age/SPR sweeps as tensor code") in out.stdout
    assert "'spr': 0" in out.stderr and "'spr_plain': 5" in out.stderr
    s = Sampler(parse_control_text(ctl.read_text()), device="cpu",
                rng_mode="legacy")
    s.run(trace_path=str(tmp_path / "here.log"))
    cli_trace = (tmp_path / "cli.log").read_text()
    assert len(cli_trace.splitlines()) == 5
    assert cli_trace == (tmp_path / "here.log").read_text()


@pytest.mark.parametrize("flags", [["--legacy-rng"], []])
def test_cli_legacy_chains_run_equals_sampler_run(flags, ragged, tmp_path):
    """`python -m gphocs_tpu_torch ctl --device cpu --chains 2`, with or
    without --legacy-rng, runs two legacy chains: it exits 0, names the
    mode and the chains in its start line, and its trace (chain 0's)
    equals that of Sampler(rng_mode="legacy", chains=2).run in this
    process, byte for byte."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(_ctl(SAMPLE_CTL, ragged, tmp_path / "cli.log", 3, 3))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
         "cpu", "--chains", "2", *flags],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("gphocs_tpu_torch on cpu, float64, legacy RNG: node-age/"
            "migration-age/SPR sweeps as tensor code, 2 chains"
            in out.stdout)
    s = Sampler(parse_control_text(ctl.read_text()), device="cpu",
                rng_mode="legacy", chains=2)
    s.run(trace_path=str(tmp_path / "here.log"))
    cli_trace = (tmp_path / "cli.log").read_text()
    assert len(cli_trace.splitlines()) == 4
    assert cli_trace == (tmp_path / "here.log").read_text()


def test_legacy_resume_equals_uninterrupted_run(ragged, tmp_path):
    """A legacy run resumed from its checkpoint of iteration 2 (the
    Wichmann-Hill states as lrng_x/y/z and grng_x/y/z, uint32) gives the
    uninterrupted run's rows and final checkpoint, bit for bit; the fast
    RNG's sampler refuses that checkpoint."""
    def run(name, iterations, resume=False, ck=None):
        text = _ctl(SAMPLE_AGE_VAR_CTL, ragged, tmp_path / f"{name}.log",
                    iterations, 2)
        s = Sampler(parse_control_text(text), device="cpu",
                    rng_mode="legacy")
        s.run(trace_path=str(tmp_path / f"{name}.log"),
              checkpoint_path=str(tmp_path / (ck or f"{name}.npz")),
              checkpoint_every=2, resume=resume, debug_check=True)
        return (tmp_path / f"{name}.log").read_text().splitlines()

    whole = run("whole", 4)
    run("first", 2)
    resumed = run("second", 4, resume=True, ck="first.npz")
    assert resumed == [whole[0]] + whole[3:]
    a = np.load(tmp_path / "whole.npz")
    b = np.load(tmp_path / "first.npz")
    assert sorted(a.files) == sorted(b.files)
    assert a["lrng_x"].dtype == np.uint32 and a["grng_z"].shape == (1,)
    assert "lrng_key" not in a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fast = Sampler(parse_control_text(_ctl(SAMPLE_AGE_VAR_CTL, ragged,
                                           tmp_path / "f.log", 4, 2)),
                   device="cpu")
    with pytest.raises(ValueError, match="legacy RNG"):
        fast.run(checkpoint_path=str(tmp_path / "whole.npz"), resume=True)


@pytest.mark.parametrize("flags, item", [
    # the legacy RNG with --buckets, or with --fast-rng, is a usage error
    # (as gphocs_tpu's)
    (["--legacy-rng", "--buckets", "2"], "requires the fast RNG"),
    (["--device", "cpu", "--buckets", "2"], "requires the fast RNG"),
    (["--legacy-rng", "--fast-rng"], "mutually exclusive"),
    # chains are ported; with pattern buckets the command line refuses
    # them (a usage error, as gphocs_tpu's)
    (["--chains", "2", "--buckets", "2"], "requires one chain"),
    # a malformed --distributed is a usage error
    (["--distributed", "host:2:0"], "COORD = host:port"),
])
def test_unported_flags_raise_before_reading_files(flags, item, tmp_path,
                                                   capsys):
    with pytest.raises(SystemExit):
        cli.main([str(tmp_path / "no-such-file.ctl"), *flags])
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    # the legacy RNG on a mesh (a world of one on the CPU), one chain and
    # chains; the CPU's default RNG is the legacy one
    ["--legacy-rng", "--mesh", "--device", "cpu"],
    ["--mesh", "--device", "cpu", "--chains", "2"],
])
def test_legacy_mesh_reaches_the_file_read(flags, tmp_path):
    """`--legacy-rng --mesh` is no usage error any more: the command
    joins its mesh and fails only at the missing control file."""
    with pytest.raises(FileNotFoundError):
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
    """`python -m gphocs_tpu_torch ctl --chains 2 --device cpu --fast-rng
    --debug-check` exits 0; the trace is chain 0's, one row per iteration,
    and chain 0 equals the one-chain run with the base seed (CONST rates:
    with VAR rates the trace's variance is the chains' mean, as in
    gphocs_tpu)."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(_ctl(SAMPLE_CTL, ragged, tmp_path / "cli.log", 4, 2))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--chains",
         "2", "--device", "cpu", "--fast-rng", "--debug-check"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "2 chains, seeds 7 + 7919 c" in out.stdout
    s = Sampler(parse_control_text(ctl.read_text()), device="cpu")
    s.run(trace_path=str(tmp_path / "one.log"))
    cli_trace = (tmp_path / "cli.log").read_text()
    assert len(cli_trace.splitlines()) == 5
    assert cli_trace == (tmp_path / "one.log").read_text()


def test_cli_runs_an_admixed_control_file(ragged, tmp_path, capsys):
    """`python -m gphocs_tpu_torch admix.ctl --device cpu --fast-rng
    --debug-check` exits 0 and writes the A... trace columns and
    admixture-trace.out (the iteration, then per admixed leaf and locus
    its share of the sampling iterations in its second population); the
    trace equals that
    of Sampler.run in this process.  With --buckets 2 the command line
    refuses admixture (a usage error), as gphocs_tpu's does."""
    from gphocs_tpu_torch.config.samples import ADMIX_CTL

    ctl = tmp_path / "admix.ctl"
    ctl.write_text(_ctl(ADMIX_CTL, ragged, tmp_path / "cli.log", 4, 2))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
         "cpu", "--fast-rng", "--debug-check"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "AdmxCoefs" in out.stderr
    head = (tmp_path / "cli.log").read_text().splitlines()[0].split("\t")
    assert "A0[B]" in head and "A1[B]" in head
    vals = (tmp_path / "admixture-trace.out").read_text().split()
    assert int(vals[0]) == 3 and len(vals) == 1 + 2 * 10
    assert all(0.0 <= float(v) <= 1.0 for v in vals[1:])
    s = Sampler(parse_control_text(ctl.read_text()), device="cpu")
    (tmp_path / "here").mkdir()
    s.run(trace_path=str(tmp_path / "here" / "t.log"))
    assert (tmp_path / "cli.log").read_text() == (
        tmp_path / "here" / "t.log").read_text()
    assert (tmp_path / "admixture-trace.out").read_text() == (
        tmp_path / "here" / "admixture-trace.out").read_text()
    with pytest.raises(SystemExit):
        cli.main([str(ctl), "--device", "cpu", "--fast-rng", "--buckets",
                  "2"])
    assert "admixture requires one pattern bucket" in capsys.readouterr().err


def test_admixed_resume_equals_uninterrupted_run(ragged, tmp_path):
    """An admixed run resumed from its checkpoint at iteration 2 gives the
    uninterrupted run's rows (the A... columns included) and final
    checkpoint (params_admix_coeff included), bit for bit."""
    from gphocs_tpu_torch.config.samples import ADMIX_CTL

    def run(name, iterations, resume=False, ck=None):
        text = _ctl(ADMIX_CTL, ragged, tmp_path / f"{name}.log", iterations,
                    2)
        s = Sampler(parse_control_text(text), device="cpu")
        s.run(trace_path=str(tmp_path / f"{name}.log"),
              checkpoint_path=str(tmp_path / (ck or f"{name}.npz")),
              checkpoint_every=2, resume=resume)
        return (tmp_path / f"{name}.log").read_text().splitlines()

    whole = run("whole", 4)
    run("first", 2)
    resumed = run("second", 4, resume=True, ck="first.npz")
    assert resumed == [whole[0]] + whole[3:]
    a = np.load(tmp_path / "whole.npz")
    b = np.load(tmp_path / "first.npz")
    assert a["params_admix_coeff"].shape == (2,)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.timeout(200)
def test_cli_on_a_loci_mesh(ragged, tmp_path):
    """`--mesh --device cpu` (a world of one) writes the one-process
    command's trace byte for byte; `--distributed 127.0.0.1:PORT:2:r`, two
    processes, gives rank 0's trace within 1e-9 relative per column of
    the one-process one (10 loci in 2 buckets, of 4 and 6 loci),
    and rank 1, run from a directory of its own, prints no log and writes
    no file."""
    from gphocs_tpu_torch.parallel.mesh import free_port

    ctl = tmp_path / "run.ctl"
    ctl.write_text(_ctl(SAMPLE_CTL, ragged, "t.log", 4, 2))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def start(where, *flags):
        where.mkdir()
        return subprocess.Popen(
            [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
             "cpu", "--fast-rng", "--buckets", "2", "--mesh-timeout", "60",
             *flags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=where)

    coord = f"127.0.0.1:{free_port()}"
    procs = [start(tmp_path / "one"), start(tmp_path / "mesh1", "--mesh"),
             *(start(tmp_path / f"rank{r}", "--distributed",
                     f"{coord}:2:{r}") for r in range(2))]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "loci mesh: 1 rank(s), backend gloo" in outs[1]
    assert "loci mesh: 2 rank(s), backend gloo (ranks on the CPU)" in outs[2]
    assert "gphocs_tpu_torch on" not in outs[3]
    assert os.listdir(tmp_path / "rank1") == []
    one = (tmp_path / "one" / "t.log").read_text()
    assert (tmp_path / "mesh1" / "t.log").read_text() == one
    rows = [np.loadtxt(tmp_path / d / "t.log", skiprows=1)
            for d in ("one", "rank0")]
    assert rows[0].shape == (4, 14)
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-9, atol=0)
