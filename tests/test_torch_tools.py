"""The last modules of the port on the CPU, without JAX: the alignment and
control-file tools, the native sequence reader and the per-family timing
that `-v` prints.

  * tools/alignstats.py and tools/controlgen.py: the cases of
    tests/test_tools.py on the port's copies, and alignstats' command
    line against gphocs_tpu's on one file (gphocs_tpu's tool imports no
    JAX);
  * io/native.py: the C++ reader over cpp/ingest.cpp, built under build/,
    gives the Python reader's patterns and per-locus profiles, and writes
    nothing under cpp/;
  * profiling.py: kernel_times on a CPU sampler, fast and legacy, times
    every family and leaves the state and the launch counts as they were;
    a `-v` command line prints them and writes the trace of a run
    without `-v`.
"""

import contextlib
import io
import math
import os
import subprocess
import sys

import pytest
import torch

from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import (SAMPLE_AGE_VAR_CTL, SAMPLE_CTL,
                                             with_settings)
from gphocs_tpu_torch.io import native
from gphocs_tpu_torch.io.sequences import read_seq_file
from gphocs_tpu_torch.io.simulate import (simulate_ragged_file,
                                          simulate_seq_file)
from gphocs_tpu_torch.model import build_poptree
from gphocs_tpu_torch.ops import sweeps
from gphocs_tpu_torch.profiling import kernel_times
from gphocs_tpu_torch.sampler.driver import Sampler
from gphocs_tpu_torch.tools.alignstats import classify_pattern, two_site_test
from gphocs_tpu_torch.tools.controlgen import (build_config,
                                               config_to_control_text)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"pruning", "full_stats", "node_age", "spr", "theta", "tau",
            "mixing", "mig_age"}

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    path = tmp_path_factory.mktemp("tools") / "seqs.txt"
    cfg = parse_control_text(SAMPLE_CTL)
    simulate_seq_file(cfg, build_poptree(cfg), str(path), num_loci=8,
                      seq_len=200, seed=11)
    return str(path)


def test_pattern_classification():
    # het singleton: one C genome among Ts -> non-informative
    assert classify_pattern("TTTY") == 0
    # homozygote C slot = two C genomes -> informative
    assert classify_pattern("TTTC") == 1
    # two Cs -> informative biallelic
    assert classify_pattern("TTCC") == 1
    # het counts as one of each
    assert classify_pattern("TTYC") == 1
    # tri-allelic beyond a singleton
    assert classify_pattern("TTCCAA") == 2


def test_four_gamete():
    # all four gametes TT, TC, CT, CC across two sites -> violation
    assert two_site_test("TTCC", "TCTC") == 1
    # compatible pair (only 3 gametes)
    assert two_site_test("TTCC", "TTTC") == 0
    # double-het ambiguity -> potential violation at most
    assert two_site_test("TYC", "TYC") in (0, 2)


def test_controlgen_roundtrip():
    cfg = build_config(
        "((A,B)AB,C)root",
        {"A": [("a1", "d")], "B": [("b1", "d")], "C": [("c1", "h")]},
        bands=[("A", "B")],
        seq_file="seqs.txt", mcmc_iterations=5000,
        tau_theta_alpha=1.0, tau_theta_beta=10000.0,
        mig_rate_alpha=0.002, mig_rate_beta=1e-5,
        find_finetunes=True)
    text = config_to_control_text(cfg)
    cfg2 = parse_control_text(text)
    assert [p.name for p in cfg2.pops] == ["A", "B", "C", "AB", "root"]
    assert cfg2.num_samples == 5
    assert len(cfg2.bands) == 1 and cfg2.bands[0].source == "A"
    assert cfg2.mcmc.mcmc_iterations == 5000


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_tools_print_what_gphocs_tpus_print(seqs, tmp_path):
    """alignstats --4gamete on a control file and controlgen on a tree
    print, byte for byte, what gphocs_tpu's tools print."""
    from gphocs_tpu.tools import alignstats as jax_align
    from gphocs_tpu.tools import controlgen as jax_gen

    from gphocs_tpu_torch.tools import alignstats, controlgen

    ctl = tmp_path / "run.ctl"
    ctl.write_text(with_settings(SAMPLE_CTL, seq_file=seqs))
    argv = [str(ctl), "--4gamete"]
    mine = _stdout(alignstats.main, argv)
    assert "loci with potential 4-gamete violations" in mine
    assert mine == _stdout(jax_align.main, argv)
    argv = ["--tree", "((A,B)AB,C)root", "--samples",
            "A:a1 d;B:b1 d b2 h;C:c1 h", "--band", "A->B"]
    mine = _stdout(controlgen.main, argv)
    assert "GENERAL-INFO-START" in mine
    assert mine == _stdout(jax_gen.main, argv)


def _cpp_mtimes():
    cpp = os.path.join(REPO, "cpp")
    return {f: os.stat(os.path.join(cpp, f)).st_mtime_ns
            for f in os.listdir(cpp)}


@pytest.mark.parametrize("data", ["simulated", "ragged"])
def test_native_reader_equals_the_python_reader(data, seqs, tmp_path):
    """The C++ reader (built under build/gphocs_tpu_torch/, never in cpp/)
    gives the Python reader's patterns and per-locus profiles on a
    simulated file and on the first 200 loci of the ragged workload."""
    before = _cpp_mtimes()
    names = parse_control_text(SAMPLE_CTL).sample_names
    if data == "ragged":
        path = str(tmp_path / "ragged.txt")
        simulate_ragged_file(path, num_loci=200)
    else:
        path = seqs
    assert native.native_available()
    assert native.library_path().parent == native.BUILD_DIR
    fast = read_seq_file(path, names, use_native=True)
    slow = read_seq_file(path, names, use_native=False)
    assert fast.num_loci == slow.num_loci == (200 if data == "ragged" else 8)
    assert fast.pattern_set.patterns == slow.pattern_set.patterns
    assert fast.pattern_set.locus_profiles == slow.pattern_set.locus_profiles
    assert _cpp_mtimes() == before


def _state(s):
    return [t.clone() for t in (*s.gen, *s.params, *s.lrng, *s.grng, s.lnld,
                                s.lnp, s.cond) if t is not None]


@pytest.mark.parametrize("rng_mode", ["fast", "legacy"])
def test_kernel_times_leave_the_chain_alone(rng_mode, seqs):
    """profiling.kernel_times on a CPU sampler times every family (finite,
    positive seconds) and leaves the state, the streams and the launch
    counts as they were."""
    cfg = parse_control_text(SAMPLE_AGE_VAR_CTL)
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=seqs, device="cpu", rng_mode=rng_mode)
    s.initialize()
    s._sample_mig_rates_device()
    s.step_chunk(1, do_migrate=True)
    before = _state(s)
    launches = dict(sweeps.LAUNCHES)
    times = kernel_times(s, reps=1)
    assert set(times) == FAMILIES
    assert all(math.isfinite(t) and t > 0 for t in times.values()), times
    assert dict(sweeps.LAUNCHES) == launches
    assert all(torch.equal(a, b) for a, b in zip(before, _state(s)))


def test_verbose_run_prints_method_times_and_keeps_the_trace(seqs,
                                                             tmp_path):
    """`python -m gphocs_tpu_torch ctl --device cpu --chains 2 -v` (legacy
    chains) prints the launches and a time for every family, none
    unavailable, and writes the trace of the same run without -v."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(with_settings(SAMPLE_AGE_VAR_CTL, seq_file=seqs,
                                 trace_file=tmp_path / "cli.log",
                                 mcmc_iterations=3, iterations_per_log=3,
                                 random_seed=7, burn_in=1, start_mig=0))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
         "cpu", "--chains", "2", "-v"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "kernel launches:" in out.stderr
    assert "unavailable" not in out.stderr
    timed = {line.split()[0] for line in out.stderr.splitlines()
             if line.endswith("%") and " ms " in line}
    assert timed == FAMILIES
    s = Sampler(parse_control_text(ctl.read_text()), device="cpu",
                rng_mode="legacy", chains=2)
    s.run(trace_path=str(tmp_path / "here.log"))
    assert ((tmp_path / "cli.log").read_text()
            == (tmp_path / "here.log").read_text())
