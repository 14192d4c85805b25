"""The legacy RNG (the Wichmann-Hill streams of the conformance mode) on a
loci mesh, on the CPU, without JAX: gloo ranks in subprocesses
(tests/mesh_rank.py) against one process running the same loci padded
as the mesh pads them (Sampler(rng_mode="legacy", loci_multiple=W)), bit
for bit at f64: stats, trace rows, the gathered genealogies, lnld, lnp,
conditionals, the per-locus and general streams and the parameters.

The serial rate update hands its carry from rank to rank (W broadcasts
per update), the plain sweeps run on each rank's block with no
collective (a Wichmann-Hill lane draws only where its own locus asks, so
SPR's trips, synchronized within the block, give the one-process draws),
and the iteration's lnld and lnp sums add the gathered loci in one
process's order.  Data: SAMPLE_CTL's 24 loci x 300 bp (23 of them for the
padding cases), seed 111 (chain c: 111 + 7919 c).  The 2-rank cases run
in one launch of the two rank processes (the `ranks` fixture); the file
keeps to 6 tests (test_torch_mesh_chains.py says why).  The comparison
with gphocs_tpu is in test_torch_legacy_mesh_jax.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import SAMPLE_AGE_VAR_CTL, with_settings
from gphocs_tpu_torch.parallel.mesh import free_port
from gphocs_tpu_torch.sampler.driver import Sampler

from tests.mesh_rank import (REL, REPO, chunk_case, dense_file,
                             locus_rate_case, run_ranks, same_chunk,
                             warm_sampler)

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)

SEED = 111
ITERS = 3
RANKS_TIMEOUT_S = 300   # the one launch of the 2-rank cases

# the chunk cases held against one process: (control file, extra spec)
CHUNKS = {
    "var_24": ("SAMPLE_AGE_VAR_CTL", {}),
    "var_23": ("SAMPLE_AGE_VAR_CTL", {"num_loci": 23}),
    "var_24_chains": ("SAMPLE_AGE_VAR_CTL", {"chains": 2}),
    "var_23_chains": ("SAMPLE_AGE_VAR_CTL", {"num_loci": 23, "chains": 2}),
    "admix": ("ADMIX_CTL", {}),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("legacy_mesh")
    return {"dense": dense_file(d), "dir": d}


def _spec(data, name):
    ctl, extra = CHUNKS[name]
    return dict(ctl=ctl, seqs=data["dense"], seed=SEED, rng_mode="legacy",
                **extra)


def _run_spec(data, name, iterations, resume=False, ck=None):
    """A Sampler.run case: SAMPLE_AGE_VAR_CTL on 23 loci (one padding
    locus on 2 ranks), a trace, a coal-stats file, a checkpoint every
    iteration and the state check at every log point."""
    d = data["dir"]
    text = with_settings(
        SAMPLE_AGE_VAR_CTL, seq_file=data["dense"],
        trace_file=str(d / f"{name}.log"), mcmc_iterations=iterations,
        iterations_per_log=1, random_seed=7, burn_in=0, start_mig=0,
        num_loci=23, coal_stats_file=str(d / f"{name}_coal.txt"))
    return dict(case="run", rng_mode="legacy", ctl_text=text, run=dict(
        trace_path=str(d / f"{name}.log"),
        checkpoint_path=str(d / (ck or f"{name}.npz")), checkpoint_every=1,
        resume=resume, debug_check=True))


@pytest.fixture(scope="module")
def ranks(data):
    """Every 2-rank case in one launch; rank 0's results by case name.
    "second" resumes the file of "first" (and overwrites it at its end)."""
    d = data["dir"]
    cases = {name: dict(_spec(data, name), case="chunk", iters=ITERS)
             for name in CHUNKS}
    cases["whole"] = _run_spec(data, "whole", 3)
    cases["first"] = _run_spec(data, "first", 1)
    cases["second"] = _run_spec(data, "second", 3, resume=True,
                                ck="first.npz")
    for name in CHUNKS:
        cases[name]["out"] = str(d / f"{name}.pt")
    run_ranks(dict(world=2, cases=list(cases.values())), d,
              timeout_s=RANKS_TIMEOUT_S)
    return {n: torch.load(c["out"], weights_only=False)
            for n, c in cases.items() if "out" in c}


def _equal_one_process(data, ranks, name):
    """The chunk case `name` on 2 ranks against one process with
    loci_multiple=2, bit for bit; returns the one-process result."""
    ref = chunk_case(warm_sampler(_spec(data, name), loci_multiple=2),
                     ITERS)
    same_chunk(ref, ranks[name], exact=True)
    return ref


def _check_var_case(ref, got, chains, loci):
    """Every move accepts in every chain (locus rates included), the
    padding locus of each chain stays inert, the rates keep their mean."""
    st = ref["stats"]
    for f in ("acc_coal_time", "acc_spr", "acc_theta", "acc_locus_rate"):
        assert int(getattr(st, f).min()) > 0, f
    g = got["state"]["gens"][0]
    Lp = 24
    assert g.valid.shape == (chains * Lp,)
    rates = g.mut_rate.view(chains, Lp)
    assert not torch.all(rates == 1)
    torch.testing.assert_close(rates.sum(dim=1), torch.full(
        (chains,), float(Lp), dtype=rates.dtype), rtol=0, atol=1e-12)
    if loci == 23:
        last = [c * Lp + 23 for c in range(chains)]
        assert not g.valid[last].any()
        assert torch.equal(got["state"]["lnlds"][0][last],
                           torch.zeros(chains, dtype=torch.float64))


@pytest.mark.timeout(400)
def test_one_chain_equals_one_process(data, ranks):
    """SAMPLE_AGE_VAR_CTL (D's sample age, VAR rates), one chain, 24 loci
    and 23 (a padding locus): three iterations on 2 ranks equal the
    one-process run with loci_multiple=2 bit for bit."""
    for name, loci in (("var_24", 24), ("var_23", 23)):
        ref = _equal_one_process(data, ranks, name)
        _check_var_case(ref, ranks[name], 1, loci)


@pytest.mark.timeout(400)
def test_two_chains_equal_one_process(data, ranks):
    """The same with 2 chains: each rank holds its block of both chains'
    loci and streams, every step of the rate update moves a locus of each
    chain against that chain's locus 0; counts and variance deltas per
    chain."""
    for name, loci in (("var_24_chains", 24), ("var_23_chains", 23)):
        ref = _equal_one_process(data, ranks, name)
        assert ref["stats"].acc_locus_rate.shape == (2,)
        _check_var_case(ref, ranks[name], 2, loci)


@pytest.mark.timeout(400)
def test_admixed_equals_one_process(data, ranks):
    """ADMIX_CTL (two admixed leaves; SPR draws a uniform for each
    before its walk), one chain: bit for bit, coefficients moved."""
    ref = _equal_one_process(data, ranks, "admix")
    assert int(ref["stats"].acc_admix) > 0
    assert int(ref["stats"].acc_spr) > 0


@pytest.mark.timeout(300)
def test_rate_update_on_three_ranks(data, tmp_path):
    """update_locus_rates alone on 3 ranks (8 loci each), where locus 0's
    rate moves: the rates, lnld and streams equal the one-process update
    bitwise, the accept count and the variance delta are the global ones
    on rank 0, and the update made exactly 3 broadcasts and no
    all-reduce."""
    spec = dict(_spec(data, "var_24"), case="locus_rate", finetune=0.3,
                world=3, out=str(tmp_path / "rate.pt"))
    run_ranks(spec, tmp_path)
    got = torch.load(spec["out"], weights_only=False)
    s = warm_sampler(spec, loci_multiple=3)
    before = s.gen.mut_rate.clone()
    ref = locus_rate_case(s, 0.3)
    assert got["collectives"] == {"all_reduce": 0, "broadcast": 3}
    assert ref["collectives"] == {"all_reduce": 0, "broadcast": 0}
    assert torch.equal(ref["acc"], got["acc"]) and int(ref["acc"]) > 0
    assert torch.equal(ref["dvar"], got["dvar"])
    r_st, g_st = ref["state"], got["state"]
    rates = r_st["gens"][0].mut_rate
    assert rates[0] != before[0]
    assert torch.equal(rates, g_st["gens"][0].mut_rate)
    assert torch.equal(r_st["lnlds"][0], g_st["lnlds"][0])
    for f in "xyz":
        assert torch.equal(getattr(r_st["wh"][0], f),
                           getattr(g_st["wh"][0], f)), f
    torch.testing.assert_close(rates.sum(), torch.tensor(
        24.0, dtype=rates.dtype), rtol=0, atol=1e-12)


@pytest.mark.timeout(400)
def test_checkpoint_resumes_bitwise(data, ranks):
    """A meshed legacy run checkpointed at iteration 1 and resumed to 3
    equals the uninterrupted meshed run bit for bit (trace rows, final
    checkpoint); the meshed file equals the one-process file of the same
    run (loci_multiple=2) array for array: lrng_x/y/z [Lp], grng_x/y/z
    [1], uint32.  Rank 0's coal-stats rows, summed over the ranks, are
    the one-process rows within 1e-9 relative."""
    d = data["dir"]
    whole = (d / "whole.log").read_text().splitlines()
    assert len(whole) == 1 + 3
    assert (d / "second.log").read_text().splitlines() == \
        [whole[0]] + whole[2:]
    a, b = np.load(d / "whole.npz"), np.load(d / "first.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["lrng_x"].shape == (24,) and a["lrng_x"].dtype == np.uint32
    assert a["grng_z"].shape == (1,) and "lrng_key" not in a.files
    spec = _run_spec(data, "one", 3)
    s = Sampler(parse_control_text(spec["ctl_text"]), device="cpu",
                rng_mode="legacy", loci_multiple=2)
    s.run(**spec["run"])
    c = np.load(d / "one.npz")
    assert sorted(c.files) == sorted(a.files)
    for k in a.files:
        np.testing.assert_array_equal(c[k], a[k], err_msg=k)
    assert (d / "one.log").read_text().splitlines()[1:] == whole[1:]
    coal = [np.loadtxt(d / f"{n}_coal.txt", skiprows=1)
            for n in ("one", "whole")]
    assert coal[0].shape[0] == 3 and np.all(np.isfinite(coal[0]))
    np.testing.assert_allclose(coal[1], coal[0], rtol=REL, atol=0)


@pytest.mark.timeout(200)
def test_cli_distributed_legacy_chains(data, tmp_path):
    """`--device cpu --distributed 127.0.0.1:PORT:2:r --chains 2` (the
    CPU's default, the legacy RNG), two processes: rank 0's trace equals
    the one-process `--chains 2` command's (24 loci, no padding); rank 1,
    run from a directory of its own, prints no log and writes no file."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(with_settings(
        SAMPLE_AGE_VAR_CTL, seq_file=data["dense"], trace_file="t.log",
        mcmc_iterations=3, iterations_per_log=1, random_seed=7, burn_in=0,
        start_mig=0))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def start(where, *flags):
        where.mkdir()
        return subprocess.Popen(
            [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
             "cpu", "--chains", "2", "--mesh-timeout", "60", *flags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=where)

    coord = f"127.0.0.1:{free_port()}"
    procs = [start(tmp_path / "one"),
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
    assert "legacy RNG" in outs[1] and "2 chains" in outs[1]
    assert "each holding [24] of [48]" in outs[1]
    assert "gphocs_tpu_torch on" not in outs[2]
    assert os.listdir(tmp_path / "rank1") == []
    one, rank0 = ((tmp_path / d / "t.log").read_text().splitlines()
                  for d in ("one", "rank0"))
    assert len(one) == 1 + 3 and rank0 == one
