"""Chains on a loci mesh on the CPU, without JAX (the layout, the
padding, and what crosses the ranks besides the iteration): the chain-
aware block, `loci_multiple` padding each chain, one node-age sweep
bitwise, the state check failing on every rank, checkpoints across the
mesh and one process, and the `--distributed --chains 2` command line.
f64, 2 gloo ranks in subprocesses (tests/mesh_rank.py), C = 2 chains,
seed 111; the rank cases run in two launches (the `ranks` fixture).
test_torch_mesh_chains.py says why the mesh's chains are three files.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import SAMPLE_CTL, with_settings
from gphocs_tpu_torch.io.simulate import simulate_seq_file
from gphocs_tpu_torch.model import build_poptree
from gphocs_tpu_torch.parallel.mesh import LociMesh, free_port
from gphocs_tpu_torch.sampler.driver import Sampler

from tests.mesh_rank import (REL, REPO, dense_file, node_age_case,
                             run_ranks, warm_sampler)

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)

SEED = 111
RANKS_TIMEOUT_S = 300   # the first launch of the rank cases


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_chains_state")
    return {"dense": dense_file(d), "dir": d}


def _run_spec(data, name, iterations, resume=False, ck=None, chains=2,
              out=None):
    """A Sampler.run case: SAMPLE_CTL on 23 loci (one padding locus per
    chain on 2 ranks), a trace, a checkpoint every 3 iterations and the
    state check at every log point."""
    d = data["dir"]
    text = with_settings(
        SAMPLE_CTL, seq_file=data["dense"], trace_file=str(d / f"{name}.log"),
        mcmc_iterations=iterations, iterations_per_log=3, random_seed=7,
        burn_in=1, start_mig=0, num_loci=23)
    spec = dict(case="run", chains=chains, ctl_text=text, run=dict(
        trace_path=str(d / f"{name}.log"),
        checkpoint_path=str(d / (ck or f"{name}.npz")), checkpoint_every=3,
        resume=resume, debug_check=True))
    if out:
        spec["out"] = str(d / out)
    return spec


def _one_process_run(spec):
    """A run case of _run_spec in this process, padded as 2 ranks pad."""
    s = Sampler(parse_control_text(spec["ctl_text"]), device="cpu",
                chains=spec["chains"], loci_multiple=2)
    s.run(**spec["run"])
    return s


@pytest.fixture(scope="module")
def ranks(data):
    """The rank cases, rank 0's results by case name.  Before the first
    launch, this process writes the one-process checkpoint that the mesh
    resumes (p3.npz, and two copies of it); "second" resumes a copy of
    the mesh's first.npz (a run overwrites the file it resumed from), in
    a second launch after the copy."""
    d = data["dir"]
    base = dict(seqs=data["dense"], seed=SEED, chains=2, ctl="SAMPLE_CTL")
    cases = {"node_age": dict(base, case="node_age",
                              out=str(d / "node_age.pt")),
             "check": dict(base, case="check", out=str(d / "check.pt"))}
    # checkpoints: the one-process file resumed on the mesh, saved again
    # at once (p3_rt) and run on to 6 (p3_to6); the mesh's own run to 6,
    # to 3, and from 3 to 6
    _one_process_run(_run_spec(data, "p3", 3))
    for copy in ("p3_rt", "p3_to6"):
        shutil.copy(d / "p3.npz", d / f"{copy}.npz")
    cases["p3_rt"] = _run_spec(data, "p3_rt", 3, resume=True)
    cases["p3_to6"] = _run_spec(data, "p3_to6", 6, resume=True)
    cases["whole"] = _run_spec(data, "whole", 6, out="whole_rows.pt")
    cases["first"] = _run_spec(data, "first", 3)
    run_ranks(dict(world=2, cases=list(cases.values())), d,
              timeout_s=RANKS_TIMEOUT_S)
    shutil.copy(d / "first.npz", d / "first.npz.copy")
    run_ranks(dict(world=2, cases=[_run_spec(data, "second", 6, resume=True,
                                             ck="first.npz.copy")]), d)
    return {n: torch.load(c["out"], weights_only=False)
            for n, c in cases.items() if "out" in c}


def test_chain_block_holds_every_chains_block():
    """Rank 1 of 2, 2 chains of 12 loci: rows 6-11 of chain 0 and of
    chain 1 (18-23), in chain order; one chain: block()'s rows."""
    mesh = LociMesh(rank=1, world=2, backend="gloo",
                    device=torch.device("cpu"))
    assert mesh.block(12) == slice(6, 12)
    np.testing.assert_array_equal(mesh.chain_block(12, 1), range(6, 12))
    np.testing.assert_array_equal(mesh.chain_block(12, 2),
                                  list(range(6, 12)) + list(range(18, 24)))


def test_loci_multiple_pads_each_chain(data):
    """25 loci, 3 chains, loci_multiple=2: each chain gets 26 rows, its
    last one inert (valid False, lnld 0), and its initialization covers
    the padded count (chain 1 equals a one-chain sampler of seed base +
    7919 on 26 loci)."""
    cfg = parse_control_text(SAMPLE_CTL)
    path = str(data["dir"] / "seqs25.txt")
    simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=25,
                      seq_len=300, seed=11)
    s = Sampler(cfg, seq_path=path, device="cpu", chains=3, loci_multiple=2)
    s.initialize()
    assert (s.num_loci, s.pad_loci, s.gen.num_loci) == (26, 1, 78)
    valid = s.gen.valid.view(3, 26)
    assert valid[:, :25].all() and not valid[:, 25].any()
    assert torch.equal(s.lnld.view(3, 26)[:, 25],
                       torch.zeros(3, dtype=s.lnld.dtype))
    cfg1 = parse_control_text(SAMPLE_CTL)
    cfg1.mcmc.random_seed = s.seed + 7919
    one = Sampler(cfg1, seq_path=path, device="cpu", loci_multiple=2)
    one.initialize()
    g, _ = s.chain_state(1)
    for f in g._fields:
        assert torch.equal(getattr(g, f), getattr(one.gen, f)), f
    assert torch.equal(s.lrng.key.view(3, 26)[1], one.lrng.key)


@pytest.mark.timeout(400)
def test_node_age_sweep_bitwise(data, ranks):
    """One node-age sweep of 2 chains on 2 ranks equals the one-process
    sweep bit for bit (ages, lnld, lnp, conditionals, counters, accepts
    per chain)."""
    spec = dict(ctl="SAMPLE_CTL", seqs=data["dense"], seed=SEED, chains=2)
    ref = node_age_case(warm_sampler(spec, loci_multiple=2))
    got = ranks["node_age"]
    assert ref["acc"].shape == (2,) and int(ref["acc"].min()) > 0
    assert torch.equal(ref["acc"], got["acc"])
    st_r, st_g = ref["state"], got["state"]
    for f in st_r["gens"][0]._fields:
        assert torch.equal(getattr(st_r["gens"][0], f),
                           getattr(st_g["gens"][0], f)), f
    for k in ("lnlds", "lnps", "conds", "keys", "ctrs"):
        assert torch.equal(st_r[k][0], st_g[k][0]), k


@pytest.mark.timeout(400)
def test_state_check_with_chains_fails_on_every_rank(ranks):
    """--debug-check's state check of 2 chains on 2 ranks: clean on the
    warmed state; after rank 1 moves two carried lnld of its block of
    chain 0 apart, rank 0 fails too (one all-reduce of the count)."""
    got = ranks["check"]
    assert got["clean"] == []
    assert got["moved"] == ["rank 0: 1 violation(s) on other ranks"]


@pytest.mark.timeout(400)
def test_checkpoint_resumes_across_layouts(data, ranks):
    """The file of a 2-rank, 2-chain run has gphocs_tpu's stacked layout,
    [C, Lp, ...], the keys and shapes of the one-process file (chains=2,
    loci_multiple=2), and each resumes in the other bit for bit: loaded
    and saved again at once, the other layout writes the same arrays.  A
    meshed run resumed from its own checkpoint equals the uninterrupted
    one bitwise (rows after iteration 3, final checkpoint); the
    one-process file run on to 6 on the mesh and the mesh's file run on
    to 6 in one process give rows within 1e-9 relative of the meshed
    run's."""
    d = data["dir"]
    m3, p3 = np.load(d / "first.npz"), np.load(d / "p3.npz")
    assert sorted(m3.files) == sorted(p3.files)
    for k in m3.files:
        assert m3[k].shape == p3[k].shape, k
    assert m3["gen_valid"].shape == (2, 24) and not m3["gen_valid"][:, 23].any()
    assert m3["lrng_key"].shape == (2, 24) and m3["grng_key"].shape == (2, 1)
    assert m3["cond"].shape[:2] == (2, 24)
    # the one-process file, loaded on the mesh and saved at once
    rt = np.load(d / "p3_rt.npz")
    for k in p3.files:
        np.testing.assert_array_equal(rt[k], p3[k], err_msg=k)
    # the mesh's file, loaded in one process and saved at once
    shutil.copy(d / "first.npz", d / "m3_rt.npz")
    _one_process_run(_run_spec(data, "m3_rt", 3, resume=True))
    rt = np.load(d / "m3_rt.npz")
    for k in m3.files:
        np.testing.assert_array_equal(rt[k], m3[k], err_msg=k)
    # the mesh resumed from its own file equals its uninterrupted run
    whole = (d / "whole.log").read_text().splitlines()
    assert len(whole) == 1 + 6
    assert (d / "second.log").read_text().splitlines() == \
        [whole[0]] + whole[4:]
    a, b = np.load(d / "whole.npz"), np.load(d / "first.npz.copy")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # across the layouts, rows 4-6 within 1e-9 relative
    shutil.copy(d / "first.npz", d / "m3_to6.npz")
    _one_process_run(_run_spec(data, "m3_to6", 6, resume=True))
    want = np.loadtxt(d / "whole.log", skiprows=1)[3:]
    for name in ("m3_to6", "p3_to6"):
        got = np.loadtxt(d / f"{name}.log", skiprows=1)
        np.testing.assert_allclose(got, want, rtol=REL, atol=0,
                                   err_msg=name)
    # every chain's rows of the meshed run: chain 0's are the trace's
    rows = ranks["whole"]["chain_rows"]
    assert len(rows) == 2 and rows[0].shape == rows[1].shape == (6, 14)
    assert not np.array_equal(rows[0][:, 1:], rows[1][:, 1:])


@pytest.mark.timeout(200)
def test_cli_distributed_chains(data, tmp_path):
    """`--device cpu --fast-rng --distributed 127.0.0.1:PORT:2:r --chains
    2`, two processes: rank 0's trace within 1e-9 relative per column of
    the one-process `--chains 2` command's (24 loci, no padding); rank 1,
    run from a directory of its own, prints no log and writes no file."""
    ctl = tmp_path / "run.ctl"
    ctl.write_text(with_settings(
        SAMPLE_CTL, seq_file=data["dense"], trace_file="t.log",
        mcmc_iterations=4, iterations_per_log=2, random_seed=7, burn_in=1,
        start_mig=0))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def start(where, *flags):
        where.mkdir()
        return subprocess.Popen(
            [sys.executable, "-m", "gphocs_tpu_torch", str(ctl), "--device",
             "cpu", "--fast-rng", "--chains", "2", "--mesh-timeout", "60",
             *flags],
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
    assert "2 chains" in outs[1] and "each holding [24] of [48]" in outs[1]
    assert "gphocs_tpu_torch on" not in outs[2]
    assert os.listdir(tmp_path / "rank1") == []
    rows = [np.loadtxt(tmp_path / d / "t.log", skiprows=1)
            for d in ("one", "rank0")]
    assert rows[0].shape == (4, 14)
    np.testing.assert_allclose(rows[1], rows[0], rtol=REL, atol=0)
