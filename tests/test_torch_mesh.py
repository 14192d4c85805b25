"""Loci sharding (parallel/mesh.py) on the CPU, without JAX: gloo ranks in
subprocesses (tests/mesh_rank.py) against the unsharded port in this
process, padded as the mesh pads (Sampler(loci_multiple=world)).

f64 throughout.  A rank adds its loci and the all-reduce adds the ranks'
sums, which is another association than the unsharded index-order sum:
sums over loci (and what they decide over several iterations) agree to
1e-9 relative, while decisions, accept counts, counters and every integer
array must be equal.  The node-age sweep and a resumed run are bitwise.
Data: SAMPLE_CTL, 24 loci x 300 bp (23 of them for padding); the first
14 loci of the ragged workload in 2 buckets (7 loci each, so every bucket
pads); ADMIX_CTL on the 24 loci.
"""

import numpy as np
import pytest
import torch

from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import (ADMIX_CTL, SAMPLE_CTL,
                                             with_settings)
from gphocs_tpu_torch.io.simulate import simulate_ragged_file, simulate_seq_file
from gphocs_tpu_torch.model import build_poptree
from gphocs_tpu_torch.parallel.mesh import LociMesh, shard_bounds
from gphocs_tpu_torch.sampler.driver import Sampler

from tests.mesh_rank import (chunk_case, node_age_case, run_ranks,
                             same_chunk, same_state, warm_sampler)

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    cfg = parse_control_text(SAMPLE_CTL)
    dense = str(d / "seqs.txt")
    simulate_seq_file(cfg, build_poptree(cfg), dense, num_loci=24,
                      seq_len=300, seed=11)
    ragged = str(d / "ragged.txt")
    simulate_ragged_file(ragged, num_loci=14)
    return {"dense": dense, "ragged": ragged}


def test_shard_bounds_and_padding_rule():
    """Equal contiguous blocks; a state padded to a multiple of the world
    size keeps its loci and appends inert ones."""
    assert shard_bounds(24, 3) == [(0, 8), (8, 16), (16, 24)]
    with pytest.raises(ValueError, match="pad them first"):
        shard_bounds(23, 2)
    mesh = LociMesh(rank=1, world=3, backend="gloo",
                    device=torch.device("cpu"))
    assert mesh.block(24) == slice(8, 16)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("world", [2, 3])
def test_node_age_sweep_bitwise_however_sharded(world, data, tmp_path):
    """One node-age sweep of 24 loci over 2 and 3 ranks equals the
    unsharded sweep bit for bit: ages, lnld, lnp, conditionals, the
    counter and the accept count (the kernel's draw offsets are fixed per
    lane, as tests/test_mesh_fused.py holds for gphocs_tpu)."""
    spec = dict(ctl="SAMPLE_CTL", seqs=data["dense"], seed=17,
                case="node_age", world=world, out=str(tmp_path / "o.pt"))
    ref = node_age_case(warm_sampler(spec))
    run_ranks(spec, tmp_path)
    got = torch.load(spec["out"], weights_only=False)
    assert int(ref["acc"]) > 0 and torch.equal(ref["acc"], got["acc"])
    same_state(ref["state"], got["state"], exact=True)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("case", [
    # (b) 5 iterations of 24 loci over 2 ranks
    dict(ctl="SAMPLE_CTL", seqs="dense", world=2),
    # (c) 23 loci over 2 ranks: one padding locus
    dict(ctl="SAMPLE_CTL", seqs="dense", world=2, num_loci=23),
    # (d) 2 pattern buckets of 7 loci over 2 ranks: a padding locus each
    dict(ctl="SAMPLE_CTL", seqs="ragged", world=2, buckets=2),
    # (e) admixture over 2 ranks
    dict(ctl="ADMIX_CTL", seqs="dense", world=2),
    # the rubber band's sample-age mode over 2 ranks
    dict(ctl="SAMPLE_AGE_CTL", seqs="dense", world=2),
], ids=["24_loci", "23_loci_padded", "2_buckets", "admixture",
        "sample_age"])
def test_five_iterations_sharded_equal_unsharded(case, data, tmp_path):
    """Five iterations sharded against unsharded from the same seed: equal
    accept counts (every move of the iteration, each accepting), RNG
    counters, integer arrays and trace dimensions; trace rows, ages,
    lnld, lnp and conditionals within 1e-9 relative."""
    spec = dict(case, seqs=data[case["seqs"]], seed=17, case="chunk",
                iters=5, out=str(tmp_path / "o.pt"))
    s = warm_sampler(spec, loci_multiple=spec["world"])
    if "num_loci" in spec:
        assert s.pad_loci == 1 and s.num_loci == 24
    if "buckets" in spec:
        assert s.buckets == 2 and s.bucket_pads == [1, 1]
    ref = chunk_case(s, 5)
    run_ranks(spec, tmp_path)
    got = torch.load(spec["out"], weights_only=False)
    same_chunk(ref, got)
    st_r = ref["stats"]
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mixing"):
        assert int(getattr(st_r, f)) > 0, f
    if case["ctl"] == "ADMIX_CTL":
        assert int(st_r.acc_admix) > 0


@pytest.mark.timeout(120)
def test_var_rates_pair_within_each_rank(data, tmp_path):
    """VAR locus rates over 2 ranks: the pairs form within each rank's
    block, as under gphocs_tpu's shard_map, so each block keeps its sum
    of rates (12, the rates starting at 1) while moves are accepted, and
    the global mean stays 1."""
    spec = dict(ctl="SAMPLE_AGE_VAR_CTL", seqs=data["dense"], seed=17,
                case="chunk", iters=5, world=2, out=str(tmp_path / "o.pt"))
    run_ranks(spec, tmp_path)
    got = torch.load(spec["out"], weights_only=False)
    rates = got["state"]["gens"][0].mut_rate
    assert int(got["stats"].acc_locus_rate) > 0 and not torch.all(rates == 1)
    torch.testing.assert_close(rates.view(2, 12).sum(dim=1),
                               torch.full((2,), 12.0, dtype=rates.dtype),
                               rtol=0, atol=1e-12)


@pytest.mark.timeout(150)
def test_resumed_sharded_run_equals_uninterrupted(data, tmp_path):
    """A 2-rank run (Sampler.run: trace, checkpoint every 3 iterations,
    --debug-check's state check, a coal-stats file) to iteration 6, and a
    2-rank run to 3 resumed to 6: the trace rows after iteration 3 and
    the final checkpoints are bitwise equal.  23 loci: the checkpoint
    holds every rank's loci, the padding locus included."""
    def spec(name, iterations, resume=False, ck=None):
        text = with_settings(
            SAMPLE_CTL, seq_file=data["dense"],
            trace_file=str(tmp_path / f"{name}.log"),
            mcmc_iterations=iterations, iterations_per_log=3,
            random_seed=7, burn_in=1, start_mig=0,
            coal_stats_file=str(tmp_path / f"{name}_coal.txt"),
            num_loci=23)
        return dict(case="run", world=2, ctl_text=text, run=dict(
            trace_path=str(tmp_path / f"{name}.log"),
            checkpoint_path=str(tmp_path / (ck or f"{name}.npz")),
            checkpoint_every=3, resume=resume, debug_check=True))

    run_ranks(spec("whole", 6), tmp_path)
    run_ranks(spec("first", 3), tmp_path)
    run_ranks(spec("second", 6, resume=True, ck="first.npz"), tmp_path)
    whole = (tmp_path / "whole.log").read_text().splitlines()
    resumed = (tmp_path / "second.log").read_text().splitlines()
    assert len(whole) == 1 + 6 and resumed == [whole[0]] + whole[4:]
    a = np.load(tmp_path / "whole.npz")
    b = np.load(tmp_path / "first.npz")
    assert sorted(a.files) == sorted(b.files)
    assert a["gen_valid"].shape == (24,) and not a["gen_valid"][23]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rows = (tmp_path / "whole_coal.txt").read_text().splitlines()
    vals = np.array([r.split("\t") for r in rows[1:]], float)
    assert vals.shape[0] == 7 and np.all(np.isfinite(vals))


@pytest.mark.timeout(120)
def test_state_check_fails_on_every_rank(data, tmp_path):
    """--debug-check's state check on 2 ranks: nothing on the warmed
    state; after rank 1 moves two carried lnld of its block by +-1e-3
    (their sum, and so the global sums' check, unchanged), rank 0, whose
    own loci are clean, fails too: the count of violations is
    all-reduced."""
    spec = dict(ctl="SAMPLE_CTL", seqs=data["dense"], seed=17, case="check",
                world=2, out=str(tmp_path / "o.pt"))
    run_ranks(spec, tmp_path)
    got = torch.load(spec["out"], weights_only=False)
    assert got["clean"] == []
    assert got["moved"] == ["rank 0: 1 violation(s) on other ranks"]


@pytest.mark.parametrize("chains", [1, 2])
def test_legacy_chains_on_a_mesh_hold_their_block(chains, data):
    """The legacy RNG on a mesh, one chain and 2 (it was refused before):
    rank 0 of 2 on the 24 loci holds rows [0, 12) of every chain of the
    one-process state, locus 0 of each chain at rows c * 12, and its
    Wichmann-Hill streams there; the reference locus's data row is the
    file's first locus."""
    cfg = parse_control_text(SAMPLE_CTL)
    cfg.mcmc.random_seed = 5
    mesh = LociMesh(rank=0, world=2, backend="gloo",
                    device=torch.device("cpu"))
    s = Sampler(cfg, seq_path=data["dense"], device="cpu", mesh=mesh,
                chains=chains, rng_mode="legacy")
    one = Sampler(cfg, seq_path=data["dense"], device="cpu", chains=chains,
                  rng_mode="legacy")
    s.initialize()
    one.initialize()
    rows = mesh.chain_block(24, chains)
    assert s.gen.num_loci == 12 * chains
    for f in s.gen._fields:
        assert torch.equal(getattr(s.gen, f), getattr(one.gen, f)[rows]), f
    for a, b in zip(s.lrng, one.lrng):
        assert torch.equal(a, b[rows])
    first = torch.arange(chains) * 12
    assert torch.equal(s.lrng.x[first], one.lrng.x[first * 2])
    for a, b in zip(s.ref_seq, one.seq):
        assert a is None or torch.equal(a, b[:1])
