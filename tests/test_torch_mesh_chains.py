"""Chains on a loci mesh (parallel/mesh.py, sampler/driver.py) on the CPU,
without JAX: gloo ranks in subprocesses (tests/mesh_rank.py) holding their
block of every chain's loci, against the port in this process.  Five
iterations at f64, 2 ranks, C = 2 chains, seed 111 (chain c: 111 +
7919 c), held against two references:
  * one process running the same chains padded as the mesh pads them
    (Sampler(chains=2, loci_multiple=2)): equal accept counts, counters,
    decisions and integer arrays, reals within 1e-9 relative (a rank adds
    its loci and the all-reduce adds the ranks' sums, another association
    than the one-process sum);
  * the one-chain meshed run with chain c's seed, bitwise.  It pairs VAR
    locus rates within each rank's block as the C-chain mesh does, while
    one process pairs them over the whole chain, so a VAR run is held
    against this reference and not the one-process one.
Data: SAMPLE_CTL's 24 loci x 300 bp (23 of them for the padding case),
SAMPLE_AGE_CTL, SAMPLE_AGE_VAR_CTL and ADMIX_CTL on the same file.  Every
rank case runs in one launch of the two rank processes (the `ranks`
fixture).  The node-age sweep, the state check, checkpoints and the
command line are in test_torch_mesh_chains_state.py, the comparison with
gphocs_tpu in test_torch_mesh_chains_jax.py: files of at most 6 tests
each, which pytest-xdist's --dist loadfile queues after the longest file
of the suite (it queues files by their number of tests), so that this
work does not delay its start.
"""

import pytest
import torch

from tests.mesh_rank import (chunk_case, dense_file, run_ranks, same_chunk,
                             warm_sampler)

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)

SEED = 111
ITERS = 5
RANKS_TIMEOUT_S = 300   # the one launch of every rank case

# the chunk cases held against one process: (control file, extra spec)
VS_ONE_PROCESS = {
    "24_loci": ("SAMPLE_CTL", {}),
    "23_loci_padded": ("SAMPLE_CTL", {"num_loci": 23}),
    "sample_age": ("SAMPLE_AGE_CTL", {}),
    "admixture": ("ADMIX_CTL", {}),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_chains")
    return {"dense": dense_file(d), "dir": d}


@pytest.fixture(scope="module")
def ranks(data):
    """Every rank case, in one launch of 2 ranks; rank 0's results by
    case name."""
    d = data["dir"]
    base = dict(seqs=data["dense"], seed=SEED, chains=2, iters=ITERS,
                case="chunk")
    cases = {name: dict(base, ctl=ctl, **extra)
             for name, (ctl, extra) in VS_ONE_PROCESS.items()}
    cases["chain1_alone"] = dict(base, ctl="SAMPLE_CTL", chains=1,
                                 seed=SEED + 7919)
    cases["var"] = dict(base, ctl="SAMPLE_AGE_VAR_CTL")
    for c in range(2):
        cases[f"var_chain{c}"] = dict(base, ctl="SAMPLE_AGE_VAR_CTL",
                                      chains=1, seed=SEED + 7919 * c)
    for name, case in cases.items():
        case["out"] = str(d / f"{name}.pt")
    run_ranks(dict(world=2, cases=list(cases.values())), d,
              timeout_s=RANKS_TIMEOUT_S)
    return {n: torch.load(c["out"], weights_only=False)
            for n, c in cases.items()}


def _chain(res, c, C=2):
    """Chain c of a C-chain chunk result as a one-chain result."""
    def rows(t):
        return t.view(C, -1, *t.shape[1:])[c]

    st, tr, s = res["stats"], res["trace"], res["state"]
    gens = [type(g)(*(rows(x) for x in g)) for g in s["gens"]]
    return {
        "stats": type(st)(*(x[c] if x.dim() and x.shape[0] == C else x
                            for x in st)),
        "trace": type(tr)(*(x[:, c] for x in tr)),
        "state": {"gens": gens,
                  **{k: [rows(x) for x in s[k]]
                     for k in ("lnlds", "lnps", "conds", "keys")},
                  "ctrs": [x[c] for x in s["ctrs"]],
                  "grng": s["grng"]._replace(key=s["grng"].key[c:c + 1],
                                             ctr=s["grng"].ctr[c]),
                  "params": type(s["params"])(*(
                      None if x is None else x[c] for x in s["params"]))}}


@pytest.mark.timeout(400)
@pytest.mark.parametrize("name", list(VS_ONE_PROCESS))
def test_two_ranks_equal_one_process(name, data, ranks):
    """Five iterations of 2 chains on 2 ranks against one process running
    the same chains with loci_multiple=2; every move of the iteration
    accepts in each chain, and a padding locus stays inert."""
    ctl, extra = VS_ONE_PROCESS[name]
    spec = dict(ctl=ctl, seqs=data["dense"], seed=SEED, chains=2, **extra)
    ref = chunk_case(warm_sampler(spec, loci_multiple=2), ITERS)
    got = ranks[name]
    same_chunk(ref, got)
    st = ref["stats"]
    assert st.acc_spr.shape == (2,)
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mixing"):
        assert int(getattr(st, f).min()) > 0, f
    if ctl == "ADMIX_CTL":
        assert int(st.acc_admix.min()) > 0
    if "num_loci" in extra:
        g = got["state"]["gens"][0]
        assert g.valid.shape == (48,)
        assert not g.valid[23] and not g.valid[47] and g.valid[:23].all()
        assert float(got["state"]["lnlds"][0][23]) == 0.0
        assert float(got["state"]["lnlds"][0][47]) == 0.0


@pytest.mark.timeout(400)
def test_chain_one_equals_its_one_chain_meshed_run(ranks):
    """Chain 1 of the 2-chain meshed run against the one-chain meshed run
    with seed 111 + 7919, bit for bit: each all-reduce carries a value per
    chain, and chain 1's loci are reduced as the one chain's are."""
    same_chunk(ranks["chain1_alone"], _chain(ranks["24_loci"], 1),
                exact=True)


@pytest.mark.timeout(400)
def test_var_chains_equal_their_one_chain_meshed_runs(ranks):
    """VAR locus rates: each chain of the 2-chain meshed run equals the
    one-chain meshed run with its seed (bitwise), the pairs forming within
    each rank's block of each chain, so each block keeps its sum of
    rates (12) while moves are accepted."""
    got = ranks["var"]
    for c in range(2):
        same_chunk(ranks[f"var_chain{c}"], _chain(got, c), exact=True)
    rates = got["state"]["gens"][0].mut_rate
    assert int(got["stats"].acc_locus_rate.min()) > 0
    assert not torch.all(rates == 1)
    torch.testing.assert_close(rates.view(4, 12).sum(dim=1),
                               torch.full((4,), 12.0, dtype=rates.dtype),
                               rtol=0, atol=1e-12)
