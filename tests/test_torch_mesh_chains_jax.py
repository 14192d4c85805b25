"""Chains on a loci mesh against gphocs_tpu's chains on a 2-device mesh
(CPU, f64): tests/jax_mesh_chains.py runs gphocs_tpu in a process of its
own, without FMA contraction, and 2 gloo ranks of the port (tests/
mesh_rank.py) resume its checkpoint.  test_torch_mesh_chains.py says why
the mesh's chains are three files.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.mesh_rank import REL, REPO, dense_file, run_ranks

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)

AGE_ATOL = 1e-12  # ages against gphocs_tpu (the sweeps' tests' tolerance)


@pytest.mark.timeout(300)
def test_two_ranks_match_jax_mesh_chains(tmp_path):
    """gphocs_tpu's chains on a 2-device mesh (Sampler(chains=2,
    mesh=make_mesh(jax.devices()[:2]), rng_mode="fast"): its XLA path
    under GSPMD, one jitted chunk, run by tests/jax_mesh_chains.py without
    FMA contraction) and the port's 2 ranks with 2 chains, each keeping
    its block of every chain, from gphocs_tpu's checkpoint of the warmed
    state: 2 iterations on 24 unpadded loci without VAR (where
    gphocs_tpu's chains on a mesh pair VAR rates over a chain's whole L
    and its τ counts padding loci, ROADMAP Queue 3).  Accept counts per
    chain, counters and every integer array equal; trace rows, lnld and
    lnp within 1e-9 relative; ages within 1e-12 absolute, the repo's f64
    tolerance for them."""
    seqs = dense_file(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "tests.jax_mesh_chains", seqs,
                    str(tmp_path)], cwd=REPO, env=env, check=True,
                   timeout=240)
    spec = dict(case="resume", ctl="SAMPLE_CTL", seqs=seqs,
                chains=2, ckpt=str(tmp_path / "jax0.npz"), iters=2, world=2,
                out=str(tmp_path / "out.pt"))
    run_ranks(spec, tmp_path)
    got = torch.load(spec["out"], weights_only=False)
    ref = np.load(tmp_path / "jax_chunk.npz")
    st_t, tr_t = got["stats"], got["trace"]
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mig_rate", "acc_taus", "acc_mixing", "tau_conflicts",
              "num_migs_total"):
        np.testing.assert_array_equal(ref[f"stats_{f}"],
                                      getattr(st_t, f).numpy(), err_msg=f)
    assert int(ref["stats_acc_spr"].min()) > 0
    for f in ("theta", "tau", "mig_rate", "lnld_sum", "lnp_sum"):
        # JAX's trace is [C, K, ...], the port's chunk [K, C, ...]
        np.testing.assert_allclose(getattr(tr_t, f).numpy(),
                                   np.swapaxes(ref[f"trace_{f}"], 0, 1),
                                   rtol=REL, atol=0, err_msg=f)
    # the state after the chunk, against gphocs_tpu's checkpoint of it
    want = np.load(tmp_path / "jax2.npz")
    state = got["state"]
    g = state["gens"][0]
    for name, a in [(f"gen_{f}", getattr(g, f)) for f in g._fields] + [
            ("lnld", state["lnlds"][0]), ("lnp", state["lnps"][0]),
            ("lrng_key", state["keys"][0]), ("lrng_ctr", state["ctrs"][0]),
            ("grng_ctr", state["grng"].ctr)]:
        a = a.numpy()
        w = want[name].reshape(a.shape)
        if name.startswith("gen_") and a.dtype.kind == "f":
            np.testing.assert_allclose(a, w, rtol=0, atol=AGE_ATOL,
                                       err_msg=name)
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(a, w, rtol=REL, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, w.astype(a.dtype), err_msg=name)
