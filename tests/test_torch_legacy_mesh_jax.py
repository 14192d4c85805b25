"""The legacy RNG on a loci mesh against gphocs_tpu's legacy sampler on a
2-device mesh (CPU, f64): tests/jax_legacy_mesh.py runs gphocs_tpu in a
process of its own, without FMA contraction, and 2 gloo ranks of the
port (tests/mesh_rank.py) resume its checkpoint.
test_torch_legacy_mesh.py holds the mesh against one process bit for
bit.
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
ITERS = 2         # iterations of the chunk


@pytest.mark.timeout(600)
def test_two_ranks_match_jax_legacy_mesh(tmp_path):
    """gphocs_tpu's Sampler(rng_mode="legacy", mesh=make_mesh(
    jax.devices()[:2])) (its XLA path on the mesh, the serial rate update
    scanning every locus; one chunk of 2 iterations with jit disabled,
    run by tests/jax_legacy_mesh.py, which says why) and the port's 2
    ranks, each holding its block of the genealogies and streams, from
    gphocs_tpu's checkpoint: SAMPLE_AGE_VAR_CTL on 24 unpadded loci
    (gphocs_tpu's XLA τ counts padding loci, ROADMAP Queue 3).  Every
    accept count (acc_locus_rate included, a global count on every rank),
    the Wichmann-Hill streams and every integer array equal; trace rows,
    lnld and lnp within 1e-9 relative; ages within 1e-12 absolute."""
    seqs = dense_file(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "tests.jax_legacy_mesh", seqs,
                    str(tmp_path)], cwd=REPO, env=env, check=True,
                   timeout=480)
    spec = dict(case="resume", ctl="SAMPLE_AGE_VAR_CTL", seqs=seqs,
                rng_mode="legacy", ckpt=str(tmp_path / "jax0.npz"),
                iters=ITERS, world=2, out=str(tmp_path / "out.pt"))
    run_ranks(spec, tmp_path)
    _match(np.load(tmp_path / "jax_chunk.npz"),
           np.load(tmp_path / f"jax{ITERS}.npz"),
           torch.load(spec["out"], weights_only=False))


def _match(ref, want, got):
    """The port's ranks' chunk (got) against gphocs_tpu's chunk (ref) and
    its checkpoint after it (want)."""
    st_t, tr_t = got["stats"], got["trace"]
    for f in ("acc_coal_time", "acc_mig_time", "acc_spr", "acc_theta",
              "acc_mig_rate", "acc_taus", "acc_mixing", "acc_locus_rate",
              "tau_conflicts", "num_migs_total"):
        np.testing.assert_array_equal(ref[f"stats_{f}"],
                                      getattr(st_t, f).numpy(), err_msg=f)
    for f in ("acc_spr", "acc_locus_rate", "acc_coal_time"):
        assert int(ref[f"stats_{f}"]) > 0, f
    np.testing.assert_allclose(st_t.rate_var_delta.numpy(),
                               ref["stats_rate_var_delta"], rtol=REL,
                               atol=0)
    for f in ("theta", "tau", "sample_age", "mig_rate", "lnld_sum",
              "lnp_sum"):
        np.testing.assert_allclose(getattr(tr_t, f).numpy(),
                                   ref[f"trace_{f}"], rtol=REL, atol=0,
                                   err_msg=f)
    state = got["state"]
    g = state["gens"][0]
    pairs = [(f"gen_{f}", getattr(g, f)) for f in g._fields] + [
        ("lnld", state["lnlds"][0]), ("lnp", state["lnps"][0])]
    pairs += [(f"lrng_{f}", getattr(state["wh"][0], f)) for f in "xyz"]
    pairs += [(f"grng_{f}", getattr(state["grng"], f)) for f in "xyz"]
    for name, a in pairs:
        a = a.numpy()
        w = want[name].reshape(a.shape)
        if name.startswith("gen_") and a.dtype.kind == "f":
            np.testing.assert_allclose(a, w, rtol=0, atol=AGE_ATOL,
                                       err_msg=name)
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(a, w, rtol=REL, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, w.astype(a.dtype), err_msg=name)
