"""gphocs_tpu's legacy RNG on a 2-device CPU mesh, the reference of
tests/test_torch_legacy_mesh_jax.py, in a process of its own:

    python -m tests.jax_legacy_mesh SEQS OUT_DIR

Sampler(rng_mode="legacy", mesh=make_mesh(jax.devices()[:2])) on
SAMPLE_AGE_VAR_CTL at f64 (24 loci, none padded), seed 111, initialized
with start-mig passed (its migration rates drawn); writes OUT_DIR/jax0.npz
(gphocs_tpu's checkpoint of that state), then runs 2 iterations (one
chunk: its XLA path on the mesh, the serial rate update scanning all 24
loci) with jit disabled and writes OUT_DIR/jax2.npz and
OUT_DIR/jax_chunk.npz (the chunk's stats as `stats_<field>` and trace as
`trace_<field>`).

Jitted, gphocs_tpu's legacy chunk drifts from its own eager run, which
the port equals bit for bit: on this data an age of locus 0 moved 7.7e-8
(4e-3 relative) in two iterations, and lnld's sum 1.2e-9 relative in one
iteration from the jitted run's own state, with every decision and
stream equal.  Eagerly, JAX and the port evaluate the same IEEE-754
operations; the chunk then takes ~130 s, most of it compiling each
primitive once.  The process caps XLA's target at AVX, which has no FMA
(tests/jax_mesh_chains.py says why); the XLA flags are read when JAX
starts, hence the process of its own.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "true"
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_max_isa=AVX")

ITERS = 2
SEED = 111


def main(seqs: str, out: str) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gphocs_tpu.checkpoint import save_checkpoint
    from gphocs_tpu.config import parse_control_text
    from gphocs_tpu.parallel.mesh import make_mesh
    from gphocs_tpu.sampler.driver import Sampler
    from gphocs_tpu_torch.config.samples import SAMPLE_AGE_VAR_CTL

    jax.config.update("jax_enable_x64", True)
    cfg = parse_control_text(SAMPLE_AGE_VAR_CTL)
    cfg.mcmc.random_seed = SEED
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=seqs, dtype=jnp.float64, rng_mode="legacy",
                mesh=make_mesh(jax.devices()[:2]))
    s.initialize()
    s._sample_mig_rates_device()
    save_checkpoint(s, os.path.join(out, "jax0.npz"), 0)
    with jax.disable_jit():
        st, tr = s.step_chunk(ITERS, do_migrate=True)
    save_checkpoint(s, os.path.join(out, f"jax{ITERS}.npz"), ITERS)
    np.savez(os.path.join(out, "jax_chunk.npz"),
             **{f"stats_{k}": np.asarray(v) for k, v in st._asdict().items()},
             **{f"trace_{k}": np.asarray(v) for k, v in tr._asdict().items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
