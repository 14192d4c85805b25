"""gphocs_tpu's chains on a 2-device CPU mesh, the reference of
tests/test_torch_mesh_chains.py, in a process of its own:

    python -m tests.jax_mesh_chains SEQS OUT_DIR

Sampler(chains=2, mesh=make_mesh(jax.devices()[:2]), rng_mode="fast") on
SAMPLE_CTL at f64, seed 111, initialized with start-mig passed and the
band hot (2e5); writes OUT_DIR/jax0.npz (gphocs_tpu's checkpoint of that
state), then runs 2 iterations (one jitted chunk) and writes
OUT_DIR/jax2.npz and OUT_DIR/jax_chunk.npz (the chunk's stats as
`stats_<field>` and trace as `trace_<field>`).

XLA's CPU compiler always lets LLVM contract a multiply and an add of a
fused computation into one FMA, which torch's separate operations (and
JAX's own eager ones) do not; an SPR coalescence time on a segment of
low hazard magnifies that last bit (2.4e-7 relative in a locus's lnld
after 2 iterations on the test's data).  The process caps XLA's target at
AVX, which has no FMA, so that the compiled chunk evaluates the IEEE-754
operations of the port; the XLA flags are read when JAX starts, hence the
process of its own.
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
    from gphocs_tpu.kernels.common import gen_log_prior
    from gphocs_tpu.parallel.mesh import make_mesh
    from gphocs_tpu.sampler.driver import Sampler
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL

    jax.config.update("jax_enable_x64", True)
    cfg = parse_control_text(SAMPLE_CTL)
    cfg.mcmc.random_seed = SEED
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=seqs, dtype=jnp.float64, rng_mode="fast",
                chains=2, mesh=make_mesh(jax.devices()[:2]))
    s.initialize()
    s.params = s.params._replace(
        mig_rate=jnp.full_like(s.params.mig_rate, 2e5))
    s.lnp = jax.jit(jax.vmap(lambda g, p: gen_log_prior(g, p, s.ctx)))(
        s.gen, s.params)
    save_checkpoint(s, os.path.join(out, "jax0.npz"), 0)
    st, tr = s.step_chunk(ITERS, do_migrate=True)
    save_checkpoint(s, os.path.join(out, f"jax{ITERS}.npz"), ITERS)
    np.savez(os.path.join(out, "jax_chunk.npz"),
             **{f"stats_{k}": np.asarray(v) for k, v in st._asdict().items()},
             **{f"trace_{k}": np.asarray(v) for k, v in tr._asdict().items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
