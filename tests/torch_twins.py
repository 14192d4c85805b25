"""Shared set-up for the gphocs_tpu_torch tests: a warmed JAX sampler
(gphocs_tpu, f64, fast RNG) on SAMPLE_CTL (or another control text of
config/samples.py) with a hot migration band, and its state carried into
the port with state.from_numpy.

The warm-up follows tests/test_sweeps_pallas.py's fixture: 24 loci x
300 bp, start-mig passed, migration rate 2e5 so that migration events
exist and topologies differ between loci.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gphocs_tpu.config import parse_control_text
from gphocs_tpu.kernels.common import gen_log_prior
from gphocs_tpu.sampler.driver import Sampler

from gphocs_tpu_torch import state as TS
from gphocs_tpu_torch.config.samples import SAMPLE_CTL
from gphocs_tpu_torch.kernels.common import make_context
from gphocs_tpu_torch.rng_fast import FastRngState
from gphocs_tpu_torch.sampler.step import Finetunes

# One intra-op thread: the suite runs several test processes side by side,
# and torch's spinning thread pools, sharing the cores, slow each process
# down by an order of magnitude (a warm-up chunk: 4 s alone, over 75 s
# beside a second process).
torch.set_num_threads(1)

F64 = torch.float64


def warm_jax_sampler(tmp_dir, num_loci=24, seq_len=300, ctl=SAMPLE_CTL):
    from gphocs_tpu.io.simulate import simulate_seq_file
    from gphocs_tpu.model import build_poptree

    cfg = parse_control_text(ctl)
    tree = build_poptree(cfg)
    path = str(tmp_dir / "seqs.txt")
    simulate_seq_file(cfg, tree, path, num_loci=num_loci, seq_len=seq_len,
                      seed=11)
    cfg = parse_control_text(ctl)
    cfg.mcmc.random_seed = 17
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=path, dtype=jnp.float64, rng_mode="fast")
    s.initialize()
    s._sample_mig_rates_device()
    s.params = s.params._replace(
        mig_rate=jnp.full_like(s.params.mig_rate, 2e5))
    s.lnp = gen_log_prior(s.gen, s.params, s.ctx)
    for _ in range(8):
        s.step_chunk(5, do_migrate=True)
        if int(jnp.sum(s.gen.mig_branch >= 0)) > 0:
            break
    assert int(jnp.sum(s.gen.mig_branch >= 0)) > 0
    s.seq_path = path
    return s


def carry(s) -> dict:
    """The JAX sampler's state as port objects (CPU, f64).  A sampler of C
    chains (stacked on a leading axis) gives the port's chain layout: the
    per-locus state and streams chain-major, the shared sequence data
    repeated for every chain, the parameters [C, P]."""
    conv = dict(device="cpu", dtype=F64)
    C = getattr(s, "chains", 1)
    per = dict(conv, chains=C > 1)
    seq = TS.from_numpy(s.seq, TS.SeqData, **conv)
    if C > 1:
        seq = TS.SeqData(*(None if x is None else x.repeat(
            C, *[1] * (x.dim() - 1)) for x in seq))
    return dict(
        gen=TS.from_numpy(s.gen, TS.GenState, **per),
        params=TS.from_numpy(s.params._replace(admix_coeff=None), TS.Params,
                             **conv),
        seq=seq,
        lrng=TS.from_numpy(s.lrng, FastRngState, **per),
        grng=TS.from_numpy(s.grng, FastRngState, **per),
        lnld=TS.from_numpy(s.lnld, **per),
        lnp=TS.from_numpy(s.lnp, **per),
        cond=TS.from_numpy(s.cond, **per),
        ft=TS.from_numpy(s.ft, Finetunes, **conv),
        ctx=make_context(s.tree, F64),
    )


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), TS.to_numpy(b), rtol=rtol,
                               atol=atol)


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), TS.to_numpy(b))
