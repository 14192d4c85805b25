"""Ranks of a loci mesh on the CPU for the tests (no JAX).

    python -m tests.mesh_rank SPEC.json RANK

runs rank RANK of SPEC["world"] gloo ranks (rank 0 at 127.0.0.1:
SPEC["port"]) on one case of SPEC, and rank 0 writes the result, gathered
from every rank, to SPEC["out"] with torch.save; or, where SPEC has
"cases", on each of them in turn (each a case's spec with its own "out"),
in one process group.  `run_ranks` starts all ranks of a SPEC and waits
for them.  The same functions give the unsharded reference in the test's
own process, with the loci padded as the mesh pads them
(Sampler(loci_multiple=world)).  SPEC["chains"] (default 1) runs that
many chains side by side, SPEC["rng_mode"] (default "fast") picks the
streams.

Cases (SPEC["case"]):
  node_age  one node-age sweep of the warmed state;
  check     the state check of --debug-check on the warmed state, then
            again after rank 1 moved two carried lnld of its block apart;
  chunk     `iters` iterations (step_chunk) of the warmed state;
  carried   the same from a state saved with torch.save (SPEC["state"]:
            the unsharded per-locus tensors, of which each rank takes its
            block, and the replicated ones);
  resume    `iters` iterations from the checkpoint SPEC["ckpt"]
            (checkpoint.load_checkpoint: each rank keeps its block);
  run       Sampler.run on the control text SPEC["ctl_text"] with a
            trace and a checkpoint (SPEC["run"]: run()'s arguments), each
            rank writing nothing but what rank 0 writes; with SPEC["out"],
            rank 0 saves every chain's rows (`chain_rows`);
  locus_rate  the legacy RNG's serial rate update alone on the warmed
            state (SPEC["finetune"]), with the collectives it made.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config import samples
from gphocs_tpu_torch.kernels.common import gen_log_prior
from gphocs_tpu_torch.parallel import mesh as M
from gphocs_tpu_torch.parallel.mesh import gather_rows
from gphocs_tpu_torch.rng import WhRngState
from gphocs_tpu_torch.sampler.driver import Sampler
from gphocs_tpu_torch.state import GenState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60  # of the process group and of every rank's process
REL = 1e-9      # reals of a sharded run against the unsharded one

torch.set_num_threads(1)


def dense_file(d) -> str:
    """SAMPLE_CTL's 24 loci x 300 bp (seed 11) in directory d."""
    from gphocs_tpu_torch.io.simulate import simulate_seq_file
    from gphocs_tpu_torch.model import build_poptree

    cfg = parse_control_text(samples.SAMPLE_CTL)
    path = os.path.join(str(d), "seqs.txt")
    simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=24,
                      seq_len=300, seed=11)
    return path


def warm_sampler(spec, mesh=None, loci_multiple=1) -> Sampler:
    """SPEC's control file (a name in config/samples.py) on SPEC["seqs"],
    initialized at f64 with start-mig passed and the band hot (2e5), so
    that migrations appear and every move accepts."""
    cfg = parse_control_text(getattr(samples, spec["ctl"]))
    cfg.mcmc.random_seed = spec["seed"]
    cfg.mcmc.start_mig = 0
    cfg.mcmc.num_loci = spec.get("num_loci", cfg.mcmc.num_loci)
    s = Sampler(cfg, seq_path=spec["seqs"], dtype=torch.float64,
                device="cpu", buckets=spec.get("buckets", 1), mesh=mesh,
                loci_multiple=loci_multiple, chains=spec.get("chains", 1),
                rng_mode=spec.get("rng_mode", "fast"))
    s.initialize()
    s._sample_mig_rates_device()
    s.params = s.params._replace(
        mig_rate=torch.full_like(s.params.mig_rate, 2e5))
    s.lnps = tuple(gen_log_prior(g, s.params, s.ctx) for g in s.gens)
    return s


def state_of(s: Sampler) -> dict:
    """The per-locus state of every bucket (all ranks' loci, in the
    global chain-major order), the per-locus streams (fast: keys and
    counters; legacy: the Wichmann-Hill states, "wh"), the parameters
    and the general stream."""
    def rows(t):
        return t if s.mesh is None else gather_rows(s.mesh, t, s.chains)

    out = {"gens": [GenState(*(rows(x) for x in g)) for g in s.gens],
           "lnlds": [rows(x) for x in s.lnlds],
           "lnps": [rows(x) for x in s.lnps],
           "conds": [rows(x) for x in s.conds],
           "params": s.params, "grng": s.grng}
    if isinstance(s.lrngs[0], WhRngState):
        out["wh"] = [WhRngState(*(rows(f) for f in r)) for r in s.lrngs]
    else:
        out["keys"] = [rows(r.key) for r in s.lrngs]
        out["ctrs"] = [r.ctr for r in s.lrngs]
    return out


def node_age_case(s: Sampler) -> dict:
    from gphocs_tpu_torch.ops.sweeps import node_age_sweep

    g, r, lnld, lnp, cond, acc = node_age_sweep(
        s.gen, s.params, s.seq, s.lrng, s.ctx, s.ft.coal_time, s.lnld, s.lnp,
        s.cond)
    s.gens, s.lrngs, s.lnlds, s.lnps, s.conds = (g,), (r,), (lnld,), \
        (lnp,), (cond,)
    if s.mesh is not None:
        acc = M.all_reduce(s.mesh, [acc])[0]
    return {"acc": acc, "state": state_of(s)}


def locus_rate_case(s: Sampler, finetune: float) -> dict:
    """The legacy serial rate update alone (one chain), with its accepts,
    variance delta and the collectives it made."""
    from gphocs_tpu_torch.kernels.locus_rate import update_locus_rates

    M.reset_collective_counts()
    g, r, lnld, acc, dvar = update_locus_rates(
        s.gen, s.seq, s.lrng, torch.tensor(finetune, dtype=torch.float64),
        s.lnld, s.cfg.mcmc.var_rates_alpha, chains=s.chains,
        loci_axis=s.mesh, ref_seq=s.ref_seq)
    coll = {k: M.COLLECTIVES[k] for k in ("all_reduce", "broadcast")}
    s.gen, s.lrng, s.lnld = g, r, lnld
    return {"acc": acc, "dvar": dvar, "collectives": coll,
            "state": state_of(s)}


def chunk_case(s: Sampler, iters: int) -> dict:
    st, tr = s.step_chunk(iters, do_migrate=True)
    return {"stats": st, "trace": tr, "state": state_of(s)}


def load_carried(s: Sampler, state: dict) -> None:
    """Put a saved unsharded one-bucket state into s, each rank keeping
    its block of the per-locus tensors."""
    b = s.blocks[0]
    s.gen = GenState(*(x[b] for x in state["gen"]))
    s.seq = type(state["seq"])(*(None if x is None else x[b]
                                 for x in state["seq"]))
    s.lrng = state["lrng"]._replace(key=state["lrng"].key[b])
    s.lnld, s.lnp, s.cond = (state[k][b] for k in ("lnld", "lnp", "cond"))
    s.params, s.grng, s.ft = state["params"], state["grng"], state["ft"]


def run_case(spec: dict, mesh, rank: int):
    """One case of a spec on this rank; its result (rank 0's is saved)."""
    case = spec["case"]
    if case == "run":
        cfg = parse_control_text(spec["ctl_text"])
        s = Sampler(cfg, device="cpu", mesh=mesh,
                    buckets=spec.get("buckets", 1),
                    chains=spec.get("chains", 1),
                    rng_mode=spec.get("rng_mode", "fast"))
        s.run(**spec["run"])
        return {"chain_rows": s.chain_rows} if "out" in spec else None
    if case == "carried":
        cfg = parse_control_text(getattr(samples, spec["ctl"]))
        s = Sampler(cfg, seq_path=spec["seqs"], device="cpu", mesh=mesh)
        s.initialize()
        load_carried(s, torch.load(spec["state"], weights_only=False))
        return chunk_case(s, spec["iters"])
    if case == "resume":
        from gphocs_tpu_torch.checkpoint import load_checkpoint

        cfg = parse_control_text(getattr(samples, spec["ctl"]))
        s = Sampler(cfg, seq_path=spec["seqs"], device="cpu", mesh=mesh,
                    chains=spec.get("chains", 1),
                    rng_mode=spec.get("rng_mode", "fast"))
        s.initialize()
        load_checkpoint(s, spec["ckpt"])
        return chunk_case(s, spec["iters"])
    if case == "check":
        s = warm_sampler(spec, mesh)
        out = {"clean": s.check_state()}
        if rank == 1:  # two loci moved apart: their sum stays
            d = torch.zeros_like(s.lnld)
            d[:2] = torch.tensor([1e-3, -1e-3])
            s.lnld = s.lnld + d
        out["moved"] = s.check_state()
        return out
    s = warm_sampler(spec, mesh)
    if case == "locus_rate":
        return locus_rate_case(s, spec["finetune"])
    return (node_age_case(s) if case == "node_age"
            else chunk_case(s, spec["iters"]))


def main(spec_path: str, rank: int) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    M.init_distributed(f"127.0.0.1:{spec['port']}", spec["world"], rank,
                       device="cpu", timeout_s=TIMEOUT_S)
    try:
        mesh = M.make_mesh()
        for one in spec.get("cases", [spec]):
            out = run_case(one, mesh, rank)
            if out is not None and rank == 0:
                torch.save(out, one["out"])
    finally:
        M.shutdown()
    return 0


def close(a, b, what):
    np.testing.assert_allclose(b.double().numpy(), a.double().numpy(),
                               rtol=REL, atol=0, err_msg=what)


def same_state(ref: dict, got: dict, exact: bool = False) -> None:
    """Two state_of() results: integer arrays, keys and counters equal,
    reals within REL relative, or everything bitwise where `exact`."""
    def same(a, b, what):
        if exact or not a.is_floating_point():
            assert a.shape == b.shape and torch.equal(a, b), what
        else:
            close(a, b, what)

    for g_r, g_g in zip(ref["gens"], got["gens"]):
        for f in g_r._fields:
            same(getattr(g_r, f), getattr(g_g, f), f"gen.{f}")
    assert sorted(ref) == sorted(got)
    for k in ("lnlds", "lnps", "conds", "keys", "ctrs"):
        for a, b in zip(ref.get(k, ()), got.get(k, ())):
            same(a, b, k)
    for r_r, r_g in zip(ref.get("wh", ()), got.get("wh", ())):
        for f in r_r._fields:
            same(getattr(r_r, f), getattr(r_g, f), f"wh.{f}")
    for f in ref["grng"]._fields:
        assert torch.equal(getattr(ref["grng"], f),
                           getattr(got["grng"], f)), f"grng.{f}"
    for f in ref["params"]._fields:
        a, b = getattr(ref["params"], f), getattr(got["params"], f)
        if a is not None:
            same(a, b, f"params.{f}")


def same_chunk(ref: dict, got: dict, exact: bool = False) -> None:
    """Two chunk_case() results: stats, trace and state as same_state
    holds them."""
    for part in ("stats", "trace"):
        r, g = ref[part], got[part]
        for f in r._fields:
            a, b = getattr(r, f), getattr(g, f)
            if exact or not a.is_floating_point():
                assert a.shape == b.shape and torch.equal(a, b), \
                    f"{part}.{f}"
            else:
                close(a, b, f"{part}.{f}")
    same_state(ref["state"], got["state"], exact)


def run_ranks(spec: dict, tmp_path, timeout_s: float = TIMEOUT_S + 60
              ) -> None:
    """Start SPEC's ranks side by side and wait for them; every one must
    exit 0 within timeout_s (by default TIMEOUT_S plus its start-up)."""
    spec = dict(spec, port=M.free_port())
    path = os.path.join(str(tmp_path), f"spec_{spec['port']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.mesh_rank", path, str(r)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(spec["world"])]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-3000:]}"


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
