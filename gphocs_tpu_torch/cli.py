"""Command-line interface, compatible with the reference binary's usage
(twin of gphocs_tpu/cli.py, same flags):

    python -m gphocs_tpu_torch [-v] [-n threads] <control-file> \
        [secondary-control] [--buckets K | --chains C] [--checkpoint PATH \
        --checkpoint-every N] [--resume] [--debug-check] [--device cpu] \
        [--fast-rng | --legacy-rng] [--mesh | --distributed COORD:NPROC:PID]

(reference src/GPhoCS.c:28-249).  The run goes on the CUDA card unless
`--device cpu` is given; asking for CUDA without a card raises, nothing
falls back to the CPU.  float32 on the card and float64 on the CPU unless
`--x64`.  The RNG mode is resolved as gphocs_tpu resolves it: the fast,
counter-based streams on the card and the reference-conformance mode
(`--legacy-rng`: the Wichmann-Hill streams, the node-age, migration-age
and SPR sweeps as tensor code, gphocs_tpu's legacy run draw for draw) on
the CPU, unless `--fast-rng` or `--legacy-rng` says otherwise; both
together are a usage error, and so are pattern buckets with the legacy
RNG.  The start line names the mode and the chains.  `--chains C` runs C
independent chains side by side (seeds base + 7919 c; chain 0 writes the
trace), not with `--buckets` or a coal-stats file.  A control file with
admixed samples runs without `--buckets` (as in gphocs_tpu) and writes
admixture-trace.out beside the trace.  `-n` is accepted for compatibility
and ignored.

Loci sharding (parallel/mesh.py): `--distributed COORD:NPROC:PID` runs
this process as rank PID of NPROC, COORD being rank 0's host:port; every
rank is started with the same arguments.  `--mesh` starts one rank per
visible CUDA device itself (this process is rank 0, the others are
started as `--distributed` processes on 127.0.0.1), or a world of one with
`--device cpu`.  Rank 0 prints, writes the trace, the checkpoint and the
other files; a rank that fails fails the run (the process group's
timeout is --mesh-timeout).  With `--chains C` every rank holds its block
of every chain's loci; the trace is chain 0's, as in one process.  Both
RNG modes run on a mesh: `--device cpu --mesh` takes the legacy RNG, as
on the CPU without a mesh, and its serial rate update hands its carry
from rank to rank (W broadcasts per update).  Every rank makes every
collective, those of the trace, the checkpoints, `--debug-check` and the
coal-stats file included; rank 0 is the only writer, and `-v`'s method
times are rank 0's own loci, timed without collectives.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

def _parse_distributed(ap, spec: str):
    """COORD:NPROC:PID (split as gphocs_tpu does, from the right) ->
    (coord, nproc, pid); a malformed one is a usage error."""
    try:
        coord, nproc, pid = spec.rsplit(":", 2)
        nproc, pid = int(nproc), int(pid)
        host, port = coord.rsplit(":", 1)
        int(port)
    except ValueError:
        ap.error(f"--distributed {spec!r}: expected COORD:NPROC:PID with "
                 "COORD = host:port of rank 0")
    if not (host and nproc >= 1 and 0 <= pid < nproc):
        ap.error(f"--distributed {spec!r}: expected 0 <= PID < NPROC")
    return coord, nproc, pid


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gphocs-tpu-torch",
        description="G-PhoCS on an NVIDIA GPU: Bayesian coalescent MCMC "
                    "for demographic inference")
    ap.add_argument("control_file")
    ap.add_argument("secondary_control", nargs="?", default=None)
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print the kernel launches of the run and each "
                         "update family's time at its end")
    ap.add_argument("-n", "--nthreads", type=int, default=0,
                    help="accepted for reference compatibility (ignored)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the sampler runs (default: the CUDA card)")
    ap.add_argument("--x64", action="store_true", default=None,
                    help="force float64 (default on the CPU; float32 on "
                         "the card)")
    ap.add_argument("--production-rng", action="store_true",
                    help="seed every slot of the host initialization "
                         "stream on its own instead of the reference's "
                         "identical seeding")
    ap.add_argument("--fast-rng", action="store_true", default=None,
                    help="counter-based RNG streams and the sweep kernels "
                         "(the default on the card)")
    ap.add_argument("--legacy-rng", action="store_true",
                    help="reference-conformance mode: the Wichmann-Hill "
                         "streams, consumed as the reference does (the "
                         "default on the CPU)")
    ap.add_argument("--buckets", type=int, default=1, metavar="K",
                    help="pattern-axis bucketing for ragged loci: sort "
                         "loci by pattern count into K buckets, each "
                         "padded only to its own max")
    ap.add_argument("--debug-check", action="store_true",
                    help="run the checkAll-analogue state invariants at "
                         "every log point (reference GPhoCS.c:1814)")
    ap.add_argument("--checkpoint", metavar="PATH",
                    help="checkpoint file (with --checkpoint-every)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="N", help="checkpoint every N iterations")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    ap.add_argument("--chains", type=int, default=1,
                    help="independent chains side by side (R-hat/ESS via "
                         "tools/convergence.py); chain 0 writes the trace")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the loci over one rank per visible CUDA "
                         "device (a world of one with --device cpu)")
    ap.add_argument("--distributed", metavar="COORD:NPROC:PID",
                    help="run as rank PID of NPROC processes sharding the "
                         "loci; COORD is rank 0's host:port")
    ap.add_argument("--mesh-timeout", type=float, metavar="S",
                    help="seconds a rank waits in a collective before the "
                         "run fails (default 600)")
    args = ap.parse_args(argv)

    # refuse what is not ported, or not allowed, before any file is read;
    # the RNG mode as gphocs_tpu resolves it (fast on the accelerator,
    # legacy elsewhere, unless a flag says otherwise)
    if args.legacy_rng and args.fast_rng:
        ap.error("--legacy-rng and --fast-rng are mutually exclusive")
    if args.fast_rng is None and not args.legacy_rng:
        args.fast_rng = args.device == "cuda"
    legacy = not args.fast_rng
    if args.buckets > 1 and legacy:
        ap.error("--buckets requires the fast RNG (as in gphocs_tpu): "
                 "drop --buckets or give --fast-rng")
    if args.chains < 1:
        ap.error("--chains takes one chain or more")
    if args.buckets > 1 and args.chains > 1:
        ap.error("--buckets requires one chain (as in gphocs_tpu)")
    if args.mesh and args.distributed:
        ap.error("--mesh or --distributed, not both")
    rank_of = None
    if args.distributed:
        rank_of = _parse_distributed(ap, args.distributed)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use "
                           "--device cpu to run on the CPU)")
    if not (args.mesh or args.distributed):
        return _run(args, ap, None)
    from gphocs_tpu_torch.parallel import mesh as M

    ranks = []
    if args.mesh:
        world = torch.cuda.device_count() if args.device == "cuda" else 1
        coord = f"127.0.0.1:{M.free_port()}"
        rank_of = (coord, world, 0)
        rest = [a for a in (sys.argv[1:] if argv is None else argv)
                if a != "--mesh"]
        ranks = [subprocess.Popen(
            [sys.executable, "-m", "gphocs_tpu_torch", *rest,
             "--distributed", f"{coord}:{world}:{r}"])
            for r in range(1, world)]
    ok = False
    try:
        M.init_distributed(*rank_of, device=args.device,
                           timeout_s=args.mesh_timeout
                           or M.DEFAULT_TIMEOUT_S)
        rc = _run(args, ap, M.make_mesh())
        ok = True
    finally:
        for p in ranks:
            if not ok:
                p.kill()
            p.wait()
        M.shutdown()
    failed = [r + 1 for r, p in enumerate(ranks) if p.returncode]
    if failed:
        raise RuntimeError(f"loci mesh: rank(s) {failed} failed")
    return rc


def _run(args, ap, mesh):
    """The run of this process (a rank of `mesh`, where given)."""
    import torch

    from gphocs_tpu_torch.config import parse_control_file
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler.driver import Sampler, route

    talk = mesh is None or mesh.rank == 0
    dev = args.device if mesh is None else mesh.device
    if args.device == "cuda":
        where = f"{dev} ({torch.cuda.get_device_name(dev)})"
    else:
        where = "cpu"
    use_x64 = args.x64 if args.x64 is not None else args.device == "cpu"
    dtype = torch.float64 if use_x64 else torch.float32
    cfg = parse_control_file(args.control_file, args.secondary_control)
    if args.buckets > 1 and cfg.admixed:
        ap.error("--buckets: admixture requires one pattern bucket (as in "
                 "gphocs_tpu)")
    if args.chains > 1 and cfg.mcmc.coal_stats_file != "NONE":
        ap.error("--chains: a coal-stats file takes one chain (drop "
                 "coal-stats-file from the control file)")
    say = print if talk else (lambda *a, **k: None)
    rng_mode = "fast" if args.fast_rng else "legacy"
    say(f"gphocs_tpu_torch on {where}, "
        f"{'float64' if use_x64 else 'float32'}, {route(rng_mode)}, "
        f"{args.chains} chain{'s' if args.chains > 1 else ''}")
    t0 = time.time()
    sampler = Sampler(cfg, dtype=dtype, device=args.device,
                      rng_mode=rng_mode, legacy_rng=not args.production_rng,
                      buckets=args.buckets, chains=args.chains, mesh=mesh)
    say(f"{sampler.num_loci} loci, {cfg.num_samples} samples, "
        f"{cfg.num_pops} pops, {len(cfg.bands)} migration band(s); "
        f"{cfg.num_parameters()} parameters")
    if mesh is not None:
        say(f"{mesh.world} rank(s), each holding {sampler.bucket_sizes} of "
            f"{sampler.global_rows} loci ({sum(sampler.bucket_pads)} "
            f"padding)")
    if sampler.chains > 1:
        say(f"{sampler.chains} chains, seeds {sampler.seed} + 7919 c; "
            "chain 0 writes the trace")
    if sampler.buckets > 1:
        say(f"{sampler.buckets} pattern buckets: loci "
            f"{sampler.bucket_sizes}, pattern capacity "
            f"{[sq.group_id.shape[1] for sq in sampler.seqs]}")
    sweeps.reset_launch_counts()
    sampler.run(trace_path=cfg.mcmc.trace_file, progress=talk,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                resume=args.resume, debug_check=args.debug_check)
    if args.verbose and talk:
        from gphocs_tpu_torch.profiling import print_kernel_times

        print(f"kernel launches: {dict(sweeps.LAUNCHES)}", file=sys.stderr)
        print(f"shared-memory plans: {sweeps.PLANS}", file=sys.stderr)
        # the reference's printMethodTimes (src/utils.c:233-326), as
        # gphocs_tpu prints it at the end of a verbose run
        print("method times (isolated, reference printMethodTimes "
              "analogue):", file=sys.stderr)
        try:
            print_kernel_times(sampler)
        except Exception as exc:  # profiling must never end a run
            print(f"  (unavailable: {exc!r})", file=sys.stderr)
    say(f"MCMC finished. Time used: {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
