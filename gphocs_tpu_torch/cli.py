"""Command-line interface, compatible with the reference binary's usage
(twin of gphocs_tpu/cli.py, same flags):

    python -m gphocs_tpu_torch [-v] [-n threads] <control-file> \
        [secondary-control] [--buckets K | --chains C] [--checkpoint PATH \
        --checkpoint-every N] [--resume] [--debug-check] [--device cpu]

(reference src/GPhoCS.c:28-249).  The run goes on the CUDA card unless
`--device cpu` is given; asking for CUDA without a card raises, nothing
falls back to the CPU.  float32 on the card and float64 on the CPU unless
`--x64`.  The device streams are the counter-based fast RNG (the only
mode ported); the options of modes not ported yet raise before any file
is read.  `--chains C` runs C independent chains side by side (seeds base +
7919 c; chain 0 writes the trace), not with `--buckets` or a coal-stats
file.  A control file with admixed samples runs without `--buckets` (as
in gphocs_tpu) and writes admixture-trace.out beside the trace.  `-n` is
accepted for compatibility and ignored.
"""

from __future__ import annotations

import argparse
import sys
import time

# flags of what is not ported yet, and the ROADMAP item of each
_NOT_PORTED = {
    "legacy_rng": ("--legacy-rng (the Wichmann-Hill streams)",
                   "Queue 1 item 17"),
    "mesh": ("--mesh (loci sharded over several devices)",
             "Queue 1 item 15"),
    "distributed": ("--distributed (several hosts)", "Queue 1 item 15"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gphocs-tpu-torch",
        description="G-PhoCS on an NVIDIA GPU: Bayesian coalescent MCMC "
                    "for demographic inference")
    ap.add_argument("control_file")
    ap.add_argument("secondary_control", nargs="?", default=None)
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print the kernel launches of the run at its end")
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
                    help="counter-based RNG streams (the only mode of this "
                         "package; accepted for compatibility)")
    ap.add_argument("--legacy-rng", action="store_true",
                    help="reference-conformance mode (not ported)")
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
                    help="shard loci over all visible devices (not ported)")
    ap.add_argument("--distributed", metavar="COORD:NPROC:PID",
                    help="multi-host run (not ported)")
    args = ap.parse_args(argv)

    # refuse what is not ported, or not allowed, before any file is read
    for flag, (what, item) in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"{what} is not ported to gphocs_tpu_torch yet "
                f"(ROADMAP {item})")
    if args.chains < 1:
        ap.error("--chains takes one chain or more")
    if args.buckets > 1 and args.chains > 1:
        ap.error("--buckets requires one chain (as in gphocs_tpu)")

    import torch

    from gphocs_tpu_torch.config import parse_control_file
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler.driver import Sampler

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device (use "
                               "--device cpu to run on the CPU)")
        where = f"cuda ({torch.cuda.get_device_name(0)})"
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
    print(f"gphocs_tpu_torch on {where}, "
          f"{'float64' if use_x64 else 'float32'}, fast RNG")
    t0 = time.time()
    sampler = Sampler(cfg, dtype=dtype, device=args.device,
                      legacy_rng=not args.production_rng,
                      buckets=args.buckets, chains=args.chains)
    print(f"{sampler.num_loci} loci, {cfg.num_samples} samples, "
          f"{cfg.num_pops} pops, {len(cfg.bands)} migration band(s); "
          f"{cfg.num_parameters()} parameters")
    if sampler.chains > 1:
        print(f"{sampler.chains} chains, seeds {sampler.seed} + 7919 c; "
              "chain 0 writes the trace")
    if sampler.buckets > 1:
        print(f"{sampler.buckets} pattern buckets: loci "
              f"{sampler.bucket_sizes}, pattern capacity "
              f"{[sq.group_id.shape[1] for sq in sampler.seqs]}")
    sweeps.reset_launch_counts()
    sampler.run(trace_path=cfg.mcmc.trace_file, progress=True,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                resume=args.resume, debug_check=args.debug_check)
    if args.verbose:
        print(f"kernel launches: {dict(sweeps.LAUNCHES)}", file=sys.stderr)
    print(f"MCMC finished. Time used: {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
