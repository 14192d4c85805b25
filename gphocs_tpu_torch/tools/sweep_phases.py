"""Where a sweep kernel's time goes, phase by phase, on one CUDA card.

    python -m gphocs_tpu_torch.tools.sweep_phases [--kernel spr|node_age]
        [--loci 1000] [--bp 1000] [--block 8]

Builds the kernels a second time with -DSWEEP_PROFILE (csrc/spr.cu and
csrc/node_age.cu then read clock64() between the phases of every locus's
chain), warms the standard workload's sampler at f32 as
tools/profile_main.py does, launches the chosen kernel on its state and
prints, per phase, the mean and the largest number of cycles over the loci,
the share of the mean, and the launch's time by CUDA events.  A locus is
one warp, so the cycles of a phase are those of its chain of dependent
steps, waits for the other warps of its scheduler included; the counting
itself costs a few per cent.
"""

from __future__ import annotations

import argparse
import os
import tempfile

# the phases between the SWEEP_TICK marks of csrc/spr.cu, in order
SPR_PHASES = ("load tables and conditionals", "edge tops, mig windows",
              "boundary grid and sort", "hazards", "prefix scan",
              "crossing, event, draws", "covering branches, status",
              "commit tables", "refresh root paths", "root lnld",
              "MH, accept copies", "store")
# ... and of csrc/node_age.cu
NODE_AGE_PHASES = ("load tables, conditionals, invariants",
                   "bounds and proposal", "prior delta",
                   "refresh root path", "root lnld",
                   "MH, restore on reject", "store")
PHASES = {"spr": SPR_PHASES, "node_age": NODE_AGE_PHASES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(PHASES), default="spr")
    ap.add_argument("--loci", type=int, default=1000)
    ap.add_argument("--bp", type=int, default=1000)
    ap.add_argument("--block", type=int, default=None,
                    help="loci per block (default: ops/sweeps.BLOCK)")
    a = ap.parse_args(argv)

    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL
    from gphocs_tpu_torch.io.simulate import simulate_seq_file
    from gphocs_tpu_torch.model import build_poptree
    from gphocs_tpu_torch.ops import cuda_lib, sweeps
    from gphocs_tpu_torch.tools.profile_main import _card, _sampler

    if not torch.cuda.is_available():
        print("sweep_phases: no CUDA device")
        return 1
    cuda_lib.NVCC_FLAGS += ("-DSWEEP_PROFILE",)  # before the first build
    if a.block:
        sweeps.BLOCK = a.block
    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "workload.txt")
        cfg = parse_control_text(SAMPLE_CTL)
        simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=a.loci,
                          seq_len=a.bp, seed=20260817)
        s = _sampler(path, torch.float32)

    dev = s.cond.device
    if a.kernel == "spr":
        p = sweeps.prepare_spr(s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld,
                               s.cond)
    else:
        p = sweeps.prepare_node_age(s.gen, s.params, s.seq, s.lrng, s.ctx,
                                    s.ft.coal_time, s.lnld, s.lnp, s.cond)
    buf = torch.zeros((a.loci, 16), dtype=torch.int64, device=dev)
    p.args.prof = buf.data_ptr()
    p.launch(dev)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(20):
        p.launch(dev)
    t1.record()
    torch.cuda.synchronize()
    mean = buf.double().mean(dim=0).tolist()
    most = buf.max(dim=0).values.tolist()
    print(f"{a.kernel} kernel with phase counters: "
          f"{t0.elapsed_time(t1) / 20:.4f} ms per launch, "
          f"{p.plan.loci_per_block} loci per block, L={a.loci}, f32, on "
          f"{card}")
    if a.kernel == "spr":
        trips = (mean[13] - s.gen.num_nodes) / 2
        own = f"walk trips per locus: mean {trips:.2f}"
    else:
        own = f"accepts per locus: mean {mean[13]:.2f}"
    print(f"cycles per locus: mean {mean[12]:.0f}, largest {most[12]}; {own}")
    for name, m, x in zip(PHASES[a.kernel], mean, most):
        print(f"  {name:38s} mean {m:9.0f} ({m / mean[12]:6.1%})  "
              f"largest {x:8d}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
