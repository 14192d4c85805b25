"""The four sweep kernels' wrappers: node-age, migration-age, rubber-band
evaluation and SPR (the port of gphocs_tpu/ops/sweeps_pallas.py).

Each wrapper takes the Pallas wrapper's arguments and returns its outputs,
in the [L, ...] layout of the state (no lanes-last transposes):

  * CUDA tensors: launch the hand-written kernel in csrc/ (one thread per
    locus, blocks of BLOCK loci) on the current stream and add one to the
    wrapper's entry in LAUNCHES;
  * CPU tensors: call the kernel's plain PyTorch version;
  * any other device, a dtype or shape the kernel does not take, or a
    non-contiguous tensor: raise.

A failed build or launch raises; nothing falls back from the kernel to
the plain version or from CUDA to the CPU.

SPR walk trips synchronize per group of loci (kernels/spr.py): on CUDA
the group is the kernel's block (BLOCK loci), on the CPU it is all L
loci, so the CPU path reproduces gphocs_tpu's XLA update_spr.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch.kernels.common import Context, band_windows, pop_end
from gphocs_tpu_torch.kernels.mig_age import update_mig_ages
from gphocs_tpu_torch.kernels.node_age import update_internal_node_ages
from gphocs_tpu_torch.kernels.spr import update_spr
from gphocs_tpu_torch.kernels.tau import rubber_band_eval_plain
from gphocs_tpu_torch.ops import cuda_lib
from gphocs_tpu_torch.rng_fast import MASK32, FastRngState
from gphocs_tpu_torch.state import GenState, Params, SeqData

# loci per CUDA block; also the SPR trip-synchronization group on CUDA
BLOCK = 64

# kernel launches per wrapper since the last reset_launch_counts(); the
# rubber-band kernel's two modes (tau, sample age) are counted apart
LAUNCHES = {"node_age": 0, "mig_age": 0, "rubber_band": 0,
            "rubber_band_sample_age": 0, "spr": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raise otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"sweep inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sweep kernels run on CUDA or CPU, not {dev}")
    return dev.type == "cuda"


def _check(t: torch.Tensor, name: str, dtype, shape) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")
    return t.data_ptr()


def _real_suffix(dt) -> str:
    if dt == torch.float32:
        return "f32"
    if dt == torch.float64:
        return "f64"
    raise TypeError(f"sweep kernels take float32 or float64, not {dt}")


def _pop_tables(ctx: Context, params: Params, tau: torch.Tensor):
    """Packed per-population tables for the kernels:
    popf = [theta(PP), tau(PP), pop_end(PP), band_start(B), band_end(B),
    mig_rate(B)], popi = [father_pop(PP), band_source(B), band_target(B),
    is_ancestral(PP*PP)] (is_ancestral[i, j]: i ancestor-or-self of j)."""
    bs, be = band_windows(ctx, tau)
    popf = torch.cat([params.theta, tau, pop_end(ctx, tau), bs, be,
                      params.mig_rate]).contiguous()
    popi = torch.cat([ctx.father_pop, ctx.band_source, ctx.band_target,
                      ctx.is_ancestral.reshape(-1).to(torch.int64)]
                     ).contiguous()
    return popf, popi


def _args(gen: GenState, params: Params, ctx: Context, seq, rng,
          tau: torch.Tensor, keep: list) -> cuda_lib.SweepArgs:
    """SweepArgs with the state inputs filled in and checked."""
    L, N = gen.father.shape
    M = gen.max_migs
    PP = ctx.num_pops
    B = ctx.num_bands
    dt = gen.age.dtype
    i64 = torch.int64
    for name, v, cap in (("nodes", N, cuda_lib.MAXN), ("mig slots", M,
                         cuda_lib.MAXM), ("populations", PP, cuda_lib.MAXPP),
                         ("bands", B, cuda_lib.MAXB)):
        if v > cap:
            raise ValueError(f"{v} {name}: the kernels take at most {cap}")
    a = cuda_lib.SweepArgs()
    a.age = _check(gen.age, "age", dt, (L, N))
    for f in ("lson", "rson", "father", "node_pop"):
        setattr(a, f, _check(getattr(gen, f), f, i64, (L, N)))
    a.root = _check(gen.root, "root", i64, (L,))
    a.mig_branch = _check(gen.mig_branch, "mig_branch", i64, (L, M))
    a.mig_band = _check(gen.mig_band, "mig_band", i64, (L, M))
    a.mig_age = _check(gen.mig_age, "mig_age", dt, (L, M))
    a.mut_rate = _check(gen.mut_rate, "mut_rate", dt, (L,))
    a.valid = _check(gen.valid, "valid", torch.bool, (L,))
    if seq is not None:
        P = seq.group_id.shape[1]
        a.group_id = _check(seq.group_id, "group_id", i64, (L, P))
        a.group_count = _check(seq.group_count, "group_count", dt, (L, P))
        a.group_nphases = _check(seq.group_nphases, "group_nphases", dt,
                                 (L, P))
        a.pattern_valid = _check(seq.pattern_valid, "pattern_valid",
                                 torch.bool, (L, P))
        a.P = P
    popf, popi = _pop_tables(ctx, params, tau)
    a.popf = _check(popf, "popf", dt, (3 * PP + 3 * B,))
    a.popi = _check(popi, "popi", i64, (PP + 2 * B + PP * PP,))
    if rng is not None:
        a.key = _check(rng.key, "key", i64, (L,))
        a.ctr = _check(rng.ctr, "ctr", i64, ())
    keep += [popf, popi]
    a.L, a.N, a.M, a.B, a.PP = L, N, M, B, PP
    a.root_pop = ctx.root_pop
    a.block = BLOCK
    a.oldage = ctx.oldage
    return a


def _scalar(x, dt, device, keep: list) -> int:
    t = torch.as_tensor(x, dtype=dt, device=device).reshape(()).contiguous()
    keep.append(t)
    return t.data_ptr()


def _advance(rng: FastRngState, n) -> FastRngState:
    return rng._replace(ctr=(rng.ctr + n) & MASK32)


def node_age_sweep(gen: GenState, params: Params, seq: SeqData,
                   rng: FastRngState, ctx: Context, finetune, lnld, lnp,
                   cond):
    """Fused node-age sweep (gphocs_tpu's node_age_sweep_pallas).
    Returns (gen, rng, lnld, lnp, cond, acc)."""
    if not _on_cuda(gen.age, cond, lnld, lnp, rng.key):
        return update_internal_node_ages(gen, params, seq, rng, ctx,
                                         finetune, lnld, lnp, cond)
    L, N, P, _ = cond.shape
    dt = gen.age.dtype
    keep = []
    a = _args(gen, params, ctx, seq, rng, params.tau, keep)
    a.finetune = _scalar(finetune, dt, cond.device, keep)
    a.lnld_in = _check(lnld, "lnld", dt, (L,))
    a.lnp_in = _check(lnp, "lnp", dt, (L,))
    a.cond_in = _check(cond, "cond", dt, (L, N, P, 4))
    cond_out = torch.empty_like(cond)
    prop = torch.empty_like(cond)
    gsum = torch.empty((L, P), dtype=dt, device=cond.device)
    age_out = torch.empty_like(gen.age)
    lnld_out = torch.empty_like(lnld)
    lnp_out = torch.empty_like(lnp)
    acc = torch.empty((L,), dtype=torch.int32, device=cond.device)
    a.cond_out, a.prop, a.gsum = (cond_out.data_ptr(), prop.data_ptr(),
                                  gsum.data_ptr())
    a.age_out, a.lnld_out, a.lnp_out = (age_out.data_ptr(),
                                        lnld_out.data_ptr(),
                                        lnp_out.data_ptr())
    a.acc_out = acc.data_ptr()
    cuda_lib.launch(f"node_age_{_real_suffix(dt)}", a,
                    torch.cuda.current_stream(cond.device).cuda_stream)
    LAUNCHES["node_age"] += 1
    S = (N + 1) // 2
    return (gen._replace(age=age_out), _advance(rng, 4 * (S - 1)),
            lnld_out, lnp_out, cond_out, acc.sum(dtype=torch.int64))


def mig_age_sweep(gen: GenState, params: Params, rng: FastRngState,
                  ctx: Context, finetune, lnp):
    """Fused migration-age sweep (gphocs_tpu's mig_age_sweep_pallas).
    Returns (gen, rng, lnp, acc)."""
    if not _on_cuda(gen.age, lnp, rng.key):
        return update_mig_ages(gen, params, rng, ctx, finetune, lnp)
    if ctx.num_bands == 0:
        return gen, rng, lnp, torch.zeros((), dtype=torch.int64,
                                          device=lnp.device)
    L, M = gen.mig_branch.shape
    dt = gen.age.dtype
    keep = []
    a = _args(gen, params, ctx, None, rng, params.tau, keep)
    a.finetune = _scalar(finetune, dt, lnp.device, keep)
    a.lnp_in = _check(lnp, "lnp", dt, (L,))
    mag_out = torch.empty_like(gen.mig_age)
    lnp_out = torch.empty_like(lnp)
    acc = torch.empty((L,), dtype=torch.int32, device=lnp.device)
    a.mig_age_out, a.lnp_out, a.acc_out = (mag_out.data_ptr(),
                                           lnp_out.data_ptr(),
                                           acc.data_ptr())
    cuda_lib.launch(f"mig_age_{_real_suffix(dt)}", a,
                    torch.cuda.current_stream(lnp.device).cuda_stream)
    LAUNCHES["mig_age"] += 1
    return (gen._replace(mig_age=mag_out), _advance(rng, 4 * M), lnp_out,
            acc.sum(dtype=torch.int64))


def rubber_band_eval(gen: GenState, params: Params, seq: SeqData,
                     ctx: Context, pop: int, is_sample_age: bool,
                     taub0, taub1, tauold, taunew, cond):
    """Evaluate one population's rubber-band proposal for every locus
    (gphocs_tpu's rubber_band_eval_pallas).  With is_sample_age, `pop` is a
    current population and the proposal moves its sample age; otherwise it
    is an ancestral population and the proposal moves its tau.  Returns
    (age_prop, mag_prop, cond_prop, lnld_prop, lnp_prop, ntj0 [], ntj1 [],
    any_conflict [])."""
    is_sample_age = bool(is_sample_age)
    if not _on_cuda(gen.age, cond):
        return rubber_band_eval_plain(gen, params, seq, ctx, pop,
                                      is_sample_age, taub0, taub1, tauold,
                                      taunew, cond)
    L, N, P, _ = cond.shape
    dt = gen.age.dtype
    dev = cond.device
    keep = []
    # the proposal's population tables: a sample-age move leaves tau, and
    # with it the band windows and pop_end, as they are
    new_tau = params.tau
    if not is_sample_age:
        new_tau = params.tau.clone()
        new_tau[pop] = taunew
    a = _args(gen, params, ctx, seq, None, new_tau, keep)
    rscal = torch.stack([torch.as_tensor(x, dtype=dt, device=dev).reshape(())
                         for x in (taub0, taub1, tauold, taunew)])
    keep.append(rscal)
    a.rscal = rscal.data_ptr()
    a.pop = int(pop)
    a.is_root = int(pop == ctx.root_pop and not is_sample_age)
    a.sample_age = int(is_sample_age)
    a.cond_in = _check(cond, "cond", dt, (L, N, P, 4))
    cond_out = torch.empty_like(cond)
    gsum = torch.empty((L, P), dtype=dt, device=dev)
    age_out = torch.empty_like(gen.age)
    mag_out = torch.empty_like(gen.mig_age)
    lnld_out = torch.empty((L,), dtype=dt, device=dev)
    lnp_out = torch.empty((L,), dtype=dt, device=dev)
    aux = torch.empty((3, L), dtype=torch.int32, device=dev)
    a.cond_out, a.gsum = cond_out.data_ptr(), gsum.data_ptr()
    a.age_out, a.mig_age_out = age_out.data_ptr(), mag_out.data_ptr()
    a.lnld_out, a.lnp_out = lnld_out.data_ptr(), lnp_out.data_ptr()
    a.aux0_out, a.aux1_out, a.aux2_out = (aux[0].data_ptr(),
                                          aux[1].data_ptr(),
                                          aux[2].data_ptr())
    cuda_lib.launch(f"rubber_band_{_real_suffix(dt)}", a,
                    torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["rubber_band_sample_age" if is_sample_age
             else "rubber_band"] += 1
    v = gen.valid
    ntj0 = torch.where(v, aux[0], 0).sum().to(dt)
    ntj1 = torch.where(v, aux[1], 0).sum().to(dt)
    conflict = (v & (aux[2] > 0)).any()
    return (age_out, mag_out, cond_out, lnld_out, lnp_out, ntj0, ntj1,
            conflict)


def spr_sweep(gen: GenState, params: Params, seq: SeqData,
              rng: FastRngState, ctx: Context, lnld, cond):
    """Fused SPR sweep (gphocs_tpu's spr_sweep_pallas, no admixture).
    Returns (gen, rng, lnld, cond, acc)."""
    if not _on_cuda(gen.age, cond, lnld, rng.key):
        return update_spr(gen, params, seq, rng, ctx, lnld, cond,
                          sync_group=gen.num_loci)
    if ctx.num_admixed > 0:
        raise NotImplementedError(
            "SPR with admixture: ROADMAP Queue 1 item 10b")
    L, N, P, _ = cond.shape
    M = gen.max_migs
    dt = gen.age.dtype
    dev = cond.device
    keep = []
    a = _args(gen, params, ctx, seq, rng, params.tau, keep)
    a.lnld_in = _check(lnld, "lnld", dt, (L,))
    a.cond_in = _check(cond, "cond", dt, (L, N, P, 4))
    out = {f: torch.empty_like(getattr(gen, f))
           for f in ("age", "lson", "rson", "father", "node_pop", "root",
                     "mig_branch", "mig_band", "mig_age")}
    cond_out = torch.empty_like(cond)
    prop = torch.empty_like(cond)
    gsum = torch.empty((L, P), dtype=dt, device=dev)
    lnld_out = torch.empty_like(lnld)
    acc = torch.empty((L,), dtype=torch.int32, device=dev)
    used = torch.empty((L,), dtype=torch.int32, device=dev)
    for f, t in out.items():
        setattr(a, f + "_out", t.data_ptr())
    a.cond_out, a.prop, a.gsum = (cond_out.data_ptr(), prop.data_ptr(),
                                  gsum.data_ptr())
    a.lnld_out, a.acc_out, a.aux0_out = (lnld_out.data_ptr(),
                                         acc.data_ptr(), used.data_ptr())
    cuda_lib.launch(f"spr_{_real_suffix(dt)}", a,
                    torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["spr"] += 1
    return (gen._replace(**out), _advance(rng, used.max().to(torch.int64)),
            lnld_out, cond_out, acc.sum(dtype=torch.int64))
