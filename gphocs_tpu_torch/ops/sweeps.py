"""The four sweep kernels' wrappers: node-age, migration-age, rubber-band
evaluation and SPR (the port of gphocs_tpu/ops/sweeps_pallas.py).

Each wrapper takes the Pallas wrapper's arguments and returns its outputs,
in the [L, ...] layout of the state (no lanes-last transposes):

  * CUDA tensors: launch the hand-written kernel in csrc/ on the current
    stream and add one to the wrapper's entry in LAUNCHES.  Every kernel
    runs one warp per locus, BLOCK loci per block, with the locus's tables
    in shared memory, as the kernel's plan entry in csrc/ decides
    (`plan_for`);
  * CPU tensors: call the kernel's plain PyTorch version;
  * any other device, a dtype or shape the kernel does not take, or a
    non-contiguous tensor: raise.

A failed build or launch raises; nothing falls back from the kernel to
the plain version or from CUDA to the CPU.

LAUNCHES is ops/cuda_lib.LAUNCHES: besides the wrappers' entries it
holds "rng_draw", the launches of the counter streams' draw kernel
(csrc/counter_draw.cu), which rng_fast.py makes for CUDA streams and the
CPU never does.  Which route a call takes, here and in rng_fast.py, is
decided by cuda_lib.on_cuda.

The node-age, migration-age and SPR kernels draw from the counter-based
streams (rng_fast.py) only.  Their wrappers raise TypeError when handed
the Wichmann-Hill streams of the conformance mode (rng.WhRngState), on
any device: that mode runs the plain versions as its sweeps, on the
state's own device, through node_age_sweep_plain, mig_age_sweep_plain and
spr_sweep_plain, which count their calls in LAUNCHES under their own
names.  The rubber band draws nothing and serves both modes.

The kernels read theta, tau and the migration rates from the state's own
tensors and make pop_end and the band windows themselves; the integer
tables are built once per Context (`Context.popi`, the admixed leaves
and their populations included).  Where the run has admixed leaves, SPR
resamples a leaf's population before its walk and the rubber band adds
the prior's admixture terms; both read the coefficients [A] ([C, A]) from
the state's own tensor.  The rubber band and
SPR also reduce their per-locus counts on the card, so their wrappers
launch a fill, the kernel and two small conversions; node age and
migration age write the advanced counter themselves and count accepts per
locus in int64, so theirs launch the kernel and one reduction.

SPR walk trips (kernels/spr.py): on CUDA every locus walks on its own
(the plain version at sync_group = 1), whatever the block size; on the
CPU the trips synchronize over all L loci, so the CPU path reproduces
gphocs_tpu's XLA update_spr.

C chains (sampler/driver.py, `chains=C`): the state's loci are
chain-major, [C * Lc, ...], its parameters [C, P] and [C, B], the
per-locus streams' counter [C].  Every wrapper still launches its kernel
once, over all C * Lc loci: a block's loci are one chain's (the grid's
second axis is the chain), and the block's population tables are its
chain's.  The rubber band's four proposal reals are [C], its counts
[C, 3]; SPR's counts are [C, 2] and each chain's counter advances by its
own largest draw offset; node age and migration age write each chain's
counter.  The accept counts come back per chain, [C].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gphocs_tpu_torch.kernels.common import (Context, chain_count,
                                             maybe_pmax, per_chain)
from gphocs_tpu_torch.kernels.mig_age import update_mig_ages
from gphocs_tpu_torch.kernels.node_age import update_internal_node_ages
from gphocs_tpu_torch.kernels.spr import update_spr
from gphocs_tpu_torch.kernels.tau import rubber_band_eval_plain
from gphocs_tpu_torch.ops import cuda_lib
from gphocs_tpu_torch.profiling import span
from gphocs_tpu_torch.rng import WhRngState
from gphocs_tpu_torch.rng_fast import MASK32, FastRngState
from gphocs_tpu_torch.state import GenState, Params, SeqData

# loci (warps) per CUDA block, where shared memory allows; the results do
# not depend on it
BLOCK = 8
# keep the conditionals in device memory even where a locus fits in shared
# memory (chip_smoke.py and the tests set it to drive that variant at small
# sizes)
FORCE_COND_IN_DEVICE_MEMORY = False

# kernel launches per wrapper since the last reset_launch_counts()
# (cuda_lib.LAUNCHES, where its entries are described)
LAUNCHES = cuda_lib.LAUNCHES


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class SmemPlan(NamedTuple):
    """A launch's shared-memory plan, as the kernel's plan entry made it."""
    loci_per_block: int
    cond_smem: bool     # the locus's conditionals live in shared memory
    smem_bytes: int     # dynamic shared memory of one block
    static_bytes: int   # the kernel's static shared memory (PopTables)


def plan_for(kernel: str, dt, N: int, M: int, PP: int, B: int, P: int,
             block: int | None = None,
             cond_in_device_memory: bool | None = None) -> SmemPlan:
    """The plan of a kernel (cuda_lib.KERNELS) at real type dt for a state
    of this shape, at BLOCK and FORCE_COND_IN_DEVICE_MEMORY by default."""
    a = cuda_lib.SweepArgs(N=N, M=M, PP=PP, B=B, P=P)
    return _plan_into(a, kernel, _real_suffix(dt), block,
                      cond_in_device_memory)


def _counter_streams(rng, kernel: str) -> None:
    """Refuse the Wichmann-Hill streams: the kernel implements the
    counter-based ones only."""
    if isinstance(rng, WhRngState):
        raise TypeError(f"the {kernel} kernel draws from the counter-based "
                        f"streams; the Wichmann-Hill streams run "
                        f"{kernel}_sweep_plain")


def _check(t: torch.Tensor, name: str, dtype, shape) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if t.shape != shape:  # a torch.Size is a tuple
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


def _chains(params: Params) -> tuple:
    """The leading shape of a per-chain value: () for one chain, (C,) for
    C chains."""
    return params.theta.shape[:-1]


def _args(gen: GenState, params: Params, ctx: Context, seq,
          rng) -> cuda_lib.SweepArgs:
    """SweepArgs with the state inputs filled in and checked."""
    L, N = gen.father.shape
    M = gen.max_migs
    PP = ctx.num_pops
    B = ctx.num_bands
    dt = gen.age.dtype
    i64 = torch.int64
    ch = _chains(params)
    C = ch[0] if ch else 1
    if L % C:
        raise ValueError(f"{L} loci are not {C} chains of equal length")
    for name, v, cap in (("nodes", N, cuda_lib.MAXN),
                         ("populations", PP, cuda_lib.MAXPP),
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
    a.theta = _check(params.theta, "theta", dt, ch + (PP,))
    a.tau = _check(params.tau, "tau", dt, ch + (PP,))
    a.mig_rate = _check(params.mig_rate, "mig_rate", dt, ch + (B,))
    if ctx.popi is None or ctx.popi.device != gen.age.device:
        raise ValueError("the Context carries no integer tables on the "
                         "state's device: build it with make_context")
    A = ctx.num_admixed
    a.popi = _check(ctx.popi, "popi", i64, (PP + 2 * B + PP * PP + 3 * A,))
    if A:
        a.admix_coeff = _check(params.admix_coeff, "admix_coeff", dt,
                               ch + (A,))
    if rng is not None:
        a.key = _check(rng.key, "key", i64, (L,))
        a.ctr = _check(rng.ctr, "ctr", i64, ch)
    a.L, a.N, a.M, a.B, a.PP = L, N, M, B, PP
    a.C, a.Lc, a.A = C, L // C, A
    a.root_pop = ctx.root_pop
    a.oldage = ctx.oldage
    return a


def _plan_into(a: cuda_lib.SweepArgs, kernel: str, real: str,
               block: int | None = None,
               cond_in_device_memory: bool | None = None) -> SmemPlan:
    """Ask the kernel's plan entry, which writes its plan into a."""
    static = cuda_lib.plan(
        kernel, real, a, BLOCK if block is None else block,
        FORCE_COND_IN_DEVICE_MEMORY if cond_in_device_memory is None
        else cond_in_device_memory)
    return SmemPlan(a.block, bool(a.cond_smem), a.smem_bytes, static)


def _scalar(x, dt, device, keep: list, shape=()) -> int:
    """Pointer to x as a contiguous tensor of dtype dt on `device` and of
    `shape` (0-d, or [C] for one value per chain): x itself where it
    already is one, else a copy."""
    if not (isinstance(x, torch.Tensor) and x.dtype == dt
            and x.device == device and x.shape == shape
            and x.is_contiguous()):
        x = torch.as_tensor(x, dtype=dt, device=device)
        x = (x.reshape(shape) if x.numel() == math.prod(shape)
             else x.expand(shape)).contiguous()
    keep.append(x)
    return x.data_ptr()


def _advance(rng: FastRngState, n) -> FastRngState:
    return rng._replace(ctr=(rng.ctr + n) & MASK32)


class Prepared(NamedTuple):
    """A kernel ready to launch: the entry point's name, its arguments, its
    shared-memory plan, its output tensors, and the scratch and scalar
    tensors the arguments point into."""
    entry: str
    args: cuda_lib.SweepArgs
    plan: SmemPlan
    out: dict
    keep: list

    def launch(self, device) -> None:
        cuda_lib.launch(self.entry, self.args,
                        torch.cuda.current_stream(device).cuda_stream)


def prepare_node_age(gen: GenState, params: Params, seq: SeqData,
                     rng: FastRngState, ctx: Context, finetune, lnld, lnp,
                     cond) -> Prepared:
    """Check the inputs of the node-age kernel and allocate its outputs
    (CUDA tensors only)."""
    L, N, P, _ = cond.shape
    dt = gen.age.dtype
    dev = cond.device
    a = _args(gen, params, ctx, seq, rng)
    keep = []
    a.finetune = _scalar(finetune, dt, dev, keep)
    a.lnld_in = _check(lnld, "lnld", dt, (L,))
    a.lnp_in = _check(lnp, "lnp", dt, (L,))
    a.cond_in = _check(cond, "cond", dt, (L, N, P, 4))
    plan = _plan_into(a, "node_age", _real_suffix(dt))
    if not plan.cond_smem:  # the kept rows of a step's root path
        keep.append(torch.empty((L, N - gen.num_samples, P, 4), dtype=dt,
                                device=dev))
        a.prop = keep[-1].data_ptr()
    a.advance = 4 * (gen.num_samples - 1)
    out = {"cond": torch.empty_like(cond), "age": torch.empty_like(gen.age),
           "lnld": torch.empty_like(lnld), "lnp": torch.empty_like(lnp),
           "acc": torch.empty((L,), dtype=torch.int64, device=dev),
           "ctr": torch.empty_like(rng.ctr)}
    for f, t in out.items():
        setattr(a, f + "_out", t.data_ptr())
    return Prepared(f"node_age_{_real_suffix(dt)}", a, plan, out, keep)


def node_age_sweep(gen: GenState, params: Params, seq: SeqData,
                   rng: FastRngState, ctx: Context, finetune, lnld, lnp,
                   cond):
    """Fused node-age sweep (gphocs_tpu's node_age_sweep_pallas).
    Returns (gen, rng, lnld, lnp, cond, acc)."""
    _counter_streams(rng, "node_age")
    if not cuda_lib.on_cuda(gen.age, cond, lnld, lnp, rng.key):
        return update_internal_node_ages(gen, params, seq, rng, ctx,
                                         finetune, lnld, lnp, cond)
    with span("prepare"):
        p = prepare_node_age(gen, params, seq, rng, ctx, finetune, lnld,
                             lnp, cond)
    p.launch(cond.device)
    LAUNCHES["node_age"] += 1
    o = p.out
    return (gen._replace(age=o["age"]), rng._replace(ctr=o["ctr"]),
            o["lnld"], o["lnp"], o["cond"],
            per_chain(o["acc"], chain_count(params)))


def prepare_mig_age(gen: GenState, params: Params, rng: FastRngState,
                    ctx: Context, finetune, lnp) -> Prepared:
    """Check the inputs of the migration-age kernel and allocate its
    outputs (CUDA tensors only)."""
    L = gen.num_loci
    dt = gen.age.dtype
    keep = []
    a = _args(gen, params, ctx, None, rng)
    a.finetune = _scalar(finetune, dt, lnp.device, keep)
    a.lnp_in = _check(lnp, "lnp", dt, (L,))
    plan = _plan_into(a, "mig_age", _real_suffix(dt))
    a.advance = 4 * gen.max_migs
    out = {"mig_age": torch.empty_like(gen.mig_age),
           "lnp": torch.empty_like(lnp),
           "acc": torch.empty((L,), dtype=torch.int64, device=lnp.device),
           "ctr": torch.empty_like(rng.ctr)}
    for f, t in out.items():
        setattr(a, f + "_out", t.data_ptr())
    return Prepared(f"mig_age_{_real_suffix(dt)}", a, plan, out, keep)


def mig_age_sweep(gen: GenState, params: Params, rng: FastRngState,
                  ctx: Context, finetune, lnp):
    """Fused migration-age sweep (gphocs_tpu's mig_age_sweep_pallas).
    Returns (gen, rng, lnp, acc)."""
    _counter_streams(rng, "mig_age")
    if not cuda_lib.on_cuda(gen.age, lnp, rng.key):
        return update_mig_ages(gen, params, rng, ctx, finetune, lnp)
    if ctx.num_bands == 0:
        return gen, rng, lnp, torch.zeros(_chains(params), dtype=torch.int64,
                                          device=lnp.device)
    with span("prepare"):
        p = prepare_mig_age(gen, params, rng, ctx, finetune, lnp)
    p.launch(lnp.device)
    LAUNCHES["mig_age"] += 1
    o = p.out
    return (gen._replace(mig_age=o["mig_age"]), rng._replace(ctr=o["ctr"]),
            o["lnp"], per_chain(o["acc"], chain_count(params)))


def prepare_rubber_band(gen: GenState, params: Params, seq: SeqData,
                        ctx: Context, pop: int, is_sample_age: bool,
                        taub0, taub1, tauold, taunew, cond) -> Prepared:
    """Check the inputs of the rubber-band kernel and allocate its outputs
    (CUDA tensors only).  `stat` = int32 [ntj0, ntj1, conflicts], summed
    over the valid loci by the kernel ([C, 3]: each chain's)."""
    L, N, P, _ = cond.shape
    dt = gen.age.dtype
    dev = cond.device
    keep = []
    # tau mode: the kernel puts taunew in place of tau[pop] and derives the
    # proposal's pop_end and band windows; a sample-age move leaves them
    a = _args(gen, params, ctx, seq, None)
    ch = _chains(params)
    for f, x in (("taub0", taub0), ("taub1", taub1), ("tauold", tauold),
                 ("taunew", taunew)):
        setattr(a, f, _scalar(x, dt, dev, keep, ch))
    a.pop = int(pop)
    a.is_root = int(pop == ctx.root_pop and not is_sample_age)
    a.sample_age = int(is_sample_age)
    a.cond_in = _check(cond, "cond", dt, (L, N, P, 4))
    plan = _plan_into(a, "rubber_band", _real_suffix(dt))
    out = {"cond": torch.empty_like(cond), "age": torch.empty_like(gen.age),
           "mig_age": torch.empty_like(gen.mig_age),
           "lnld": torch.empty((L,), dtype=dt, device=dev),
           "lnp": torch.empty((L,), dtype=dt, device=dev),
           "stat": torch.zeros(ch + (3,), dtype=torch.int32, device=dev)}
    a.cond_out = out["cond"].data_ptr()
    a.age_out, a.mig_age_out = out["age"].data_ptr(), out["mig_age"].data_ptr()
    a.lnld_out, a.lnp_out = out["lnld"].data_ptr(), out["lnp"].data_ptr()
    a.stat = out["stat"].data_ptr()
    return Prepared(f"rubber_band_{_real_suffix(dt)}", a, plan, out, keep)


def rubber_band_eval(gen: GenState, params: Params, seq: SeqData,
                     ctx: Context, pop: int, is_sample_age: bool,
                     taub0, taub1, tauold, taunew, cond):
    """Evaluate one population's rubber-band proposal for every locus
    (gphocs_tpu's rubber_band_eval_pallas).  With is_sample_age, `pop` is a
    current population and the proposal moves its sample age; otherwise it
    is an ancestral population and the proposal moves its tau.  Returns
    (age_prop, mag_prop, cond_prop, lnld_prop, lnp_prop, ntj0 [], ntj1 [],
    any_conflict []), the last three [C] for C chains."""
    is_sample_age = bool(is_sample_age)
    if not cuda_lib.on_cuda(gen.age, cond):
        return rubber_band_eval_plain(gen, params, seq, ctx, pop,
                                      is_sample_age, taub0, taub1, tauold,
                                      taunew, cond)
    with span("prepare"):
        p = prepare_rubber_band(gen, params, seq, ctx, pop, is_sample_age,
                                taub0, taub1, tauold, taunew, cond)
    p.launch(cond.device)
    LAUNCHES["rubber_band_sample_age" if is_sample_age
             else "rubber_band"] += 1
    o = p.out
    ntj = o["stat"][..., :2].to(gen.age.dtype)
    return (o["age"], o["mig_age"], o["cond"], o["lnld"], o["lnp"],
            ntj[..., 0], ntj[..., 1], o["stat"][..., 2] > 0)


def prepare_spr(gen: GenState, params: Params, seq: SeqData,
                rng: FastRngState, ctx: Context, lnld, cond) -> Prepared:
    """Check the inputs of the SPR kernel and allocate its outputs (CUDA
    tensors only).  `stat` = int32 [accepts, largest draw offset] ([C, 2]:
    each chain's)."""
    L, N, P, _ = cond.shape
    dt = gen.age.dtype
    dev = cond.device
    a = _args(gen, params, ctx, seq, rng)
    a.lnld_in = _check(lnld, "lnld", dt, (L,))
    a.cond_in = _check(cond, "cond", dt, (L, N, P, 4))
    plan = _plan_into(a, "spr", _real_suffix(dt))
    out = {f: torch.empty_like(getattr(gen, f))
           for f in ("age", "lson", "rson", "father", "node_pop", "root",
                     "mig_branch", "mig_band", "mig_age")}
    for f, t in out.items():
        setattr(a, f + "_out", t.data_ptr())
    out["cond"] = torch.empty_like(cond)
    out["lnld"] = torch.empty_like(lnld)
    out["stat"] = torch.zeros(_chains(params) + (2,), dtype=torch.int32,
                              device=dev)
    keep = []
    if not plan.cond_smem:  # the proposal copy of the conditionals
        keep.append(torch.empty_like(cond))
        a.prop = keep[0].data_ptr()
    a.cond_out, a.lnld_out = out["cond"].data_ptr(), out["lnld"].data_ptr()
    a.stat = out["stat"].data_ptr()
    return Prepared(f"spr_{_real_suffix(dt)}", a, plan, out, keep)


def spr_sweep(gen: GenState, params: Params, seq: SeqData,
              rng: FastRngState, ctx: Context, lnld, cond, loci_axis=None):
    """Fused SPR sweep (gphocs_tpu's spr_sweep_pallas; with admixed
    leaves, the semantics of its XLA update_spr, which the Pallas kernel
    leaves out).  Returns (gen, rng, lnld, cond, acc), acc the rank's own
    on a loci mesh (`loci_axis`), where the counter advances by the
    largest draw offset over all ranks (sweeps_pallas.py:2011-2014)."""
    _counter_streams(rng, "spr")
    if not cuda_lib.on_cuda(gen.age, cond, lnld, rng.key):
        return update_spr(gen, params, seq, rng, ctx, lnld, cond,
                          sync_group=gen.num_loci, loci_axis=loci_axis)
    with span("prepare"):
        p = prepare_spr(gen, params, seq, rng, ctx, lnld, cond)
    p.launch(cond.device)
    LAUNCHES["spr"] += 1
    o = p.out
    stat = o["stat"].to(torch.int64)
    moved = {f: o[f] for f in o if f not in ("cond", "lnld", "stat")}
    return (gen._replace(**moved),
            _advance(rng, maybe_pmax(stat[..., 1], loci_axis)), o["lnld"],
            o["cond"], stat[..., 0])


def node_age_sweep_plain(gen: GenState, params: Params, seq: SeqData, rng,
                         ctx: Context, finetune, lnld, lnp, cond):
    """The conformance mode's node-age sweep: the plain version on the
    state's device, with gphocs_tpu's masked Wichmann-Hill draws
    (kernels/node_age.py).  Returns node_age_sweep's outputs."""
    LAUNCHES["node_age_plain"] += 1
    return update_internal_node_ages(gen, params, seq, rng, ctx, finetune,
                                     lnld, lnp, cond)


def mig_age_sweep_plain(gen: GenState, params: Params, rng, ctx: Context,
                        finetune, lnp):
    """The conformance mode's migration-age sweep (kernels/mig_age.py on
    the state's device)."""
    LAUNCHES["mig_age_plain"] += 1
    return update_mig_ages(gen, params, rng, ctx, finetune, lnp)


def spr_sweep_plain(gen: GenState, params: Params, seq: SeqData, rng,
                    ctx: Context, lnld, cond):
    """The conformance mode's SPR sweep (kernels/spr.py on the state's
    device: gphocs_tpu's XLA update_spr draw for draw)."""
    LAUNCHES["spr_plain"] += 1
    return update_spr(gen, params, seq, rng, ctx, lnld, cond,
                      sync_group=gen.num_loci)

