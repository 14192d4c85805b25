"""The CUDA sources of gphocs_tpu_torch (csrc/*.cu), compiled for the host
with a C++ compiler, against their plain PyTorch versions at f64.

tests/cuda_host/cuda_runtime.h stands in for the CUDA runtime.  The loci
run one after another, each as one "warp" whose single lane runs every
index of a lane section in a plain loop, with the block's shared memory an
ordinary buffer.  SPR is held against update_spr(sync_group=1),
the card's schedule.  A second build runs the lane loops backwards: a
section that reads what another lane of it writes then gives another
result.  The kernels are reached through the wrappers in ops/sweeps.py, so
the SweepArgs layout shared by ctypes and C++ and the shared-memory plan
are checked too.  The counter streams' draw kernel (counter_draw.cu, a
plain grid whose threads the stand-in runs one after another) is reached
through rng_fast.py's CUDA route and held bitwise against its ATen chain.
No GPU is needed; the tests skip without a C++ compiler.
"""

import ctypes
import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

from chip_smoke import (F64_TOL, Compare, admix_checks, kernel_checks,
                        padded_state, sample_age_bounds, sample_age_checks,
                        tau_bounds, warm_state)
from gphocs_tpu_torch.kernels.common import band_windows, pop_end
from gphocs_tpu_torch.kernels.mig_age import update_mig_ages
from gphocs_tpu_torch.kernels.node_age import update_internal_node_ages
from gphocs_tpu_torch.kernels.spr import update_spr
from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import (ADMIX_AGE_CTL, S32_CTL,
                                             SAMPLE_AGE_CTL, WIDE_CTL)
from gphocs_tpu_torch.io.simulate import simulate_seq_file
from gphocs_tpu_torch.kernels.common import gen_log_prior
from gphocs_tpu_torch.model import build_poptree
from gphocs_tpu_torch.rng_host import HostRng
from gphocs_tpu_torch.sampler.driver import Sampler
from gphocs_tpu_torch.sampler.init import sample_pop_parameters
from gphocs_tpu_torch.kernels.tau import (rubber_band_eval_plain,
                                          update_sample_ages_fused,
                                          update_taus, update_taus_fused)
from gphocs_tpu_torch.ops import cuda_lib, sweeps

from chip_smoke import (DRAW_BATCHES, DRAW_LAYOUTS, SAMPLE_AGE_STEPS,
                        draw_outputs, draw_streams, sweep_launches)
from gphocs_tpu_torch import rng_fast as RF

SHIM = Path(__file__).resolve().parent / "cuda_host"

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)


def _build(cxx, out, *flags):
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         *flags, f"-I{SHIM}", f"-I{cuda_lib.CSRC}", "-x", "c++",
         *(str(cuda_lib.CSRC / s) for s in cuda_lib.SOURCES),
         str(SHIM / "pop_tables_probe.cu"), "-o", str(out)],
        check=True, capture_output=True, timeout=300)
    lib = cuda_lib.bind(ctypes.CDLL(str(out)))
    lib.pop_tables_probe_f64.argtypes = [ctypes.POINTER(cuda_lib.SweepArgs),
                                         ctypes.c_int, ctypes.c_void_p]
    lib.pop_tables_probe_f64.restype = None
    return lib


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The kernels built for the host twice: lane loops forwards
    ("forward") and backwards ("reverse")."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    return {"forward": _build(cxx, d / "libsweeps_host.so"),
            "reverse": _build(cxx, d / "libsweeps_host_rev.so",
                              "-DSWEEP_REVERSE_LANES")}


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """A warmed 24-locus f64 state with a hot band (plain versions only),
    made as chip_smoke.py makes its 64-locus one."""
    path = str(tmp_path_factory.mktemp("csrc_seq") / "seqs.txt")
    return warm_state(torch.device("cpu"), torch.float64, path, num_loci=24)


@pytest.fixture(scope="module")
def warm_sample_age(tmp_path_factory):
    """The same on SAMPLE_AGE_CTL: population D has an estimated sample
    age, and the hot band D->B gives it migration events."""
    path = str(tmp_path_factory.mktemp("csrc_seq_age") / "seqs.txt")
    return warm_state(torch.device("cpu"), torch.float64, path, num_loci=24,
                      ctl=SAMPLE_AGE_CTL)


@pytest.fixture(scope="module")
def warm_wide(tmp_path_factory):
    """12 loci x 16,000 bp of WIDE_CTL: N = 31 nodes, so the SPR grid has
    K = 51 entries, and more than 8 patterns, so a node's P x 4
    conditionals are more than 32 values: every lane loop wraps."""
    path = str(tmp_path_factory.mktemp("csrc_seq_wide") / "seqs.txt")
    s = warm_state(torch.device("cpu"), torch.float64, path, num_loci=12,
                   ctl=WIDE_CTL, seq_len=16000)
    L, N, P, _ = s.cond.shape
    assert 4 * P > 32 and N + s.gen.max_migs + s.ctx.num_pops + 3 > 32
    return s


@pytest.fixture(scope="module")
def s32_bucket(tmp_path_factory):
    """The larger-pattern bucket of a 2-bucket S32_CTL state (32 samples:
    N = 63 nodes, the kernels' MAXN), 2 loci x 1,500 bp of diverse data
    (theta and tau 20 times a prior draw), so P is over a hundred and no
    locus's conditionals fit in shared memory; the band made hot and one
    SPR sweep taken, so that migration events exist."""
    d = tmp_path_factory.mktemp("csrc_s32")
    ctl = S32_CTL.format(seq=d / "seqs.txt", trace=d / "trace.log")
    cfg = parse_control_text(ctl)
    tree = build_poptree(cfg)
    tp = sample_pop_parameters(tree, HostRng(5, 7))
    tp = tp._replace(theta=tp.theta * 20, tau=tp.tau * 20)
    simulate_seq_file(cfg, tree, str(d / "seqs.txt"), num_loci=4,
                      seq_len=[150, 150, 1500, 1500], seed=29, params=tp)
    cfg = parse_control_text(ctl)
    cfg.mcmc.random_seed = 17
    s = Sampler(cfg, device="cpu", buckets=2)
    s.initialize()
    s.params = s.params._replace(
        mig_rate=torch.full_like(s.params.mig_rate, 2e5))
    seq = s.seqs[1]
    g, lrng, lnld, cond, _ = update_spr(s.gens[1], s.params, seq,
                                        s.lrngs[1], s.ctx, s.lnlds[1],
                                        s.conds[1])
    assert int((g.mig_branch >= 0).sum()) > 0
    return types.SimpleNamespace(
        gen=g, params=s.params, seq=seq, ctx=s.ctx, ft=s.ft, lrng=lrng,
        tree=s.tree, cond=cond, lnld=lnld,
        lnp=gen_log_prior(g, s.params, s.ctx))


def _route(monkeypatch, lib, block=None, cond_in_device_memory=False):
    """Route the ops/sweeps wrappers and rng_fast's draws to a host build
    for CPU tensors."""
    monkeypatch.setattr(cuda_lib, "on_cuda", lambda *tensors: True)
    monkeypatch.setattr(cuda_lib, "_LIB", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    if block is not None:
        monkeypatch.setattr(sweeps, "BLOCK", block)
    monkeypatch.setattr(sweeps, "FORCE_COND_IN_DEVICE_MEMORY",
                        cond_in_device_memory)
    sweeps.reset_launch_counts()


@pytest.fixture
def kernels_on_host(host_libs, monkeypatch):
    _route(monkeypatch, host_libs["forward"])


def _close(a, b, tol):
    assert float((a - b).abs().max()) <= tol


def test_node_age_kernel_matches_plain(warm, kernels_on_host):
    s = warm
    args = (s.gen, s.params, s.seq, s.lrng, s.ctx, s.ft.coal_time, s.lnld,
            s.lnp, s.cond)
    k = sweeps.node_age_sweep(*args)
    q = update_internal_node_ages(*args)
    assert sweeps.LAUNCHES["node_age"] == 1
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[5]) == int(q[5]) > 0
    _close(k[0].age, q[0].age, 1e-12)
    _close(k[2], q[2], 1e-9)
    _close(k[3], q[3], 1e-9)
    _close(k[4], q[4], 1e-10)


def test_mig_age_kernel_matches_plain(warm, kernels_on_host):
    s = warm
    args = (s.gen, s.params, s.lrng, s.ctx, s.ft.mig_time, s.lnp)
    k = sweeps.mig_age_sweep(*args)
    q = update_mig_ages(*args)
    assert sweeps.LAUNCHES["mig_age"] == 1
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[3]) == int(q[3]) > 0
    _close(k[0].mig_age, q[0].mig_age, 1e-12)
    _close(k[2], q[2], 1e-9)


def test_spr_kernel_matches_plain(warm, kernels_on_host):
    s = warm
    args = (s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld, s.cond)
    k = sweeps.spr_sweep(*args)
    q = update_spr(*args, sync_group=1)
    assert sweeps.LAUNCHES["spr"] == 1
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[4]) == int(q[4]) > 0
    for f in ("father", "lson", "rson", "root", "node_pop", "mig_branch",
              "mig_band"):
        assert torch.equal(getattr(k[0], f), getattr(q[0], f)), f
    _close(k[0].age, q[0].age, 1e-12)
    _close(k[0].mig_age, q[0].mig_age, 1e-12)
    _close(k[2], q[2], 1e-9)
    _close(k[3], q[3], 1e-10)


def test_rubber_band_kernel_matches_plain(warm, kernels_on_host):
    s = warm
    pr, c = s.params, s.ctx
    for pop in range(s.tree.num_cur_pops, s.tree.num_pops):
        b = tau_bounds(s, pop)
        k = sweeps.rubber_band_eval(s.gen, pr, s.seq, c, pop, False, *b,
                                    s.cond)
        q = rubber_band_eval_plain(s.gen, pr, s.seq, c, pop, False, *b,
                                   s.cond)
        assert float(k[5]) == float(q[5]) and float(k[6]) == float(q[6])
        assert bool(k[7]) == bool(q[7])
        _close(k[0], q[0], 1e-12)
        _close(k[1], q[1], 1e-12)
        _close(k[2], q[2], 1e-10)
        _close(k[3], q[3], 1e-9)
        _close(k[4], q[4], 1e-9)
    args = (s.gen, pr, s.seq, s.grng, c, s.ft.taus, s.lnld, s.lnp, s.cond,
            s.tree.num_pops, s.tree.num_cur_pops)
    k = update_taus_fused(*args)
    q = update_taus(*args)
    assert torch.equal(k[6], q[6]) and int(k[2].ctr) == int(q[2].ctr)
    _close(k[1].tau, q[1].tau, 1e-15)
    assert sweeps.LAUNCHES["rubber_band"] == 2 * (s.tree.num_pops
                                                  - s.tree.num_cur_pops)


@pytest.mark.parametrize("step, conflict", [
    (-0.5, True), (-0.2, False), (0.05, False), (0.3, True)])
def test_rubber_band_sample_age_kernel_matches_plain(warm_sample_age,
                                                     kernels_on_host, step,
                                                     conflict):
    """The kernel's sample-age mode (and the `sample_age` field of
    SweepArgs) against the plain version, for a new age below the old one
    and above it.  On this seeded fixture the two larger steps push a
    migration event of D below its branch's node or out of the band's
    window, so both outcomes of the conflict scan are covered."""
    s = warm_sample_age
    pop = 3
    assert bool(s.tree.update_sample_age[pop])
    b = sample_age_bounds(s, pop, step)
    k = sweeps.rubber_band_eval(s.gen, s.params, s.seq, s.ctx, pop, True, *b,
                                s.cond)
    q = rubber_band_eval_plain(s.gen, s.params, s.seq, s.ctx, pop, True, *b,
                               s.cond)
    assert sweeps.LAUNCHES == {"node_age": 0, "mig_age": 0, "rubber_band": 0,
                               "rubber_band_sample_age": 1, "spr": 0,
                               "node_age_plain": 0, "mig_age_plain": 0,
                               "spr_plain": 0, "rng_draw": 0}
    assert float(k[5]) == float(q[5]) and float(k[6]) == float(q[6])
    assert float(k[5]) + float(k[6]) > 0
    assert bool(k[7]) == bool(q[7]) == conflict
    _close(k[0], q[0], 1e-12)
    _close(k[1], q[1], 1e-12)
    _close(k[2], q[2], 1e-10)
    _close(k[3], q[3], 1e-9)
    _close(k[4], q[4], 1e-9)
    S = s.gen.num_samples
    in_pop = s.gen.node_pop[:, :S] == pop
    assert bool((k[0][:, :S][in_pop] == b[3]).all())
    assert not torch.equal(k[0], s.gen.age)


def test_sample_age_sweep_through_kernel(warm_sample_age, kernels_on_host,
                                         monkeypatch):
    """update_sample_ages_fused through the compiled kernel against the
    same sweep through the plain version (the wrapper on CPU tensors)."""
    s = warm_sample_age
    mask = [bool(x) for x in s.tree.update_sample_age[:s.tree.num_cur_pops]]
    args = (s.gen, s.params, s.seq, s.grng, s.ctx, s.ft.taus, s.lnld, s.lnp,
            s.cond, s.tree.num_cur_pops, mask)
    k = update_sample_ages_fused(*args)
    assert sweeps.LAUNCHES["rubber_band_sample_age"] == 1
    monkeypatch.setattr(cuda_lib, "on_cuda", lambda *tensors: False)
    q = update_sample_ages_fused(*args)
    assert sweeps.LAUNCHES["rubber_band_sample_age"] == 1
    assert torch.equal(k[6], q[6]) and int(k[2].ctr) == int(q[2].ctr)
    assert int(k[7]) == int(q[7])
    _close(k[1].sample_age, q[1].sample_age, 1e-15)
    _close(k[0].age, q[0].age, 1e-12)
    _close(k[3], q[3], 1e-9)
    _close(k[4], q[4], 1e-9)


# ---- lanes, blocks, shared memory -----------------------------------------

def _flat(out):
    """The tensors of a wrapper's result, GenState fields included."""
    flat = []
    for x in out:
        if isinstance(x, torch.Tensor):
            flat.append(x)
        elif isinstance(x, tuple):
            flat += [y for y in x if isinstance(y, torch.Tensor)]
    return flat


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb) > 4
    for x, y in zip(fa, fb):
        assert torch.equal(x, y)


def _call(which, warm, warm_sample_age):
    """One wrapper call of a kernel on its fixture."""
    if which == "node_age":
        s = warm
        return sweeps.node_age_sweep(s.gen, s.params, s.seq, s.lrng, s.ctx,
                                     s.ft.coal_time, s.lnld, s.lnp, s.cond)
    if which == "mig_age":
        s = warm
        return sweeps.mig_age_sweep(s.gen, s.params, s.lrng, s.ctx,
                                    s.ft.mig_time, s.lnp)
    if which == "spr":
        s = warm
        return sweeps.spr_sweep(s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld,
                                s.cond)
    if which == "rubber_band":
        s = warm
        pop = s.tree.num_pops - 2
        return sweeps.rubber_band_eval(s.gen, s.params, s.seq, s.ctx, pop,
                                       False, *tau_bounds(s, pop), s.cond)
    s = warm_sample_age
    return sweeps.rubber_band_eval(s.gen, s.params, s.seq, s.ctx, 3, True,
                                   *sample_age_bounds(s, 3, -0.2), s.cond)


WARP_KERNELS = ("node_age", "mig_age", "spr", "rubber_band",
                "rubber_band_sample_age")
# those that hold conditionals (migration age is prior arithmetic only)
COND_KERNELS = tuple(k for k in WARP_KERNELS if k != "mig_age")


@pytest.mark.parametrize("which", WARP_KERNELS)
def test_reversed_lanes_give_equal_outputs(which, warm, warm_sample_age,
                                           host_libs, monkeypatch):
    """No lane section reads what another lane of it writes: the build
    with the lane loops run backwards gives the same bits."""
    _route(monkeypatch, host_libs["forward"])
    fwd = _call(which, warm, warm_sample_age)
    _route(monkeypatch, host_libs["reverse"])
    rev = _call(which, warm, warm_sample_age)
    assert sweeps.LAUNCHES[which] == 1
    _same(fwd, rev)


@pytest.mark.parametrize("which", WARP_KERNELS)
def test_loci_per_block_do_not_change_outputs(which, warm, warm_sample_age,
                                              host_libs, monkeypatch):
    """Blocks of 8 loci and of 5 (24 loci: the last block partial) give
    equal bits, lnp and the SPR draw schedule included."""
    _route(monkeypatch, host_libs["forward"], block=8)
    a = _call(which, warm, warm_sample_age)
    _route(monkeypatch, host_libs["forward"], block=5)
    b = _call(which, warm, warm_sample_age)
    _same(a, b)


@pytest.mark.parametrize("which", COND_KERNELS)
def test_conditionals_in_device_memory_equal_shared(which, warm,
                                                    warm_sample_age,
                                                    host_libs, monkeypatch):
    """The variant for loci too large for shared memory (the kernel works
    on the output buffers) equals the shared-memory one."""
    _route(monkeypatch, host_libs["forward"])
    a = _call(which, warm, warm_sample_age)
    _route(monkeypatch, host_libs["forward"], cond_in_device_memory=True)
    b = _call(which, warm, warm_sample_age)
    _same(a, b)


@pytest.mark.parametrize("build", ["forward", "reverse"])
def test_wide_fixture_matches_plain(build, warm_wide, host_libs,
                                    monkeypatch):
    """N = 31, K = 51, N + M > 32 and 4 P > 32: every kernel against its
    plain version where every lane loop takes more than one turn."""
    s = warm_wide
    _route(monkeypatch, host_libs[build], block=5)
    # 15 levels of the x4 rescale: the root's conditionals are ~1e9
    scale = float(s.cond.abs().max())
    args = (s.gen, s.params, s.seq, s.lrng, s.ctx, s.ft.coal_time, s.lnld,
            s.lnp, s.cond)
    k = sweeps.node_age_sweep(*args)
    q = update_internal_node_ages(*args)
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[5]) == int(q[5]) > 0
    _close(k[0].age, q[0].age, 1e-12)
    _close(k[2], q[2], 1e-9)
    _close(k[3], q[3], 1e-9)
    _close(k[4] / scale, q[4] / scale, 1e-10)
    args = (s.gen, s.params, s.lrng, s.ctx, s.ft.mig_time, s.lnp)
    k = sweeps.mig_age_sweep(*args)
    q = update_mig_ages(*args)
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[3]) == int(q[3]) > 0
    _close(k[0].mig_age, q[0].mig_age, 1e-12)
    _close(k[2], q[2], 1e-9)
    args = (s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld, s.cond)
    k = sweeps.spr_sweep(*args)
    q = update_spr(*args, sync_group=1)
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[4]) == int(q[4]) > 0
    for f in ("father", "lson", "rson", "root", "node_pop", "mig_branch",
              "mig_band"):
        assert torch.equal(getattr(k[0], f), getattr(q[0], f)), f
    _close(k[0].age, q[0].age, 1e-12)
    _close(k[0].mig_age, q[0].mig_age, 1e-12)
    _close(k[2], q[2], 1e-9)
    _close(k[3] / scale, q[3] / scale, 1e-10)
    for pop in range(s.tree.num_cur_pops, s.tree.num_pops):
        b = tau_bounds(s, pop)
        k = sweeps.rubber_band_eval(s.gen, s.params, s.seq, s.ctx, pop,
                                    False, *b, s.cond)
        q = rubber_band_eval_plain(s.gen, s.params, s.seq, s.ctx, pop, False,
                                   *b, s.cond)
        assert float(k[5]) == float(q[5]) and float(k[6]) == float(q[6])
        assert bool(k[7]) == bool(q[7])
        _close(k[0], q[0], 1e-12)
        _close(k[1], q[1], 1e-12)
        _close(k[2] / scale, q[2] / scale, 1e-10)
        _close(k[3], q[3], 1e-9)
        _close(k[4], q[4], 1e-9)


@pytest.mark.parametrize("build", ["forward", "reverse"])
def test_s32_bucket_matches_plain(build, s32_bucket, host_libs, monkeypatch):
    """N = 63 and P over a hundred, the conditionals in device memory
    (chosen by the plan entry, not forced): every kernel against its plain
    version, with the lane loops forwards and backwards."""
    s = s32_bucket
    L, N, P, _ = s.cond.shape
    assert N == 63 and P > 100
    _route(monkeypatch, host_libs[build])
    for kernel in ("node_age", "rubber_band", "spr"):
        assert not sweeps.plan_for(kernel, torch.float64, N, s.gen.max_migs,
                                   s.ctx.num_pops, s.ctx.num_bands,
                                   P).cond_smem, kernel
    scale = float(s.cond.abs().max())  # 31 levels of the x4 rescale
    args = (s.gen, s.params, s.seq, s.lrng, s.ctx, s.ft.coal_time, s.lnld,
            s.lnp, s.cond)
    k = sweeps.node_age_sweep(*args)
    q = update_internal_node_ages(*args)
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[5]) == int(q[5]) > 0
    _close(k[0].age, q[0].age, 1e-12)
    _close(k[2], q[2], 1e-9)
    _close(k[3], q[3], 1e-9)
    _close(k[4] / scale, q[4] / scale, 1e-10)
    args = (s.gen, s.params, s.lrng, s.ctx, s.ft.mig_time, s.lnp)
    k = sweeps.mig_age_sweep(*args)
    q = update_mig_ages(*args)
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[3]) == int(q[3]) > 0
    _close(k[0].mig_age, q[0].mig_age, 1e-12)
    _close(k[2], q[2], 1e-9)
    args = (s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld, s.cond)
    k = sweeps.spr_sweep(*args)
    q = update_spr(*args, sync_group=1)
    assert int(k[1].ctr) == int(q[1].ctr)
    assert int(k[4]) == int(q[4]) > 0
    for f in ("father", "lson", "rson", "root", "node_pop", "mig_branch",
              "mig_band"):
        assert torch.equal(getattr(k[0], f), getattr(q[0], f)), f
    _close(k[0].age, q[0].age, 1e-12)
    _close(k[0].mig_age, q[0].mig_age, 1e-12)
    _close(k[2], q[2], 1e-9)
    _close(k[3] / scale, q[3] / scale, 1e-10)
    pop = s.tree.num_pops - 1
    b = tau_bounds(s, pop)
    k = sweeps.rubber_band_eval(s.gen, s.params, s.seq, s.ctx, pop, False,
                                *b, s.cond)
    q = rubber_band_eval_plain(s.gen, s.params, s.seq, s.ctx, pop, False, *b,
                               s.cond)
    assert float(k[5]) == float(q[5]) > 0 and float(k[6]) == float(q[6])
    assert bool(k[7]) == bool(q[7])
    _close(k[0], q[0], 1e-12)
    _close(k[1], q[1], 1e-12)
    _close(k[2] / scale, q[2] / scale, 1e-10)
    _close(k[3], q[3], 1e-9)
    _close(k[4], q[4], 1e-9)
    # the plain versions' draws take the host build's draw kernel too
    assert sweep_launches(sweeps.LAUNCHES) == {
        "node_age": 1, "mig_age": 1, "spr": 1, "rubber_band": 1,
        "rubber_band_sample_age": 0, "node_age_plain": 0, "mig_age_plain": 0,
        "spr_plain": 0}


def test_counts_are_summed_over_the_valid_loci(warm, kernels_on_host):
    """The kernels' integer sums (Jacobian counts, conflicts, accepts)
    leave out the padding loci, as the plain versions' masked sums do, and
    a sweep leaves a padding locus as it was."""
    s = warm
    valid = s.gen.valid.clone()
    valid[::3] = False
    g = s.gen._replace(valid=valid)
    pop = s.tree.num_pops - 1
    b = tau_bounds(s, pop)
    full = sweeps.rubber_band_eval(s.gen, s.params, s.seq, s.ctx, pop, False,
                                   *b, s.cond)
    k = sweeps.rubber_band_eval(g, s.params, s.seq, s.ctx, pop, False, *b,
                                s.cond)
    q = rubber_band_eval_plain(g, s.params, s.seq, s.ctx, pop, False, *b,
                               s.cond)
    assert float(k[5]) == float(q[5]) and float(k[6]) == float(q[6])
    assert 0 < float(k[5]) + float(k[6]) < float(full[5]) + float(full[6])
    assert bool(k[7]) == bool(q[7])
    assert bool((k[4][~valid] == 0).all())
    args = (g, s.params, s.seq, s.lrng, s.ctx, s.lnld, s.cond)
    k = sweeps.spr_sweep(*args)
    q = update_spr(*args, sync_group=1)
    assert int(k[4]) == int(q[4]) > 0
    assert int(k[1].ctr) == int(q[1].ctr)
    assert torch.equal(k[0].father, q[0].father)
    assert torch.equal(k[0].father[~valid], s.gen.father[~valid])
    args = (g, s.params, s.seq, s.lrng, s.ctx, s.ft.coal_time, s.lnld, s.lnp,
            s.cond)
    full = sweeps.node_age_sweep(s.gen, *args[1:])
    k = sweeps.node_age_sweep(*args)
    q = update_internal_node_ages(*args)
    assert 0 < int(k[5]) == int(q[5]) < int(full[5])
    assert torch.equal(k[0].age[~valid], s.gen.age[~valid])
    assert torch.equal(k[2][~valid], s.lnld[~valid])
    assert torch.equal(k[3][~valid], s.lnp[~valid])
    assert torch.equal(k[4][~valid], s.cond[~valid])
    assert not torch.equal(k[0].age[valid], s.gen.age[valid])
    args = (g, s.params, s.lrng, s.ctx, s.ft.mig_time, s.lnp)
    full = sweeps.mig_age_sweep(s.gen, *args[1:])
    k = sweeps.mig_age_sweep(*args)
    q = update_mig_ages(*args)
    assert 0 < int(k[3]) == int(q[3]) < int(full[3])
    assert torch.equal(k[0].mig_age[~valid], s.gen.mig_age[~valid])
    assert torch.equal(k[2][~valid], s.lnp[~valid])
    assert not torch.equal(k[0].mig_age[valid], s.gen.mig_age[valid])


@pytest.mark.parametrize("proposal", [False, True])
def test_in_kernel_pop_tables_match_plain(proposal, warm, host_libs):
    """pop_end and the band windows as the kernels' prologue derives them
    from tau, against kernels/common.py, on the state's tau and on a tau
    that collapses the band (start >= end); with `proposal`, taunew stands
    in for tau[pop]."""
    s = warm
    c = s.ctx
    PP, B = c.num_pops, c.num_bands
    src, tgt = int(c.band_source[0]), int(c.band_target[0])
    collapsed = s.params.tau.clone()
    collapsed[src] = collapsed[c.father_pop[tgt]] * 2.0
    pop = PP - 2
    taunew = s.params.tau[pop] * 1.25
    for tau in (s.params.tau, collapsed):
        want_tau = tau.clone()
        if proposal:
            want_tau[pop] = taunew
        bs, be = band_windows(c, want_tau)
        if tau is collapsed:
            assert bool((bs >= be).all())
        a = cuda_lib.SweepArgs()
        a.theta, a.tau = s.params.theta.data_ptr(), tau.data_ptr()
        a.mig_rate, a.popi = s.params.mig_rate.data_ptr(), c.popi.data_ptr()
        a.taunew = taunew.data_ptr()
        a.PP, a.B, a.pop, a.oldage = PP, B, pop, c.oldage
        out = torch.empty(3 * PP + 3 * B, dtype=torch.float64)
        host_libs["forward"].pop_tables_probe_f64(ctypes.byref(a),
                                                  int(proposal),
                                                  out.data_ptr())
        want = torch.cat([s.params.theta, want_tau, pop_end(c, want_tau), bs,
                          be, s.params.mig_rate])
        assert torch.equal(out, want)


def test_smem_plan(host_libs, monkeypatch):
    """The shared-memory budget, as the kernels' plan entries (csrc/) make
    it: loci per block, where the conditionals live, and a raise where one
    locus's tables do not fit."""
    _route(monkeypatch, host_libs["forward"])
    # what sweeps_common.cuh leaves for the loci: SMEM_LIMIT less the
    # static reserve
    limit = 232448 - 1024

    def smem_plan(kernel, N, M, PP, B, P, itemsize, block,
                  cond_in_device_memory=False):
        dt = {4: torch.float32, 8: torch.float64}[itemsize]
        return sweeps.plan_for(kernel, dt, N, M, PP, B, P, block,
                               cond_in_device_memory)

    # the standard workload: N = 15, M = 10, PP = 7, B = 1, P = 6
    for kernel in ("node_age", "mig_age", "spr", "rubber_band"):
        for itemsize in (4, 8):
            p = smem_plan(kernel, 15, 10, 7, 1, 6, itemsize, 8)
            assert p.loci_per_block == 8 and p.cond_smem
            assert p.smem_bytes % (16 * 8) == 0 and p.smem_bytes < 96 * 1024
    # node age: tables 108 reals + 86 ints; its conditionals in place with
    # the kept rows of a root path, (15 + 7) * 24 reals: under 48 KB at f64
    na = smem_plan("node_age", 15, 10, 7, 1, 6, 4, 8)
    assert na.smem_bytes == 8 * -(-((108 + 528) * 4 + 86 * 4) // 16) * 16
    assert smem_plan("node_age", 15, 10, 7, 1, 6, 8,
                     8).smem_bytes < 48 * 1024
    forced = smem_plan("node_age", 15, 10, 7, 1, 6, 4, 8, True)
    assert not forced.cond_smem and forced.smem_bytes < na.smem_bytes
    assert not smem_plan("node_age", 63, 32, 16, 8, 300, 8,
                         8).cond_smem
    # migration age holds no conditionals: 272 reals + 45 ints whatever P
    ma = smem_plan("mig_age", 15, 10, 7, 1, 0, 4, 8)
    assert ma.smem_bytes == 8 * -(-(272 * 4 + 45 * 4) // 16) * 16
    assert smem_plan("mig_age", 15, 10, 7, 1, 0, 4, 8,
                     True).smem_bytes == ma.smem_bytes
    f32 = smem_plan("spr", 15, 10, 7, 1, 6, 4, 8)
    # tables 243 reals + 211 ints, conditionals 2 * 360 reals
    assert f32.smem_bytes == 8 * -(-((243 + 720) * 4 + 211 * 4) // 16) * 16
    assert smem_plan("spr", 15, 10, 7, 1, 6, 4, 3).loci_per_block == 3
    assert smem_plan("spr", 15, 10, 7, 1, 6, 4, 64).loci_per_block == 32
    forced = smem_plan("spr", 15, 10, 7, 1, 6, 4, 8, True)
    assert not forced.cond_smem and forced.smem_bytes < f32.smem_bytes
    # more patterns: fewer loci fit beside their conditionals ...
    mid = smem_plan("spr", 63, 32, 16, 8, 40, 8, 8)
    assert mid.cond_smem and 1 <= mid.loci_per_block < 8
    assert mid.smem_bytes <= limit
    # ... then the conditionals of one locus alone do not fit
    big = smem_plan("spr", 63, 32, 16, 8, 300, 8, 8)
    assert not big.cond_smem and big.loci_per_block == 8
    # one copy of the conditionals (rubber band) fits where two (SPR) do not
    one = smem_plan("rubber_band", 63, 32, 16, 8, 150, 4, 8)
    assert one.cond_smem and one.loci_per_block == 1
    assert not smem_plan("spr", 63, 32, 16, 8, 150, 4, 8).cond_smem
    with pytest.raises(ValueError, match="shared memory"):
        smem_plan("spr", 63, 32, 16, 8, 20000, 8, 8)
    with pytest.raises(ValueError, match="no kernel"):
        smem_plan("tau", 15, 10, 7, 1, 6, 4, 8)


@pytest.mark.parametrize("case", ["over_48k_with_static", "under_48k",
                                  "static_over_reserve"])
def test_opt_in_counts_the_static_tables(case, warm, host_libs, tmp_path,
                                         monkeypatch):
    """The rubber band at f32 on the warm state with its patterns padded:
    at P = 18 its 8 loci take 49,024 bytes of dynamic shared memory, under
    48 KiB, and with the kernel's 560 static bytes over it, so the launch
    entry opts the kernel in for 49,024; at P = 17 (46,976 + 560 bytes) it
    does not.  A kernel whose static bytes pass the plan's reserve is
    refused with the numbers.  A fresh load of the library reads the
    static bytes the test sets, once per kernel and real type."""
    lib_path = tmp_path / "libsweeps_host.so"
    shutil.copy(host_libs["forward"]._name, lib_path)
    lib = cuda_lib.bind(ctypes.CDLL(str(lib_path)))
    lib.host_set_static_smem(1025 if case == "static_over_reserve" else 560)
    _route(monkeypatch, lib)
    t = padded_state(warm, 17 if case == "under_48k" else 18, torch.float32)
    pop = t.tree.num_pops - 1
    rb = (t.gen, t.params, t.seq, t.ctx, pop, False, *tau_bounds(t, pop),
          t.cond)
    if case == "static_over_reserve":
        with pytest.raises(ValueError, match="1025 bytes of static shared "
                           "memory, over the 1024"):
            sweeps.rubber_band_eval(*rb)
        return
    plan = sweeps.prepare_rubber_band(*rb).plan
    out = sweeps.rubber_band_eval(*rb)
    attrs = (ctypes.c_int * 2)()
    lib.host_attributes(attrs)
    reads, opt_in = attrs
    assert reads == 1 and plan.static_bytes == 560
    assert plan.loci_per_block == 8 and plan.cond_smem
    if case == "under_48k":
        assert plan.smem_bytes == 46976 and opt_in == 0
    else:
        assert plan.smem_bytes == 49024 and opt_in == 49024
    assert bool(torch.isfinite(out[3]).all())


@pytest.mark.parametrize("which", ["spr", "node_age", "mig_age"])
def test_entry_refuses_a_wrong_smem_size(which, warm, kernels_on_host):
    """The launch entry computes the layout's size itself and refuses a
    shared-memory size that its kernel's plan entry would not give: a
    caller that skips the plan entry or changes its plan is caught before
    the kernel carves its memory."""
    s = warm
    if which == "spr":
        p = sweeps.prepare_spr(s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld,
                               s.cond)
    elif which == "node_age":
        p = sweeps.prepare_node_age(s.gen, s.params, s.seq, s.lrng, s.ctx,
                                    s.ft.coal_time, s.lnld, s.lnp, s.cond)
    else:
        p = sweeps.prepare_mig_age(s.gen, s.params, s.lrng, s.ctx,
                                   s.ft.mig_time, s.lnp)
    p.args.smem_bytes += 16
    with pytest.raises(RuntimeError, match="shared memory"):
        cuda_lib.launch(p.entry, p.args, 0)


@pytest.fixture(scope="module")
def warm_chains(tmp_path_factory):
    """Two chains side by side on SAMPLE_AGE_CTL (f64, plain versions
    only): 11 loci each, not a multiple of the loci per block, with a hot
    band and migrations in both; the chains' theta, tau and migration
    rates differ (their own seeds' draws)."""
    path = str(tmp_path_factory.mktemp("csrc_chains") / "seqs.txt")
    s = warm_state(torch.device("cpu"), torch.float64, path, num_loci=11,
                   ctl=SAMPLE_AGE_CTL, chains=2)
    # both bands were made equally hot: give chain 1 a rate of its own
    s.params = s.params._replace(
        mig_rate=s.params.mig_rate * torch.tensor([[1.0], [0.7]],
                                                  dtype=torch.float64))
    s.lnp = gen_log_prior(s.gen, s.params, s.ctx)
    pr = s.params
    assert s.gen.num_loci == 22
    for x in (pr.theta, pr.tau, pr.sample_age, pr.mig_rate):
        assert not torch.equal(x[0], x[1])
    return s


def _chain(s, c):
    """Chain c of a chain state as a one-chain state (views)."""
    L = s.num_loci
    cut = slice(c * L, (c + 1) * L)
    gen, params = s.chain_state(c)
    return types.SimpleNamespace(
        gen=gen, params=params, ctx=s.ctx, ft=s.ft, tree=s.tree,
        seq=type(s.seq)(*(None if x is None else x[cut] for x in s.seq)),
        lrng=s.lrng._replace(key=s.lrng.key[cut], ctr=s.lrng.ctr[c]),
        grng=s.grng._replace(key=s.grng.key[c:c + 1], ctr=s.grng.ctr[c]),
        cond=s.cond[cut], lnld=s.lnld[cut], lnp=s.lnp[cut])


@pytest.mark.parametrize("block", [8, 3])
def test_two_chains_match_plain_and_each_chain_alone(block, warm_chains,
                                                     host_libs, monkeypatch):
    """Every kernel and both rubber-band modes on two chains at once (one
    launch each, a block's loci one chain's) against their plain versions
    (chip_smoke's checks, F64_TOL: equal counters, counts and flags per
    chain), and each chain's outputs bitwise equal to the kernel's on that
    chain alone: the population tables, counters, proposal values and
    counts are the chain's own."""
    _route(monkeypatch, host_libs["forward"], block=block)
    s = warm_chains
    both = kernel_checks(s, Compare(), F64_TOL)
    both += sample_age_checks(s, Compare(), F64_TOL)
    # one launch per call for both chains (the tau sweep through the
    # kernel adds one per ancestral pop)
    assert sweeps.LAUNCHES["node_age"] == 1 and sweeps.LAUNCHES["spr"] == 1
    assert sweeps.LAUNCHES["rubber_band_sample_age"] == len(SAMPLE_AGE_STEPS)
    L = s.num_loci
    for c in range(2):
        alone = kernel_checks(_chain(s, c), Compare(), F64_TOL,
                              need_moves=False)
        alone += sample_age_checks(_chain(s, c), Compare(), F64_TOL)
        assert len(alone) == len(both)
        for x, y in zip(both, alone):
            if x.dim() and x.shape[0] == 2 * L:        # per locus
                assert torch.equal(x[c * L:(c + 1) * L], y)
            elif x.dim() and x.shape[0] == 2:          # per chain
                assert torch.equal(x[c], y)
            else:
                raise AssertionError(f"output of shape {tuple(x.shape)}")


@pytest.fixture(scope="module")
def warm_admix(tmp_path_factory):
    """A warmed 24-locus f64 state of ADMIX_AGE_CTL (two admixed leaves,
    an estimated sample age on D, a hot band), plain versions only."""
    path = str(tmp_path_factory.mktemp("csrc_admix") / "seqs.txt")
    return warm_state(torch.device("cpu"), torch.float64, path, num_loci=24,
                      ctl=ADMIX_AGE_CTL)


@pytest.fixture(scope="module")
def warm_admix_chains(tmp_path_factory):
    """Two chains of 11 loci of ADMIX_AGE_CTL side by side, their
    coefficients apart."""
    path = str(tmp_path_factory.mktemp("csrc_admix_c") / "seqs.txt")
    s = warm_state(torch.device("cpu"), torch.float64, path, num_loci=11,
                   ctl=ADMIX_AGE_CTL, chains=2)
    s.params = s.params._replace(admix_coeff=torch.tensor(
        [[0.3, 0.6], [0.8, 0.1]], dtype=torch.float64))
    s.lnp = gen_log_prior(s.gen, s.params, s.ctx)
    return s


@pytest.mark.parametrize("chains", [1, 2])
def test_admixed_kernels_match_plain(chains, warm_admix, warm_admix_chains,
                                     host_libs, monkeypatch):
    """SPR's admixed mode against update_spr(sync_group=1), some leaf
    moved to its other population and some not, and the rubber band's
    lnp_prop with the admixture terms in both modes against the plain
    version (chip_smoke's admix_checks at F64_TOL), for one chain and for
    two at once; the reversed-lane build gives the same bits."""
    s = warm_admix if chains == 1 else warm_admix_chains
    _route(monkeypatch, host_libs["forward"], block=5)
    fwd = admix_checks(s, Compare(), F64_TOL, need_moves=chains == 1)
    assert sweeps.LAUNCHES["spr"] == 2
    assert sweeps.LAUNCHES["rubber_band_sample_age"] == len(SAMPLE_AGE_STEPS)
    _route(monkeypatch, host_libs["reverse"], block=8)
    rev = admix_checks(s, Compare(), F64_TOL, need_moves=chains == 1)
    assert len(fwd) == len(rev)
    for x, y in zip(fwd, rev):
        assert torch.equal(x, y)


# ---- the counter streams' draw kernel (counter_draw.cu) --------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("wrap", [False, True], ids=["low", "wrap"])
@pytest.mark.parametrize("layout", DRAW_LAYOUTS)
def test_counter_draw_kernel_matches_aten_chain(layout, wrap, dtype,
                                                host_libs, monkeypatch):
    """rng_fast's CUDA route (one launch of counter_draw.cu per draw
    batch) gives the ATen chain's bits: one lane, K lanes and 3 chains
    ([C] counters, the general stream's [C, n]), int and per-lane offsets,
    n and 3n consecutive draws, counters that wrap past 2^32.
    LAUNCHES["rng_draw"] counts each batch on that route and stays 0 on
    the CPU's."""
    per, gen, offs = draw_streams(layout, wrap, torch.device("cpu"))
    sweeps.reset_launch_counts()
    want = draw_outputs(per, gen, offs, dtype)
    assert sweeps.LAUNCHES["rng_draw"] == 0
    _route(monkeypatch, host_libs["forward"])
    got = draw_outputs(per, gen, offs, dtype)
    assert sweeps.LAUNCHES["rng_draw"] == DRAW_BATCHES
    assert list(got) == list(want)
    for k, a in want.items():
        assert a.dtype == got[k].dtype and torch.equal(a, got[k]), k
    if layout == "chains":  # a layout the kernel refuses: 14 lanes, 3 chains
        with pytest.raises(RuntimeError, match="no layout"):
            RF._uniforms(RF.FastRngState(per.key[:14], per.ctr), 0, 1, dtype)
        assert sweeps.LAUNCHES["rng_draw"] == DRAW_BATCHES
