"""The CUDA sources of gphocs_tpu_torch (csrc/*.cu), compiled for the host
with a C++ compiler, against their plain PyTorch versions at f64.

tests/cuda_host/cuda_runtime.h stands in for the CUDA runtime: each locus
runs as a one-thread block, so SPR is held against
update_spr(sync_group=1); the block-wide trip sync itself is checked on
the card by chip_smoke.py.  The kernels are reached through the wrappers
in ops/sweeps.py, so the SweepArgs layout shared by ctypes and C++ is
checked too.  No GPU is needed; the test skips without a C++ compiler.
"""

import ctypes
import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

from chip_smoke import sample_age_bounds, tau_bounds, warm_state
from gphocs_tpu_torch.kernels.mig_age import update_mig_ages
from gphocs_tpu_torch.kernels.node_age import update_internal_node_ages
from gphocs_tpu_torch.kernels.spr import update_spr
from gphocs_tpu_torch.config.samples import SAMPLE_AGE_CTL
from gphocs_tpu_torch.kernels.tau import (rubber_band_eval_plain,
                                          update_sample_ages_fused,
                                          update_taus, update_taus_fused)
from gphocs_tpu_torch.ops import cuda_lib, sweeps

SHIM = Path(__file__).resolve().parent / "cuda_host"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("csrc_host") / "libsweeps_host.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{SHIM}", "-x", "c++",
         *(str(cuda_lib.CSRC / s) for s in cuda_lib.SOURCES),
         "-o", str(out)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for name in cuda_lib.ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(cuda_lib.SweepArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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


@pytest.fixture
def kernels_on_host(host_lib, monkeypatch):
    """Route the ops/sweeps wrappers to the host build for CPU tensors."""
    monkeypatch.setattr(sweeps, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(sweeps, "BLOCK", 1)
    monkeypatch.setattr(cuda_lib, "_LIB", host_lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    sweeps.reset_launch_counts()


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
                               "rubber_band_sample_age": 1, "spr": 0}
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
    monkeypatch.setattr(sweeps, "_on_cuda", lambda *tensors: False)
    q = update_sample_ages_fused(*args)
    assert sweeps.LAUNCHES["rubber_band_sample_age"] == 1
    assert torch.equal(k[6], q[6]) and int(k[2].ctr) == int(q[2].ctr)
    assert int(k[7]) == int(q[7])
    _close(k[1].sample_age, q[1].sample_age, 1e-15)
    _close(k[0].age, q[0].age, 1e-12)
    _close(k[3], q[3], 1e-9)
    _close(k[4], q[4], 1e-9)
