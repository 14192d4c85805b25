"""Build and load the hand-written Hopper kernels (csrc/*.cu).

The sources are compiled with nvcc into one shared library with a plain C
interface (no PyTorch headers), at first use, keyed by a hash of the
sources and flags.  Each source is compiled by its own nvcc process, all
started together, and the objects are then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -c csrc/<kernel>.cu -o <kernel>.o
    nvcc -shared -o build/gphocs_tpu_torch/libsweeps_<hash>.so *.o

and the library is loaded with ctypes.  What ptxas reports (registers,
stack frame and spills of every kernel) is kept beside the library as
ptxas_<hash>.txt (`resource_report`).  -fmad=false keeps every multiply and add rounded
on its own, as the plain versions' separate tensor ops are: the kernels
then agree with them to the last bits at f64 (a contracted proposal moves
ages by ~1e-13, and the prior, d lnP / d t ~ 2 n / theta ~ 1e5, by ~1e-8).
Every entry point of the four sweep kernels and of full_rebuild.cu (the
conditionals and lnld rebuilt on given ages) takes a pointer to one
`SweepArgs` struct (csrc/sweeps_common.cuh) and the CUDA stream, launches
one kernel, and returns cudaGetLastError(); `launch` raises on non-zero.
Each of these kernels runs a warp per locus with its tables in dynamic
shared memory.  Its plan entry, `<kernel>_plan_<t>` (`plan`), decides how
much a block takes and where the conditionals live, from the kernel's own
layout;
its launch entry refuses a size that layout does not give, and allows the
kernel more than 48 KB where the block's dynamic and static shared memory
together pass that.

counter_draw.cu draws the counter streams' uniforms (rng_fast.py) in one
launch per batch.  Its entry points, `counter_draw_f32` and
`counter_draw_f64`, take plain pointers and ints (`DRAW_ARGTYPES`: key,
counter, per-lane offsets or null, base offset, lanes, counters, draws per
lane, output, stream), not a SweepArgs, so that a draw builds no struct;
`launch_draw` raises on an error, and on a layout the kernel refuses
(`ERR_DRAW_SHAPE`), and counts each launch in LAUNCHES["rng_draw"].

LAUNCHES counts the kernel launches of this library since the last
ops/sweeps.reset_launch_counts() (`-v` prints it), PLANS the launches of
each warp kernel by the shared-memory plan it ran with, and `on_cuda` is the
one test of where a launch would go: the sweep wrappers (ops/sweeps.py)
and the draws (rng_fast.py) both take the kernel for CUDA tensors and
their plain versions for CPU tensors.

Nothing here runs at import: the CPU tests import every module of the
package on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gphocs_tpu_torch"
SOURCES = ("node_age.cu", "mig_age.cu", "rubber_band.cu", "spr.cu",
           "full_rebuild.cu", "counter_draw.cu")
HEADERS = ("sweeps_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# bounds of the kernels (MAXN... in sweeps_common.cuh: nodes, populations,
# bands), and the entry points' errors (SWEEP_ERR_* there)
MAXN, MAXPP, MAXB = 63, 16, 8
ERR_SMEM = 9001
ERR_CHAINS = 9002
ERR_TABLES = 9004
ERR_STATIC = 9005

# SweepArgs field order: must match struct SweepArgs in sweeps_common.cuh
PTR_FIELDS = (
    "age", "lson", "rson", "father", "node_pop", "root",
    "mig_branch", "mig_band", "mig_age", "mut_rate", "valid",
    "group_id", "group_count", "group_nphases", "pattern_valid",
    "theta", "tau", "mig_rate", "popi", "key", "ctr", "finetune",
    "taub0", "taub1", "tauold", "taunew",
    "lnld_in", "lnp_in", "cond_in",
    "cond_out", "prop",
    "age_out", "lson_out", "rson_out", "father_out", "node_pop_out",
    "root_out", "mig_branch_out", "mig_band_out", "mig_age_out",
    "lnld_out", "lnp_out", "acc_out", "ctr_out", "stat", "prof",
    "admix_coeff",
)
INT_FIELDS = ("L", "N", "M", "B", "PP", "P", "root_pop", "pop", "is_root",
              "block", "sample_age", "cond_smem", "smem_bytes", "advance",
              "C", "Lc", "A")


class SweepArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in PTR_FIELDS]
                + [(f, ctypes.c_int) for f in INT_FIELDS]
                + [("oldage", ctypes.c_double)])


KERNELS = ("node_age", "mig_age", "rubber_band", "spr", "full_rebuild")
ENTRY_POINTS = tuple(f"{k}_{t}" for k in KERNELS for t in ("f32", "f64"))
PLAN_ENTRY_POINTS = tuple(f"{k}_plan_{t}" for k in KERNELS
                          for t in ("f32", "f64"))
# the counter streams' uniforms (counter_draw.cu): key, ctr, offs, base, K,
# C, n, out, stream; the error for a layout it does not take
DRAW_ENTRY_POINTS = ("counter_draw_f32", "counter_draw_f64")
DRAW_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
ERR_DRAW_SHAPE = 9003

# kernel launches per wrapper; the rubber-band kernel's two modes (tau,
# sample age) are counted apart, and so are the conformance mode's plain
# sweeps (*_plain: calls, no kernel); full_rebuild: mixing's rebuilds of
# the proposal (ops/sweeps.full_rebuild, one per bucket); rng_draw: the
# counter streams' draw batches (launch_draw)
LAUNCHES = {"node_age": 0, "mig_age": 0, "rubber_band": 0,
            "rubber_band_sample_age": 0, "spr": 0, "node_age_plain": 0,
            "mig_age_plain": 0, "spr_plain": 0, "full_rebuild": 0,
            "rng_draw": 0}
# launches of each warp kernel by its plan (ops/sweeps.plan_kind): "smem",
# the locus's tables and conditionals in shared memory within 48 KiB;
# "smem_optin", there past 48 KiB, with the kernel opted in; "device", the
# conditionals in device memory; and "smem_bytes", the largest dynamic
# shared memory a block of the kernel asked for
PLANS = {k: {"smem": 0, "smem_optin": 0, "device": 0, "smem_bytes": 0}
         for k in KERNELS}

_LIB = None


def on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raise otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on CUDA or CPU, not {dev}")
    return dev.type == "cuda"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _failed(proc, out, err) -> RuntimeError:
    return RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}\n{err}")


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet) and
    return the library path.  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = source_hash()
    lib = BUILD_DIR / f"libsweeps_{tag}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    work.mkdir(exist_ok=True)
    try:
        objs = [work / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for s, o in zip(SOURCES, objs)]
        results = [(p, *p.communicate()) for p in procs]
        for p, out, err in results:
            if p.returncode != 0:
                raise _failed(p, out, err)
        tmp = work / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise _failed(link, link.stdout, link.stderr)
        (BUILD_DIR / f"ptxas_{tag}.txt").write_text(
            "".join(err for _, _, err in results))
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def resource_report() -> list:
    """ptxas's lines on each kernel of the built library: the entry's
    name, its stack frame and spills, and its registers."""
    text = (BUILD_DIR / f"ptxas_{source_hash()}.txt").read_text()
    return [ln.strip() for ln in text.splitlines()
            if "Compiling entry" in ln or "stack frame" in ln
            or "Used" in ln]


def bind(lib):
    """Declare the argument and result types of every entry point of a
    loaded library; returns it."""
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(SweepArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in PLAN_ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(SweepArgs), ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    for name in DRAW_ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = DRAW_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def plan(kernel: str, real: str, args: SweepArgs, block: int,
         cond_in_device_memory: bool) -> int:
    """Have the kernel's plan entry write its plan for the shape in `args`
    (N, M, PP, B, P) into args.block, cond_smem and smem_bytes; return the
    kernel's static shared memory in bytes."""
    if kernel not in KERNELS:
        raise ValueError(f"no kernel {kernel!r}")
    info = (ctypes.c_int * 4)()
    err = getattr(library(), f"{kernel}_plan_{real}")(
        ctypes.byref(args), int(block), int(cond_in_device_memory), info)
    static, reserve, tables, room = info
    if err == ERR_TABLES:
        raise ValueError(
            f"{kernel}: one locus's tables take {tables} bytes of shared "
            f"memory, a block has {room} (N={args.N}, M={args.M}, "
            f"P={args.P})")
    if err == ERR_STATIC:
        raise ValueError(
            f"{kernel}_{real}: {static} bytes of static shared memory, over "
            f"the {reserve} the plan keeps for it")
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel}_{real}: no plan, "
                           f"cudaError {err}")
    return static


def launch(entry: str, args: SweepArgs, stream: int) -> None:
    """Call one C entry point; raise if the launch reported an error."""
    err = getattr(library(), entry)(ctypes.byref(args),
                                    ctypes.c_void_p(stream))
    if err == ERR_SMEM:
        raise RuntimeError(f"CUDA kernel {entry}: {args.smem_bytes} bytes of "
                           f"shared memory for blocks of {args.block} loci "
                           "is not what the kernel's layout gives: the "
                           "arguments do not hold its plan entry's plan")
    if err == ERR_CHAINS:
        raise RuntimeError(f"CUDA kernel {entry}: {args.C} chains of "
                           f"{args.Lc} loci for {args.L} loci")
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError {err}")


def launch_draw(entry: str, key: int, ctr: int, offs: int, base: int,
                K: int, C: int, n: int, out: int, stream: int) -> None:
    """Call a counter_draw entry point (pointers as ints, offs 0 for
    none); raise if the launch reported an error, else count it."""
    err = getattr(library(), entry)(key, ctr, offs, base, K, C, n, out,
                                    stream)
    if err == ERR_DRAW_SHAPE:
        raise RuntimeError(f"CUDA kernel {entry}: no layout of {n} draws "
                           f"over {K} lanes of {C} counters")
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES["rng_draw"] += 1
