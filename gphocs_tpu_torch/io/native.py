"""ctypes bridge to the native C++ ingest module (twin of
gphocs_tpu/io/native.py over the repo's cpp/ingest.cpp).

The shared library is built at first use with g++ into
build/gphocs_tpu_torch/ (git-ignored), keyed by a hash of the source, and
never next to the source: cpp/ belongs to the JAX package.  The build goes
to a file of its own process and is renamed into place, so that processes
starting together do not load a half-written library.  Where no toolchain
builds it, `read_seq_file_native` returns None and io/sequences.py reads
the file in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "cpp" / "ingest.cpp"
BUILD_DIR = ROOT / "build" / "gphocs_tpu_torch"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_BUILD_FAILED = False


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libgphocs_ingest_{h.hexdigest()[:16]}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    if _LIB is not None:
        return _LIB
    if _BUILD_FAILED:
        return None
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        _BUILD_FAILED = True
        return None
    lib.gphocs_ingest.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int]
    lib.gphocs_ingest.restype = ctypes.c_int
    lib.gphocs_ingest_error.restype = ctypes.c_char_p
    lib.gphocs_ingest_error.argtypes = []
    for name in ("num_loci", "num_patterns", "profile_size"):
        fn = getattr(lib, f"gphocs_ingest_{name}")
        fn.argtypes, fn.restype = [], ctypes.c_int
    i32 = ctypes.POINTER(ctypes.c_int32)
    for name, args in (("patterns", [ctypes.c_char_p]),
                       ("profiles", [i32, i32, i32]), ("free", [])):
        fn = getattr(lib, f"gphocs_ingest_{name}")
        fn.argtypes, fn.restype = args, None
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def read_seq_file_native(path: str, sample_names: List[str],
                         num_loci_limit: int = -1):
    """Native twin of io.sequences.read_seq_file.  Returns
    (patterns [list of str], profile lists per locus) or None if the
    native module is unavailable."""
    lib = _load()
    if lib is None:
        return None
    names_blob = b"\0".join(n.encode() for n in sample_names) + b"\0"
    rc = lib.gphocs_ingest(path.encode(), names_blob,
                           len(sample_names), num_loci_limit)
    if rc != 0:
        raise ValueError(
            f"native ingest failed: "
            f"{lib.gphocs_ingest_error().decode()}")
    num_loci = lib.gphocs_ingest_num_loci()
    num_patterns = lib.gphocs_ingest_num_patterns()
    prof_size = lib.gphocs_ingest_profile_size()
    S = len(sample_names)

    pat_buf = ctypes.create_string_buffer(num_patterns * S)
    lib.gphocs_ingest_patterns(pat_buf)
    patterns = [
        pat_buf.raw[i * S:(i + 1) * S].decode()
        for i in range(num_patterns)
    ]
    offsets = np.zeros(num_loci + 1, np.int32)
    ids = np.zeros(prof_size, np.int32)
    counts = np.zeros(prof_size, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.gphocs_ingest_profiles(offsets.ctypes.data_as(i32),
                               ids.ctypes.data_as(i32),
                               counts.ctypes.data_as(i32))
    lib.gphocs_ingest_free()

    profiles = []
    for l in range(num_loci):
        lo, hi = offsets[l], offsets[l + 1]
        profiles.append(list(zip(ids[lo:hi].tolist(),
                                 counts[lo:hi].tolist())))
    return patterns, profiles
