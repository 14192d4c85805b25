"""Nothing of the benchmark loads JAX or the JAX package, and neither the
plain reference nor the data generator loads the program under test.
Each module is imported in a fresh interpreter; top-level module names
are compared whole (the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "gphocs_tpu"}


def modules():
    out = []
    for d, _, files in os.walk(BENCH):
        if "__pycache__" in d or os.sep + "tests" in d[len(BENCH):]:
            continue
        out += [os.path.relpath(os.path.join(d, f), ROOT)
                for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def loaded_after_import(path):
    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['m'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


@pytest.mark.parametrize("path", modules())
def test_no_jax(path):
    assert not loaded_after_import(os.path.join(ROOT, path)) & JAX


@pytest.mark.parametrize("path", [p for p in modules()
                                  if p.startswith("benchmark/reference/")
                                  or p == "benchmark/datagen.py"])
def test_reference_and_generator_stand_apart(path):
    assert "gphocs_tpu_torch" not in loaded_after_import(
        os.path.join(ROOT, path))
