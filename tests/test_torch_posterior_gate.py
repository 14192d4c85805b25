"""The posterior gate's set-up (gphocs_tpu_torch/tools/posterior_gate.py),
on the CPU: its control templates are the harness's
(scripts/golden_compare.py, scripts/golden_2band.py), its data file is the
one gphocs_tpu's simulator writes from the same seeds (numpy only; no
sampler of the JAX package runs), and the tool runs end to end at a toy
size.  The gate itself runs on the card."""

import ast
import json
import os

import pytest

from gphocs_tpu.config import parse_control_text as jax_parse
from gphocs_tpu.io.simulate import simulate_seq_file as jax_simulate
from gphocs_tpu.model import build_poptree as jax_tree
from gphocs_tpu.rng_host import HostRng as JaxHostRng
from gphocs_tpu.sampler.init import sample_pop_parameters as jax_params

from gphocs_tpu_torch.tools import posterior_gate as gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script_strings(name):
    """The string constants of a harness script, read without importing
    it (the scripts configure JAX when imported)."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", name)).read())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_templates_are_the_harness_ones():
    assert gate.CTL_TEMPLATE in _script_strings("golden_compare.py")
    band_blocks = [s for s in _script_strings("golden_2band.py")
                   if s.startswith("MIG-BANDS-START")]
    two = max(band_blocks, key=len)
    assert two.count("BAND-START") == 2 and two in gate.CTL_2BAND
    assert gate.CTL_2BAND.count("BAND-START") == 2


@pytest.mark.parametrize("case", ["fused", "2band"])
def test_data_file_equals_gphocs_tpu_simulator(case, tmp_path):
    template, loci, _ = gate.CASES[case]
    ours = gate.write_data(str(tmp_path), template, loci)
    seq = str(tmp_path / "jax_seqs.txt")
    cfg = jax_parse(template.format(seq=seq, trace="t.out", iters=1,
                                    burnin=0, seed=gate.SEED))
    tree = jax_tree(cfg)
    tp = jax_params(tree, JaxHostRng(loci + 1, gate.DATA_SEED))
    tp = tp._replace(theta=tp.theta * gate.BOOST, tau=tp.tau * gate.BOOST)
    jax_simulate(cfg, tree, seq, num_loci=loci, seq_len=1000,
                 seed=gate.DATA_SEED, params=tp)
    assert open(ours).read() == open(seq).read()


def test_gate_runs_end_to_end_at_a_toy_size(tmp_path):
    """Two chains of a few iterations on 4 loci: one z per marginal of the
    golden file; the numbers mean nothing at this size."""
    out = tmp_path / "gate.json"
    rc = gate.main(["--device", "cpu", "--chains", "2", "--iters", "6",
                    "--burnin", "2", "--loci", "4", "--x64",
                    "--out", str(out)])
    assert rc in (0, 1)
    got = json.loads(out.read_text())
    golden = json.load(open(os.path.join(REPO, "GOLDEN_FUSED_r05.json")))
    assert [r["param"] for r in got["results"]] == [
        r["param"] for r in golden["results"]]
    assert got["card"] == "cpu" and got["chains"] == 2
