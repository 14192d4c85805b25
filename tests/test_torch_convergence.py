"""The port's convergence diagnostics (gphocs_tpu_torch/tools/convergence,
a copy of gphocs_tpu's numpy module on the port's trace reader) against
gphocs_tpu.tools.convergence on the same inputs: fixed numpy chains and
two small trace files."""

import numpy as np
import pytest

from gphocs_tpu.tools import convergence as jax_conv

from gphocs_tpu_torch.tools import convergence as conv


def _chains(seed, m, n, rho):
    """m AR(1) chains of n samples with lag-one correlation rho, offset
    per chain."""
    rng = np.random.default_rng(seed)
    x = np.zeros((m, n))
    e = rng.normal(size=(m, n))
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + e[:, t]
    return x + rng.normal(scale=0.3, size=(m, 1))


@pytest.mark.parametrize("seed, m, n, rho", [
    (1, 4, 200, 0.0), (2, 2, 51, 0.9), (3, 12, 1000, 0.5), (4, 1, 3, 0.2)])
def test_split_rhat_and_ess_equal_gphocs_tpu(seed, m, n, rho):
    x = _chains(seed, m, n, rho)
    a, b = conv.split_rhat(x), jax_conv.split_rhat(x)
    assert (np.isnan(a) and np.isnan(b)) or a == b
    for row in x:
        assert conv.ess(row) == jax_conv.ess(row)
    assert conv.ess(np.ones(50)) == jax_conv.ess(np.ones(50)) == 50.0


def test_diagnose_equals_gphocs_tpu_on_trace_files(tmp_path, capsys):
    cols = ["Sample", "theta_A", "tau_AB", "Data-ld-ln"]
    paths = []
    for c in range(2):
        x = _chains(10 + c, 3, 120, 0.7)
        path = tmp_path / f"chain{c}.out"
        with open(path, "w") as f:
            f.write("\t".join(cols) + "\n")
            for i in range(x.shape[1]):
                f.write("\t".join([str(i)] + [f"{v:.6f}" for v in x[:, i]])
                        + "\n")
        paths.append(str(path))
    names, out = conv.diagnose(paths, discard=20)
    names_j, out_j = jax_conv.diagnose(paths, discard=20)
    assert list(names) == list(names_j) == cols[1:]
    for k in names:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(out_j[k]), err_msg=k)
    assert conv.main(paths + ["-d", "20"]) == 0
    assert "worst R-hat" in capsys.readouterr().out
