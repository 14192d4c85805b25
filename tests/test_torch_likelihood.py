"""The group reduction of ops/likelihood_cache.lnld_from_cond, without JAX:
the gather table that io/sequences builds with the SeqData against a plain
per-group loop, and against the table derived on use."""

import numpy as np
import pytest
import torch

from gphocs_tpu_torch.config import parse_control_text
from gphocs_tpu_torch.config.samples import SAMPLE_CTL
from gphocs_tpu_torch.io.sequences import (build_seq_data,
                                           build_seq_data_buckets,
                                           group_members, read_seq_file)
from gphocs_tpu_torch.io.simulate import simulate_ragged_file
from gphocs_tpu_torch.ops.likelihood_cache import _group_sums
from gphocs_tpu_torch.state import from_numpy

# one intra-op thread (tests/torch_twins.py says why)
torch.set_num_threads(1)

LOCI = 40


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("groups") / "ragged.txt")
    simulate_ragged_file(path, LOCI)
    cfg = parse_control_text(SAMPLE_CTL)
    raw = read_seq_file(path, cfg.sample_names, 0)
    _, _, buckets = build_seq_data_buckets(raw, cfg.is_diploid(), 3)
    dense = build_seq_data(raw, cfg.is_diploid())
    assert dense.group_members.shape[1] > 1, "no group of several patterns"
    return [dense] + buckets


def _plain_sums(x, group_id):
    """The sum of each group's patterns, one pattern after another."""
    L, P = x.shape
    seg = np.zeros((L, P))
    for l in range(L):
        for p in range(P):
            seg[l, group_id[l, p]] += x[l, p]
    return seg


@pytest.mark.parametrize("which", ["dense", "bucket0", "bucket1", "bucket2"])
def test_group_sums_in_pattern_order(seqs, which):
    """The same bits as a plain loop over the patterns, with the table built
    with the SeqData and with the table derived from group_id on use."""
    q = seqs[["dense", "bucket0", "bucket1", "bucket2"].index(which)]
    L, P = q.group_id.shape
    assert q.group_members.shape[::2] == (L, P)
    x = np.random.default_rng(5).random((L, P)) * q.pattern_valid
    want = _plain_sums(x, q.group_id)
    t = from_numpy(q, device="cpu", dtype=torch.float64)
    got = _group_sums(torch.as_tensor(x), t)
    np.testing.assert_array_equal(got.numpy(), want)
    derived = _group_sums(torch.as_tensor(x), t._replace(group_members=None))
    assert torch.equal(derived, got)


def test_group_members_layout():
    """Entry [l, j, g] is the j-th pattern of group g, or P past its end."""
    gid = np.array([[0, 0, 1, 2, 2, 2, 6], [0, 1, 2, 3, 4, 5, 6]])
    m = group_members(gid)
    P = 7
    assert m.shape == (2, 3, P)
    np.testing.assert_array_equal(m[0, :, 0], [0, 1, P])
    np.testing.assert_array_equal(m[0, :, 2], [3, 4, 5])
    np.testing.assert_array_equal(m[0, :, 3], [P, P, P])
    np.testing.assert_array_equal(m[1, 0], np.arange(P))
    assert (m[1, 1:] == P).all()
