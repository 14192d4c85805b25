"""Felsenstein pruning under Jukes-Cantor (twin of gphocs_tpu/ops/pruning.py).

    p(L)   = (1 - exp(-4 L / 3)) / 4,     L = mut_rate * delta_age
    out[b] = p * sum_b'(c[b']) + (1 - 4 p) * c[b]

Every internal node's stored conditional carries a constant x4 rescale
(stored = 4^(internal nodes in subtree) x true), which keeps f32 values
representable on deep trees; the root reduce subtracts (S-1) log 4 back
(see ops/likelihood_cache.lnld_from_cond).

Edge clamp: p = 0 for lengths below 1e-100, the XLA value of
gphocs_tpu/ops/pruning.py.  The Pallas kernels used 1e-30; the port's
plain versions and its CUDA kernels (csrc/sweeps_common.cuh) all use
1e-100.  In f32 the constant rounds to 0, so the clamp is `length < 0`
there, as in the JAX XLA path at f32.
"""

from __future__ import annotations

import functools

import torch

EDGE_CLAMP = 1e-100


@functools.lru_cache(maxsize=None)
def _three(dtype, device) -> torch.Tensor:
    """The divisor 3 as a 0-d tensor.  On CUDA, PyTorch divides by a Python
    scalar as a multiplication by its rounded reciprocal, which can differ
    from the division (that the CUDA kernels and gphocs_tpu do) in the last
    bit; 1 - exp(-x) then turns that bit into ~1e-3 of p at f32.  By a
    tensor divisor it divides."""
    return torch.full((), 3.0, dtype=dtype, device=device)


def edge_p(edge_len: torch.Tensor) -> torch.Tensor:
    """JC substitution probability for one of the 3 off-diagonal bases;
    tiny/negative lengths give p = 0 (src/LocusDataLikelihood.c:1843)."""
    three = _three(edge_len.dtype, edge_len.device)
    p = (1.0 - torch.exp(-4.0 * edge_len / three)) / 4.0
    return torch.where(edge_len < EDGE_CLAMP, torch.zeros_like(p), p)


def sum4(c: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing base axis, left to right (the order the CUDA
    kernels use)."""
    return ((c[..., 0] + c[..., 1]) + c[..., 2]) + c[..., 3]


def jc_combine(ca, cb, pa, pb):
    """Conditional of a node from its two son conditionals [.., P, 4] and
    edge probabilities [..] (with the x4 rescale)."""
    a = pa[..., None, None]
    b = pb[..., None, None]
    fa = a * sum4(ca)[..., None] + (1.0 - 4.0 * a) * ca
    fb = b * sum4(cb)[..., None] + (1.0 - 4.0 * b) * cb
    return 4.0 * fa * fb


def leaf_conditionals(leaf_base: torch.Tensor, dtype) -> torch.Tensor:
    """[.., S, P] base codes -> [.., S, P, 4] conditionals.

    Code 0..3 -> one-hot; code 4 ('N'/missing) -> all-ones
    (reference src/LocusDataLikelihood.c:1321-1390)."""
    codes = torch.arange(4, device=leaf_base.device)
    onehot = leaf_base[..., None] == codes
    is_n = leaf_base[..., None] >= 4
    return (onehot | is_n).to(dtype)


def data_log_likelihood(gen, seq) -> torch.Tensor:
    """Per-locus data log-likelihood [L] (one-shot build + root reduce)."""
    from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld

    return full_rebuild_and_lnld(gen, seq)[1]
