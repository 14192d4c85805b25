"""Small numeric utilities shared across kernels (twin of gphocs_tpu/utils.py)."""

from __future__ import annotations

import torch

# Safety slack used by the reference's reflect() (src/utils.c:337).
REFLECT_SLACK = 1e-9


def reflect(x: torch.Tensor, a, b) -> torch.Tensor:
    """Reflect x into the open interval (a, b), elementwise.

    Shrink the interval by a slack of 1e-9 on both sides, return the
    midpoint if it becomes empty, fold by the doubled interval, then run
    the alternating-reflection fixup until every lane is inside
    (reference src/utils.c:333-398)."""
    x = torch.as_tensor(x)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device) + REFLECT_SLACK
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device) - REFLECT_SLACK
    empty = b <= a
    # guard values so the arithmetic below stays finite on empty lanes
    a_s = torch.where(empty, torch.zeros_like(a), a)
    b_s = torch.where(empty, torch.ones_like(b), b)
    inside = (x < b_s) & (x > a_s)

    xnew = torch.where(x <= a_s, 2.0 * a_s - x, x)
    dbl = 2.0 * (b_s - a_s)
    xnew = xnew - dbl * torch.floor((xnew - a_s) / dbl)
    xnew = torch.where(xnew >= b_s, 2.0 * b_s - xnew, xnew)
    while bool(torch.any(~empty & ~inside & ((xnew <= a_s) | (xnew >= b_s)))):
        xnew = torch.where(xnew >= b_s, 2.0 * b_s - xnew, xnew)
        xnew = torch.where(xnew <= a_s, 2.0 * a_s - xnew, xnew)
    return torch.where(empty, (a + b) / 2.0, torch.where(inside, x, xnew))


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in index order, ((x0 + x1) + x2) + ...: the
    order of the kernels' loops (csrc/), on every device.  torch.sum adds
    in a tree on CUDA, which at f32 moves a 4,000 bp locus's lnld by an
    ulp (~5e-4) and so decides a near-threshold move differently from the
    kernel (PERF.md, PR 6).  One addition per column."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def log_gamma_density(alpha, beta, val):
    """log Gamma(alpha, beta) density (reference src/GPhoCS.c:860-866)."""
    logp = torch.where(alpha != 1.0, -torch.lgamma(alpha),
                       torch.zeros_like(alpha))
    return logp + alpha * torch.log(beta) + (alpha - 1.0) * torch.log(val) \
        - beta * val
