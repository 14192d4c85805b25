"""UpdateAdmixCoeffs: admixture-coefficient updates (twin of
gphocs_tpu/kernels/admix.py).

Mirrors reference src/GPhoCS.c:2958-3028.  For each admixed leaf a, in
order: a reflected normal proposal on (0, 1) from the general stream; the
likelihood is binomial in the per-locus population assignments,

    lnacc = n_second * log(c'/c) + (L_valid - n_second) * log((1-c')/(1-c))

with n_second the valid loci whose leaf a sits in its second population;
an accepted move adds log(c'/c) or log((1-c')/(1-c)) to each locus's
prior.

Fast streams: the stage takes 4 draws per leaf from the general stream,
in gphocs_tpu's order (leaf a: the proposal's rnd2normal8 from draws
4a + 1..4a + 3, the MH uniform from 4a + 4).  They are drawn in one
step: the counter-RNG's integer hash is ~50 tensor operations a call,
and the bits of a draw do not depend on how many are drawn with it.  A
Wichmann-Hill general stream (the conformance mode) draws leaf by leaf,
as gphocs_tpu's scan does: the proposal's rnd2normal8, then the MH
uniform where lnacc < 0.

C chains ([C, A] coefficients, chain-major loci, [C] general streams): all
chains move slot a at once, each drawing, counting and deciding on its
own, as scalar_params.py does for theta.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.kernels.common import (Context, chain_count,
                                             maybe_psum, per_chain, rows,
                                             scalar_mh_accept)
from gphocs_tpu_torch.state import GenState, Params
from gphocs_tpu_torch.utils import reflect


def in_second_pop(gen: GenState, ctx: Context) -> torch.Tensor:
    """[L, A] bool: admixed leaf a of a valid locus sits in its second
    population (gphocs_tpu's trace field admix_in2)."""
    return ((gen.node_pop[:, ctx.admix_slot] == ctx.admix_pops[None, :, 1])
            & gen.valid[:, None])


def update_admix_coeffs(gen: GenState, params: Params, rng, ctx: Context,
                        finetune, lnp: torch.Tensor, loci_axis=None):
    """Returns (params, rng, lnp, accepted_count) ([C] counts for C
    chains).  On a loci mesh (`loci_axis`) the valid loci and the counts
    in the second population add up over the ranks."""
    dt = lnp.dtype
    L = lnp.shape[0]
    C = chain_count(params)
    in2 = in_second_pop(gen, ctx)
    nloci, n2 = maybe_psum([per_chain(gen.valid.to(dt), C),
                            per_chain(in2.to(dt), C)],        # [(C,) A]
                           loci_axis)
    coeff = params.admix_coeff
    A = ctx.num_admixed
    fast = isinstance(rng, RF.FastRngState)
    if fast:
        u, rng = RF.batch_u(rng, 4 * A, dt)                  # [(C,) 4A]
    cols = []
    acc = torch.zeros(coeff.shape[:-1], dtype=torch.int64, device=lnp.device)
    for a in range(A):
        c_old = coeff[..., a]
        if fast:
            z = RF.normal8(u[..., 4 * a], u[..., 4 * a + 1],
                           u[..., 4 * a + 2])
        else:
            z, rng = R.general_draw_2normal8(rng, dt)
        c_new = reflect(c_old + finetune * z, 0.0, 1.0)
        log_r = torch.log(c_new / c_old)
        log_cr = torch.log((1.0 - c_new) / (1.0 - c_old))
        lnacc = n2[..., a] * log_r + (nloci - n2[..., a]) * log_cr
        if fast:
            accept = (lnacc >= 0.0) | (
                u[..., 4 * a + 3] < torch.exp(torch.clamp(lnacc, max=0.0)))
        else:
            accept, rng = scalar_mh_accept(rng, lnacc)
        cols.append(torch.where(accept, c_new, c_old))
        dlnp = torch.where(in2[:, a], rows(log_r, L, 0), rows(log_cr, L, 0))
        lnp = torch.where(rows(accept, L, 0), lnp + dlnp, lnp)
        acc = acc + accept.to(torch.int64)
    return (params._replace(admix_coeff=torch.stack(cols, dim=-1)), rng, lnp,
            acc)
