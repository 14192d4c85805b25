"""The iteration's inputs and outputs (twin of the types of
gphocs_tpu/sampler/step.py): finetunes on the device, the statistics of an
iteration and the trace of a chunk.  The iteration itself, bucketed or
not, is sampler/bucketed.py's: an unbucketed state is one bucket.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Finetunes(NamedTuple):
    """Device-side finetune values (the auto-search mutates them)."""

    coal_time: torch.Tensor
    mig_time: torch.Tensor
    theta: torch.Tensor
    mig_rate: torch.Tensor
    mixing: torch.Tensor
    locus_rate: torch.Tensor
    admix: torch.Tensor
    taus: torch.Tensor  # [P]


class StepStats(NamedTuple):
    acc_coal_time: torch.Tensor
    acc_mig_time: torch.Tensor
    acc_spr: torch.Tensor
    acc_theta: torch.Tensor
    acc_mig_rate: torch.Tensor
    acc_taus: torch.Tensor       # [P]
    acc_mixing: torch.Tensor
    acc_locus_rate: torch.Tensor
    rate_var_delta: torch.Tensor
    tau_conflicts: torch.Tensor
    num_migs_total: torch.Tensor
    lnld_sum: torch.Tensor
    lnp_sum: torch.Tensor
    acc_admix: torch.Tensor  # admixture coefficients


class ChunkTrace(NamedTuple):
    """Per-iteration outputs of a chunk (leading axis = iterations)."""

    theta: torch.Tensor        # [K, P]
    tau: torch.Tensor          # [K, P]
    sample_age: torch.Tensor   # [K, P]
    mig_rate: torch.Tensor     # [K, B]
    lnld_sum: torch.Tensor     # [K]
    lnp_sum: torch.Tensor      # [K]
    rate_var_delta: torch.Tensor  # [K]
    admix_coeff: torch.Tensor  # [K, A] (A = 0 without admixed leaves)
