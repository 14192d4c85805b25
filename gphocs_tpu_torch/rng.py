"""Scalar draws from the size-1 general stream (the FastRngState branches
of gphocs_tpu/rng.py that the fast-RNG iteration calls).

The legacy Wichmann-Hill streams are not ported yet (ROADMAP Queue 1,
conformance mode)."""

from __future__ import annotations

from typing import Tuple

import torch

from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.rng_fast import FastRngState


def general_draw_u(state: FastRngState, dtype
                   ) -> Tuple[torch.Tensor, FastRngState]:
    """Scalar U(0,1) from a size-1 (general) stream."""
    u, state = RF.rndu(state, dtype)
    return u[0], state


def general_draw_2normal8(state: FastRngState, dtype
                          ) -> Tuple[torch.Tensor, FastRngState]:
    """Scalar rnd2normal8 from a size-1 (general) stream."""
    z, state = RF.rnd2normal8(state, dtype)
    return z[0], state
