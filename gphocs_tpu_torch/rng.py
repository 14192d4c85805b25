"""The RNG streams' draws (twin of gphocs_tpu/rng.py), dispatched on the
state's type as in the JAX package:

  * `FastRngState` (rng_fast.py): the counter-based streams of the
    fast-RNG iteration.  Every lane draws, whatever the mask: a masked-out
    lane's draw is read and thrown away, and the counter advances alike;
  * `WhRngState`: the reference's Wichmann-Hill AS183 streams of the
    conformance mode (--legacy-rng; reference src/utils.c:400-517), one per
    locus and one general stream.  Only the lanes of the mask draw; the
    others keep their state, so that every locus consumes its stream in
    the reference's order (the MH uniform only where lnacc < 0, a polar
    normal until it accepts).

uint32 arithmetic is carried in int64 under a 0xFFFFFFFF mask: AS183 as the
reference writes it omits the negative correction and relies on unsigned
wraparound (x = 177 gives 2^32 - 2 after one step).  The uniform is
computed in float64 whatever the sampler's dtype, each of the three
quotients divided by a 0-d float64 tensor on the state's device (on CUDA,
PyTorch divides by a Python scalar as a multiplication by the rounded
reciprocal, which is not the IEEE quotient that the reference adds), and
the sum folded by r - trunc(r).  The draws come back in float64; callers
cast them where they use them.  The polar normal's rejection loop runs
until no lane of the mask still rejects, which costs one host
synchronization per trip on the card.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.rng_fast import MASK32, FastRngState

F64 = torch.float64
# mixture-kernel constants (reference src/utils.c:437-441: m2s2 = 8)
M2N = math.sqrt(8.0 / 9.0)
S2N = math.sqrt(1.0 / 9.0)


class WhRngState(NamedTuple):
    """Wichmann-Hill states, one lane per stream; int64 holding uint32.
    A sampler of C chains holds its per-locus streams chain-major, [C *
    L], and its general streams as [C, 1] (one chain's is [1]), the
    layout of gphocs_tpu's stacked chains."""

    x: torch.Tensor   # [K] (general streams of C chains: [C, 1])
    y: torch.Tensor
    z: torch.Tensor


def init_legacy(num_slots: int, seed: int, device="cpu") -> WhRngState:
    """Every slot seeded alike, as the reference does (src/utils.c:411)."""
    seed = int(seed) & MASK32
    z = (170 * (seed % 178) + 137) & MASK32

    def full(v):
        return torch.full((num_slots,), v, dtype=torch.int64, device=device)

    return WhRngState(full(11), full(23), full(z))


def from_arrays(x, y, z, device="cpu") -> WhRngState:
    """A state from three uint32 arrays (rng_host.HostRng.state_arrays, a
    checkpoint)."""
    return WhRngState(*(torch.as_tensor(a, device=device).to(torch.int64)
                        for a in (x, y, z)))


def _wh_step(x, y, z):
    """One AS183 step in uint32 arithmetic (reference src/utils.c:504-513)."""
    x = (171 * (x % 177) - 2 * (x // 177)) & MASK32
    y = (172 * (y % 176) - 35 * (y // 176)) & MASK32
    z = (170 * (z % 178) - 63 * (z // 178)) & MASK32
    return x, y, z


@functools.lru_cache(maxsize=None)
def _divisors(device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.full((), d, dtype=F64, device=device)
                 for d in (30269.0, 30307.0, 30323.0))


def _unit(x, y, z) -> torch.Tensor:
    dx, dy, dz = _divisors(x.device)
    r = (x.to(F64) / dx + y.to(F64) / dy) + z.to(F64) / dz
    return r - torch.trunc(r)


def _mask(mask, state: WhRngState) -> torch.Tensor:
    return torch.as_tensor(mask, device=state.x.device).expand(
        state.x.shape)


def _wh_rndu(state: WhRngState, mask) -> Tuple[torch.Tensor, WhRngState]:
    m = _mask(mask, state)
    nx, ny, nz = _wh_step(*state)
    x = torch.where(m, nx, state.x)
    y = torch.where(m, ny, state.y)
    z = torch.where(m, nz, state.z)
    return _unit(x, y, z), WhRngState(x, y, z)


def _wh_rndnormal(state: WhRngState, mask
                  ) -> Tuple[torch.Tensor, WhRngState]:
    """Marsaglia-Bray polar method with per-lane rejection (reference
    src/utils.c:459-477): a lane of the mask draws pairs of uniforms until
    it accepts; accepted lanes and lanes outside the mask stop."""
    m = _mask(mask, state)
    val = torch.zeros(state.x.shape, dtype=F64, device=state.x.device)
    done = ~m
    while bool((m & ~done).any()):
        active = m & ~done
        u, state = _wh_rndu(state, active)
        v, state = _wh_rndu(state, active)
        u = 2.0 * u - 1.0
        v = 2.0 * v - 1.0
        s = u * u + v * v
        ok = (s > 0.0) & (s < 1.0)
        s_safe = torch.where(ok, s, torch.full_like(s, 0.5))
        draw = u * torch.sqrt(-2.0 * torch.log(s_safe) / s_safe)
        val = torch.where(active & ok, draw, val)
        done = done | (active & ok)
    return val, state


def _wh_rnd2normal8(state: WhRngState, mask
                    ) -> Tuple[torch.Tensor, WhRngState]:
    """Mixture of two normals (reference src/utils.c:482-495)."""
    n, state = _wh_rndnormal(state, mask)
    zval = M2N + n * S2N
    u, state = _wh_rndu(state, mask)
    return torch.where(u < 0.5, zval, -zval), state


def rndu(state, mask, dtype=F64):
    """U(0,1) per lane of `mask` (fast streams: every lane).  Returns
    (u [K] of dtype, state)."""
    if isinstance(state, FastRngState):
        return RF.rndu(state, dtype)
    u, state = _wh_rndu(state, mask)
    return u.to(dtype), state


def rndnormal(state, mask, dtype=F64):
    if isinstance(state, FastRngState):
        return RF.rndnormal(state, dtype)
    n, state = _wh_rndnormal(state, mask)
    return n.to(dtype), state


def rnd2normal8(state, mask, dtype=F64):
    if isinstance(state, FastRngState):
        return RF.rnd2normal8(state, dtype)
    z, state = _wh_rnd2normal8(state, mask)
    return z.to(dtype), state


def rndexp(state, mask, mean, dtype=F64):
    """Exponential of the given mean (reference src/utils.h:27)."""
    if isinstance(state, FastRngState):
        return RF.rndexp(state, mean, dtype)
    u, state = _wh_rndu(state, mask)
    return (-mean * torch.log(u)).to(dtype), state


def _scalar(x: torch.Tensor, state: FastRngState) -> torch.Tensor:
    """One chain's draw as a 0-d tensor; C chains' draws stay [C]."""
    return x[0] if state.ctr.dim() == 0 else x


def _general_mask(state: WhRngState, active) -> torch.Tensor:
    """`active` against a Wichmann-Hill general stream: one chain's stream
    is [1] and takes a bool or a 0-d mask; C chains' streams are [C, 1]
    and take a [C] mask (or one for all chains)."""
    m = torch.as_tensor(active, device=state.x.device)
    if state.x.dim() == 2 and m.dim() == 1:
        m = m[:, None]
    return m


def general_draw_u(state, dtype, active=True):
    """Scalar U(0,1) from a size-1 (general) stream ([C] from the general
    streams of C chains).  A Wichmann-Hill stream draws only where
    `active` (a bool or a 0-d bool tensor; [C] for C chains, whose
    streams are [C, 1]) holds: a chain whose lane is off keeps its
    state."""
    if isinstance(state, FastRngState):
        u, new = RF.rndu(state, dtype)
        return _scalar(u, state), new
    u, new = _wh_rndu(state, _general_mask(state, active))
    return u[..., 0].to(dtype), new


def general_draw_2normal8(state, dtype, active=True):
    """Scalar rnd2normal8 from a size-1 (general) stream ([C] for C
    chains); see general_draw_u for `active`."""
    if isinstance(state, FastRngState):
        z, new = RF.rnd2normal8(state, dtype)
        return _scalar(z, state), new
    z, new = _wh_rnd2normal8(state, _general_mask(state, active))
    return z[..., 0].to(dtype), new
