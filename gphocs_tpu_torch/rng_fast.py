"""Counter-based per-locus RNG streams (torch twin of gphocs_tpu/rng_fast.py).

Draw k of lane l is fmix32(key[l] ^ fmix32((ctr + k) * GOLDEN)): stateless,
so the plain versions here, the JAX package and the CUDA kernels
(csrc/sweeps_common.cuh) all read the same bits at the same offsets.

uint32 arithmetic is carried in int64 under a 0xFFFFFFFF mask (torch has
no uint32 shift/add on the CPU).  Products are split into 16-bit halves
so that no int64 product overflows.

Keys and counter are int64 tensors holding uint32 values; the counter is a
0-d tensor on the sampler's device, so advancing it never synchronizes
with the host.  A state of C chains (sampler/driver.py, `chains=C`) keeps
one counter per chain, [C], over the keys of all chains, chain-major
([C * K] for the per-locus streams, [C] for the general stream): lane l
reads the counter of chain l // K.

`init_fast` gives gphocs_tpu's keys for the same seed: the raw per-lane
bits are jax.random.bits(jax.random.key(seed), (n,), uint32) under JAX's
default generator (Threefry-2x32, partitionable counter layout), computed
here in numpy (`threefry_bits`), followed by the same
`fmix32(bits ^ fmix32(lane * GOLDEN))` lane mix.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gphocs_tpu_torch.profiling import span

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
# mixture-kernel constants (reference src/utils.c:437-441: m2s2 = 8)
M2N = math.sqrt(8.0 / 9.0)
S2N = math.sqrt(1.0 / 9.0)


class FastRngState(NamedTuple):
    """Per-lane keys + a shared draw counter; advancing = ctr + 1."""

    key: torch.Tensor   # [K] (chains: [C * K]) int64 holding uint32
    ctr: torch.Tensor   # [] (chains: [C]) int64 holding uint32


def lane_ctr(state: FastRngState) -> torch.Tensor:
    """The counter of every lane: the 0-d counter of one chain, or each
    chain's counter repeated over its lanes."""
    ctr = state.ctr
    K, C = state.key.shape[0], ctr.shape[0] if ctr.dim() else 0
    if C in (0, K):
        return ctr
    return ctr[:, None].expand(C, K // C).reshape(K)


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for z in [0, 2^32), without int64 overflow."""
    lo = (z & 0xFFFF) * c
    hi = ((z >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def fmix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: a full-avalanche 32-bit mix."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    z = z ^ (z >> 16)
    return z


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry_bits(seed: int, n: int) -> np.ndarray:
    """[n] uint32: jax.random.bits(jax.random.key(seed), (n,), uint32) for
    the threefry2x32 generator with jax_threefry_partitionable set (the
    defaults of the JAX that gphocs_tpu pins).

    The key is the seed's 64-bit two's-complement pattern split into
    (high, low) words, as JAX forms it with 64-bit integers enabled.
    Element i hashes the counter pair (high, low) = (0, i) with the 20-round
    Threefry-2x32 block function, and the output is the xor of its two
    words."""
    seed &= (1 << 64) - 1
    k0 = np.uint32(seed >> 32)
    k1 = np.uint32(seed & MASK32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):  # uint32 arithmetic wraps by design
        x0 = np.zeros(n, np.uint32) + ks[0]
        x1 = np.arange(n, dtype=np.uint32) + ks[1]
        for block in range(5):
            for r in _THREEFRY_ROTATIONS[block % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(block + 1) % 3]
            x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0 ^ x1


def init_fast(num_slots: int, seed: int, device="cpu") -> FastRngState:
    bits = torch.as_tensor(threefry_bits(seed, num_slots).astype(np.int64),
                           device=device)
    lane = torch.arange(num_slots, dtype=torch.int64, device=device)
    return FastRngState(key=fmix32(bits ^ fmix32(_mul32(lane, GOLDEN))),
                        ctr=torch.zeros((), dtype=torch.int64, device=device))


def bits_to_unit(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint32 bits -> U(0,1) of `dtype`, never exactly 0 or 1.

    f32: exponent bitcast ((x >> 9) | 0x3F800000 is a float in [1, 2)),
    shifted to the open interval by the exact subtraction f - (1 - 2^-24).
    f64: midpoint lattice (x + 0.5) / 2^32.  Both as in gphocs_tpu."""
    if dtype == torch.float32:
        f = ((x >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return f - (1.0 - 2.0 ** -24)
    return (x.to(dtype) + 0.5) * (2.0 ** -32)


def raw_bits(key: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """fmix32(key ^ fmix32(ctr * GOLDEN)); ctr broadcasts against key."""
    with span("rng_hash"):
        return fmix32(key ^ fmix32(_mul32(ctr & MASK32, GOLDEN)))


def raw_u(state: FastRngState, offset, dtype) -> torch.Tensor:
    """U(0,1) for every lane at counter position ctr+offset (stateless).
    `offset` may be an int or a per-lane int64 tensor."""
    return bits_to_unit(raw_bits(state.key, lane_ctr(state) + offset), dtype)


def bump(state: FastRngState, n) -> FastRngState:
    return state._replace(ctr=(state.ctr + n) & MASK32)


def rndu(state: FastRngState, dtype) -> Tuple[torch.Tensor, FastRngState]:
    return raw_u(state, 1, dtype), bump(state, 1)


def rndnormal(state: FastRngState, dtype
              ) -> Tuple[torch.Tensor, FastRngState]:
    """Standard normal via Box-Muller — loop-free."""
    u1 = raw_u(state, 1, dtype)
    u2 = raw_u(state, 2, dtype)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(2.0 * math.pi * u2), bump(state, 2)


def rnd2normal8(state: FastRngState, dtype
                ) -> Tuple[torch.Tensor, FastRngState]:
    n, state = rndnormal(state, dtype)
    zval = M2N + n * S2N
    u = raw_u(state, 1, dtype)
    state = bump(state, 1)
    return torch.where(u < 0.5, zval, -zval), state


def rndexp(state: FastRngState, mean, dtype
           ) -> Tuple[torch.Tensor, FastRngState]:
    u, state = rndu(state, dtype)
    return -mean * torch.log(u), state


def _raw_u_batch(state: FastRngState, n: int, offset: int, dtype):
    """[n] uniforms from lane 0 at counter positions ctr+offset+0..n-1;
    [C, n] from each chain's lane of a chains' general stream."""
    c = state.ctr[..., None] + offset + torch.arange(
        n, dtype=torch.int64, device=state.key.device)
    key = state.key[0] if state.ctr.dim() == 0 else state.key[:, None]
    return bits_to_unit(raw_bits(key, c), dtype)


def batch_u(state: FastRngState, n: int, dtype
            ) -> Tuple[torch.Tensor, FastRngState]:
    """[n] U(0,1) draws from the (scalar) general stream in one step
    ([C, n] for C chains)."""
    return _raw_u_batch(state, n, 1, dtype), bump(state, n)


def normal8(u1, u2, u3) -> torch.Tensor:
    """The mixture-kernel draw of rnd2normal8 from its three uniforms:
    Box-Muller from u1, u2, the sign from u3."""
    nrm = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    zval = M2N + nrm * S2N
    return torch.where(u3 < 0.5, zval, -zval)


def batch_2normal8(state: FastRngState, n: int, dtype
                   ) -> Tuple[torch.Tensor, FastRngState]:
    """[n] ([C, n]) mixture-kernel draws from the general stream in one
    step."""
    u1 = _raw_u_batch(state, n, 1, dtype)
    u2 = _raw_u_batch(state, n, 1 + n, dtype)
    u3 = _raw_u_batch(state, n, 1 + 2 * n, dtype)
    return normal8(u1, u2, u3), bump(state, 3 * n)
