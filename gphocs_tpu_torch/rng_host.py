"""Host-side (numpy) twin of the legacy RNG streams in rng.py.

Used for one-time host work: initial genealogy simulation, prior sampling,
and synthetic-data generation.  Produces *bit-identical* streams to the C
reference (exact uint32 arithmetic + python-float division, which is IEEE
correctly rounded — unlike XLA's).
"""

from __future__ import annotations

import numpy as np

_M2N = float(np.sqrt(8.0 / 9.0))
_S2N = float(np.sqrt(1.0 / 9.0))


class HostRng:
    """Per-slot Wichmann-Hill streams (reference src/utils.c:400-617)."""

    def __init__(self, num_slots: int, seed: int, legacy: bool = True):
        self.n = num_slots
        seed = int(seed) & 0xFFFFFFFF
        if legacy:
            z = (170 * (seed % 178) + 137) & 0xFFFFFFFF
            self.x = np.full(num_slots, 11, np.uint64)
            self.y = np.full(num_slots, 23, np.uint64)
            self.z = np.full(num_slots, z, np.uint64)
        else:
            r = np.random.RandomState(seed)
            self.x = r.randint(1, 30000, num_slots).astype(np.uint64)
            self.y = r.randint(1, 30000, num_slots).astype(np.uint64)
            self.z = r.randint(1, 30000, num_slots).astype(np.uint64)

    @property
    def general_slot(self) -> int:
        return self.n - 1

    def state_arrays(self):
        """Current state as uint32 arrays (to hand over to rng.RngState)."""
        return (self.x.astype(np.uint32), self.y.astype(np.uint32),
                self.z.astype(np.uint32))

    def rndu(self, i: int) -> float:
        M = 0xFFFFFFFF
        x, y, z = int(self.x[i]), int(self.y[i]), int(self.z[i])
        x = (171 * (x % 177) - 2 * (x // 177)) & M
        y = (172 * (y % 176) - 35 * (y // 176)) & M
        z = (170 * (z % 178) - 63 * (z // 178)) & M
        self.x[i], self.y[i], self.z[i] = x, y, z
        r = x / 30269.0 + y / 30307.0 + z / 30323.0
        return r - int(r)

    def rndnormal(self, i: int) -> float:
        while True:
            u = 2.0 * self.rndu(i) - 1.0
            v = 2.0 * self.rndu(i) - 1.0
            s = u * u + v * v
            if 0.0 < s < 1.0:
                break
        return u * np.sqrt(-2.0 * np.log(s) / s)

    def rnd2normal8(self, i: int) -> float:
        z = _M2N + self.rndnormal(i) * _S2N
        return z if self.rndu(i) < 0.5 else -z

    def rndexp(self, i: int, mean: float) -> float:
        return -mean * np.log(self.rndu(i))
