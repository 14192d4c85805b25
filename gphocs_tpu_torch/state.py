"""MCMC state as fixed-shape tensors batched over loci (torch twin of
gphocs_tpu/state.py: same three NamedTuples, same fields and shapes).

  * `GenState`  — genealogies + migration events, [L, ...] tensors
  * `SeqData`   — static phased site-pattern data, [L, S, P] tensors
  * `Params`    — population-tree parameters (theta/tau/sample ages/mig rates)

Index fields are int64 (torch's index type) where the JAX package uses
int32; masks are bool; real fields carry the sampler's dtype.  Rejected
proposals are selected away with `torch.where`, never written back, as in
the JAX package.

`from_numpy` / `to_numpy` are the bridge between the two packages: they
convert any of these NamedTuples (or the RNG state, finetunes, ...) field
by field, so a state built by the JAX sampler can be carried into the port
as `np.asarray` of its arrays.

C chains: the JAX package stacks them on a leading axis ([C, L, ...] per
locus, [C, P] parameters, [C] counters, general-stream keys [C, 1]); the
port keeps its per-locus tensors chain-major, [C * L, ...], beside [C, P]
parameters and [C] counters and keys (kernels/common.py).
`from_numpy(..., chains=True)` and `to_numpy(..., chains=C)` convert
between the two.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class GenState(NamedTuple):
    """Per-locus genealogy + migration events.  L loci, N=2S-1 nodes, M mig slots."""

    father: torch.Tensor     # [L, N] int64, -1 for root
    lson: torch.Tensor       # [L, N] int64, -1 for leaves
    rson: torch.Tensor       # [L, N] int64, -1 for leaves
    age: torch.Tensor        # [L, N] float
    node_pop: torch.Tensor   # [L, N] int64
    root: torch.Tensor       # [L] int64
    mig_branch: torch.Tensor  # [L, M] int64; child node of the edge carrying the event; -1 = free slot
    mig_band: torch.Tensor   # [L, M] int64
    mig_age: torch.Tensor    # [L, M] float
    mut_rate: torch.Tensor   # [L] float, relative locus mutation rate
    valid: torch.Tensor      # [L] bool; False for padding loci

    @property
    def num_loci(self) -> int:
        return self.father.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.father.shape[1]

    @property
    def num_samples(self) -> int:
        return (self.father.shape[1] + 1) // 2

    @property
    def max_migs(self) -> int:
        return self.mig_branch.shape[1]


class SeqData(NamedTuple):
    """Phased site-pattern data (static during sampling); P = padded
    phased-pattern capacity (see gphocs_tpu/state.py)."""

    leaf_base: torch.Tensor     # [L, S, P] int: 0..3 = TCAG, 4 = N/missing
    group_id: torch.Tensor      # [L, P] int64 phase-group segment id in [0, P)
    group_count: torch.Tensor   # [L, P] float: site count of group g at index g
    group_nphases: torch.Tensor  # [L, P] float: #phases of group g at index g
    pattern_valid: torch.Tensor  # [L, P] bool
    # [L, J, P] int: the j-th pattern of group g at [l, j, g], P past the
    # group's end (io/sequences.group_members); None: derived on use
    group_members: Optional[torch.Tensor] = None


class Params(NamedTuple):
    """Population-tree parameters."""

    theta: torch.Tensor       # [P]
    tau: torch.Tensor         # [P]: age of each pop (0 for current pops)
    sample_age: torch.Tensor  # [P]: ancient-sample age per (current) pop
    mig_rate: torch.Tensor    # [B]
    admix_coeff: Optional[torch.Tensor] = None  # [A]


def _to_tensor(x, device, dtype) -> torch.Tensor:
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.kind == "f":
        t = torch.as_tensor(a, dtype=dtype)
    elif a.dtype.kind == "b":
        t = torch.as_tensor(a, dtype=torch.bool)
    else:
        # int32 indices and uint32 RNG keys/counters both fit int64
        t = torch.as_tensor(a.astype(np.int64))
    return t.to(device)


def from_numpy(obj, cls=None, *, device="cpu", dtype=torch.float64,
               chains: bool = False):
    """Convert a NamedTuple of arrays (numpy, or anything np.asarray takes)
    into `cls` (default: the same type) holding tensors on `device`.

    Real arrays take `dtype`, bool arrays stay bool, integer arrays become
    int64.  A single array converts to a single tensor; None stays None.
    chains=True takes the JAX package's stacked chains of a per-locus
    state or stream: the two leading axes of every array of two or more
    dimensions merge ([C, L, ...] -> [C * L, ...], keys [C, 1] -> [C]);
    the counters [C] stay."""
    if obj is None:
        return None
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = cls or type(obj)
        return cls(**{f: from_numpy(getattr(obj, f), device=device,
                                    dtype=dtype, chains=chains)
                      for f in cls._fields if hasattr(obj, f)})
    if chains and np.ndim(obj) >= 2:
        a = np.asarray(obj)
        obj = a.reshape(-1, *a.shape[2:])
    return _to_tensor(obj, device, dtype)


def to_numpy(obj, chains: int = 0):
    """Inverse of from_numpy: tensors -> numpy arrays, field by field.
    chains=C gives a per-locus state's arrays of C chains the JAX
    package's leading chain axis ([C * L, ...] -> [C, L, ...]; an array
    of C entries or fewer, a counter, stays)."""
    if obj is None:
        return None
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v, chains) for v in obj))
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().numpy()
    else:
        a = np.asarray(obj)
    if chains and a.ndim and a.shape[0] > chains:
        a = a.reshape(chains, -1, *a.shape[1:])
    return a
