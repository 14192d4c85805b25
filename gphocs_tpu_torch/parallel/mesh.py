"""Loci sharding over torch.distributed: the port's counterpart of
gphocs_tpu/parallel/mesh.py and of gphocs_tpu's shard_map path over its
1-D `loci` mesh axis.

One process per rank.  Rank r holds the contiguous block [r * Lb / W,
(r + 1) * Lb / W) of the Lb (padded) loci of every pattern bucket, as
P("loci") places them, and runs the four kernels on that block on its own
device.  C chains (one bucket) are held chain-major, [C * Lp, ...], each
chain's Lp loci padded on their own: rank r holds its block of every
chain, rows [c Lp + r Ls, c Lp + (r + 1) Ls) for c = 0 .. C-1 with
Ls = Lp / W (`LociMesh.chain_block`), which is again chain-major,
[C * Ls, ...], so the kernels run its C chains of Ls loci at once.  The
population parameters, the general streams, the finetunes and the
Context are replicated: every rank draws the same general-stream values,
and every reduction across loci is an explicit all-reduce at the place
where gphocs_tpu has its maybe_psum / maybe_pmax (kernels/common.py), so
every rank takes the same global decisions; with chains each carries a
value per chain.
Reductions that fall at the same point travel in one float64 tensor
(`all_reduce`); a max that travels beside sums goes as a sum of 0/1
flags.  The conformance mode's serial rate update (kernels/locus_rate.py)
hands its carry from rank to rank with `broadcast`, one float64 tensor
sent by one rank: W of them per update, in rank order.

The loci are padded to a multiple of the world size with inert loci
(`pad_seq`, `pad_bucket`): valid False, zero pattern counts, one phase,
so their likelihood is 0 and every sum masks them out.

The backend follows one rule, which rank 0 prints: NCCL where every rank
has a card of its own (CUDA ranks, no more of them than the cards of the
host), gloo where ranks share a card or run on the CPU.  A backend that
fails to initialise raises; nothing switches to the other one.  The
process group has a timeout, so a rank that fails or takes another
branch makes the others fail instead of waiting forever.

Gloo's all_gather takes CPU tensors only (its all_reduce and broadcast
take CUDA tensors too): the host-side gathers of checkpoints and of
admixture-trace.out (`gather_rows`) go through the CPU under gloo.
`gather_rows(mesh, x, C)` puts the ranks' chain-major blocks back in
the global chain-major order; a plain rank-order concatenation would
give [W, C, Ls] order, a state that runs but is wrong.
"""

from __future__ import annotations

import datetime
import socket
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gphocs_tpu_torch.rng_fast import GOLDEN, MASK32

DEFAULT_TIMEOUT_S = 600.0

# all-reduces, broadcasts and gathers since the last
# reset_collective_counts(), and the host's seconds inside each kind
# ("seconds": the all-reduces'; gloo waits for the device at every
# collective; NCCL's host time is the enqueue)
COLLECTIVES = {"all_reduce": 0, "seconds": 0.0, "broadcast": 0,
               "broadcast_seconds": 0.0, "all_gather": 0,
               "all_gather_seconds": 0.0}

_DEVICE: Optional[torch.device] = None


def reset_collective_counts() -> None:
    COLLECTIVES.update(all_reduce=0, seconds=0.0, broadcast=0,
                       broadcast_seconds=0.0, all_gather=0,
                       all_gather_seconds=0.0)


@dataclass(frozen=True)
class LociMesh:
    """One rank's view of the loci mesh."""

    rank: int
    world: int
    backend: str            # "nccl" or "gloo"
    device: torch.device    # where this rank's state lives
    group: object = None    # the process group (None: the default one)

    def block(self, n: int) -> slice:
        """This rank's rows of n (a multiple of the world size) loci."""
        lo, hi = shard_bounds(n, self.world)[self.rank]
        return slice(lo, hi)

    def chain_block(self, n: int, chains: int) -> np.ndarray:
        """The index array of this rank's rows of `chains` chains of n
        loci each (n a multiple of the world size), held chain-major: its
        block of every chain, in chain order.  gather_rows inverts it."""
        b = self.block(n)
        return (np.arange(chains)[:, None] * n
                + np.arange(b.start, b.stop)).reshape(-1)

    def barrier(self) -> None:
        all_reduce(self, [torch.zeros(1, device=self.device)])


def shard_bounds(n: int, world: int) -> list:
    """[(lo, hi)] per rank: the contiguous equal blocks of n loci that
    P("loci") gives; n must be a multiple of world."""
    if n % world:
        raise ValueError(f"{n} loci do not split into {world} equal blocks "
                         "(pad them first)")
    per = n // world
    return [(r * per, (r + 1) * per) for r in range(world)]


def backend_for(world: int, device_type: str) -> str:
    """The fixed rule: NCCL where every rank has a card of its own."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """cuda:(rank % the host's cards), or the CPU where asked for."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def free_port() -> int:
    """A free TCP port of this host, for rank 0's address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coord: str, num_processes: int, process_id: int,
                     device: str = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group of `num_processes` ranks as rank
    `process_id`; `coord` is rank 0's host:port.  device: "cuda" (the
    rank's card, rank_device) or "cpu".  Returns the backend."""
    global _DEVICE
    dev_type = torch.device(device).type
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed(device='cuda'): no CUDA device")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of "
                         f"{num_processes}")
    backend = backend_for(num_processes, dev_type)
    _DEVICE = rank_device(process_id, dev_type)
    if dev_type == "cuda":
        torch.cuda.set_device(_DEVICE)
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    if process_id == 0:
        why = ("every rank has a card of its own" if backend == "nccl"
               else "ranks on the CPU" if dev_type == "cpu"
               else "ranks share a card")
        print(f"loci mesh: {num_processes} rank(s), backend {backend} "
              f"({why})", flush=True)
    return backend


def make_mesh() -> LociMesh:
    """The LociMesh of this process (after init_distributed)."""
    if not dist.is_initialized() or _DEVICE is None:
        raise RuntimeError("make_mesh: call init_distributed first")
    return LociMesh(rank=dist.get_rank(), world=dist.get_world_size(),
                    backend=dist.get_backend(), device=_DEVICE,
                    group=dist.group.WORLD)


def shutdown() -> None:
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def _pack(mesh: LociMesh, xs: Sequence):
    xs = [torch.as_tensor(x, device=mesh.device) for x in xs]
    return xs, torch.cat([x.reshape(-1).to(torch.float64) for x in xs])


def _unpack(xs: list, flat: torch.Tensor) -> list:
    out, off = [], 0
    for x in xs:
        n = x.numel()
        out.append(flat[off:off + n].reshape(x.shape).to(x.dtype))
        off += n
    return out


def all_reduce(mesh: LociMesh, xs: Sequence, op: str = "sum") -> list:
    """xs reduced over the ranks ("sum" or "max"), in one all-reduce of
    one float64 tensor; each comes back in its own dtype and shape (a
    bool summed over ranks is True where any rank's is).  Exact for
    integer counts below 2^53 and for a world of one."""
    xs, flat = _pack(mesh, xs)
    t0 = time.perf_counter()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=mesh.group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return _unpack(xs, flat)


def broadcast(mesh: LociMesh, xs: Sequence, src: int) -> list:
    """Rank `src`'s xs on every rank, in one broadcast of one float64
    tensor; each comes back in its own dtype and shape (every rank passes
    tensors of the same shapes; the others' values are dropped).  Bitwise
    for every f32/f64 value, bools and integers below 2^53."""
    xs, flat = _pack(mesh, xs)
    t0 = time.perf_counter()
    dist.broadcast(flat, src=src, group=mesh.group)
    COLLECTIVES["broadcast"] += 1
    COLLECTIVES["broadcast_seconds"] += time.perf_counter() - t0
    return _unpack(xs, flat)


def gather_rows(mesh: LociMesh, x: torch.Tensor,
                chains: int) -> torch.Tensor:
    """The ranks' blocks of x, each [C * Ls, ...] (LociMesh.chain_block's
    rows of C = `chains` chains), in the global chain-major order, [C * W
    Ls, ...], on the CPU of every rank (through the device under NCCL,
    through the CPU under gloo).  For one chain that is rank order."""
    src = x.detach()
    src = src.cpu() if mesh.backend == "gloo" else src.to(mesh.device)
    is_bool = src.dtype == torch.bool
    src = (src.to(torch.uint8) if is_bool else src).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    t0 = time.perf_counter()
    dist.all_gather(parts, src, group=mesh.group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["all_gather_seconds"] += time.perf_counter() - t0
    out = torch.stack(parts).cpu()                  # [W, C * Ls, ...]
    out = out.view(mesh.world, chains, -1, *src.shape[1:]).transpose(0, 1)
    out = out.reshape(-1, *src.shape[1:])
    return out.to(torch.bool) if is_bool else out


# -- the padding rule (gphocs_tpu/sampler/driver.py:233-258, 352-373) --

def pad_seq(seq, pad: int):
    """A numpy SeqData with `pad` inert loci appended: copies of its first
    locus with zero pattern counts, one phase and no valid pattern."""
    if not pad:
        return seq

    def rep(a, fill=None):
        rows = np.repeat(a[:1], pad, axis=0)
        if fill is not None:
            rows = np.full_like(rows, fill)
        return np.concatenate([a, rows])

    return type(seq)(
        leaf_base=rep(seq.leaf_base), group_id=rep(seq.group_id),
        group_count=rep(seq.group_count, 0),
        group_nphases=rep(seq.group_nphases, 1),
        pattern_valid=rep(seq.pattern_valid, False),
        group_members=(None if seq.group_members is None
                       else rep(seq.group_members)))


def pad_bucket(gen, key: torch.Tensor, pad: int):
    """A bucket's genealogies and per-locus keys with `pad` inert loci
    appended: copies of its first locus with valid False, and keys
    key[0] + i * 0x9E3779B9 (mod 2^32), i = 1..pad."""
    if not pad:
        return gen, key
    gen = type(gen)(*(torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
                      for x in gen))
    n = gen.valid.shape[0] - pad
    valid = gen.valid.clone()
    valid[n:] = False
    i = torch.arange(1, pad + 1, dtype=key.dtype, device=key.device)
    return (gen._replace(valid=valid),
            torch.cat([key, (key[:1] + i * GOLDEN) & MASK32]))
