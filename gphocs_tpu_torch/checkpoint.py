"""Checkpoint / resume (twin of gphocs_tpu/checkpoint.py, same file).

The reference has no resume: a killed run keeps its flushed trace and
loses the sampler's state (SURVEY §5).  Here the whole state of a sampler
(genealogies, parameters, both RNG streams, carried conditionals and
likelihoods, finetune searches, the iteration) goes into one .npz, so a
run resumes bit for bit as the uninterrupted run would go on.

The file is gphocs_tpu's: the same keys, dtypes (int32 indices, uint32
RNG keys and counters, the sampler's float dtype) and format version, so a
checkpoint written by either package resumes in the other.  The streams
are `lrng_key`/`lrng_ctr` and `grng_key`/`grng_ctr` for the fast RNG, and
the Wichmann-Hill states `lrng_x`, `lrng_y`, `lrng_z` ([L]) and `grng_x`,
`grng_y`, `grng_z` ([1]), uint32, for the legacy RNG (one bucket; C
chains' [C, L] and [C, 1]; on a mesh the per-locus ones gathered like
the genealogies, the general ones rank 0's, as every rank holds them).
An unbucketed sampler writes `gen_*`, `lrng_*`, `lnld`, `lnp`, `cond`; a
bucketed one `b<k>_*` per bucket.  The conditionals are [L, N, P, 4] in both packages;
a file written on a TPU with the Pallas kernels' lane layout is not.  A
sampler of C chains writes gphocs_tpu's stacked layout: a leading chain
axis on every per-chain array ([C, L, ...] per locus, [C, P] parameters,
[C] counters, the general streams' keys and Wichmann-Hill states
[C, 1]).  The admixture
coefficients are `params_admix_coeff`, [A] ([C, A]), with A = 0 where the
run has no admixed leaves.

On a loci mesh the file is the one gphocs_tpu writes for the same mesh
run: the padded loci of every bucket, gathered from the ranks in rank
order (C chains: every chain's Lp padded loci, [C, Lp, ...], each
gathered from the ranks' blocks of it), written by rank 0 (every rank
takes part in the gathers).  It is the file of one process running the
same chains with `loci_multiple` = the world size, and each resumes in
the other.  On resume every rank reads the file and keeps its block (of
every chain: the sampler's `blocks`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch.parallel.mesh import gather_rows
from gphocs_tpu_torch.rng_fast import FastRngState
from gphocs_tpu_torch.state import GenState, Params, from_numpy

_FORMAT_VERSION = 2  # v2: conditionals carry the x4-per-node rescale


def _np(t: torch.Tensor, real) -> np.ndarray:
    """A state tensor as gphocs_tpu stores it: int32 indices, bool masks,
    reals at `real`."""
    a = t.detach().cpu().numpy()
    if a.dtype.kind == "f":
        return a.astype(real)
    if a.dtype.kind == "b":
        return a
    return a.astype(np.int32)


def _rng_np(pfx: str, st, C: int) -> dict:
    """A stream's arrays as gphocs_tpu stores them, uint32: a fast one's
    key and counter, a Wichmann-Hill one's x, y, z; for C chains the
    keys and states [C, K] (the general streams [C, 1])."""
    def u32(t):
        a = t.cpu().numpy().astype(np.uint32)
        return a if C == 1 else a.reshape(C, -1)

    if isinstance(st, R.WhRngState):
        return {f"{pfx}_{f}": u32(getattr(st, f)) for f in st._fields}
    return {f"{pfx}_key": u32(st.key),
            f"{pfx}_ctr": st.ctr.cpu().numpy().astype(np.uint32)}


def save_checkpoint(sampler, path: str, iteration: int) -> None:
    """Write the sampler's state to `path` (through a temporary file and a
    rename, so a crash never leaves half a checkpoint)."""
    real = np.float32 if sampler.dtype == torch.float32 else np.float64
    C = getattr(sampler, "chains", 1)
    mesh = getattr(sampler, "mesh", None)

    def rows(t):  # every rank's loci, chain-major for C chains
        return t if mesh is None else gather_rows(mesh, t, C)

    def per_locus(t):  # C chains' [C * L, ...] as [C, L, ...]
        a = _np(rows(t), real)
        return a if C == 1 else a.reshape(C, -1, *a.shape[1:])

    arrays = {"n_buckets": np.asarray(sampler.buckets)}
    if sampler.buckets > 1:
        pre = [f"b{k}_" for k in range(sampler.buckets)]
    else:
        pre = [""]
    for k, p in enumerate(pre):
        for name, val in sampler.gens[k]._asdict().items():
            arrays[f"{p}gen_{name}"] = per_locus(val)
        lrng = sampler.lrngs[k]
        if isinstance(lrng, FastRngState):
            lrng = lrng._replace(key=rows(lrng.key))
        else:
            lrng = R.WhRngState(*(rows(f) for f in lrng))
        arrays.update(_rng_np(f"{p}lrng", lrng, C))
        arrays[f"{p}lnld"] = per_locus(sampler.lnlds[k])
        arrays[f"{p}lnp"] = per_locus(sampler.lnps[k])
        # saved, not rebuilt on load: a rebuild may differ in the last bit
        # from the carried values
        arrays[f"{p}cond"] = per_locus(sampler.conds[k])
    for name in Params._fields:
        arrays[f"params_{name}"] = _np(getattr(sampler.params, name), real)
    arrays.update(_rng_np("grng", sampler.grng, C))
    arrays["iteration"] = np.asarray(iteration)
    arrays["rate_var"] = np.asarray(sampler.rate_var)
    arrays["format_version"] = np.asarray(_FORMAT_VERSION)
    for k, v in sampler.ft_search.items():
        arrays[f"ft_{k}"] = np.asarray([v.value, v.lo, v.hi])
    arrays["ft_taus"] = np.asarray(
        [[t.value, t.lo, t.hi] for t in sampler.ft_taus])
    if mesh is not None and mesh.rank != 0:
        return
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(sampler, path: str) -> int:
    """Restore the state of an initialized sampler from `path`; returns
    the iteration to go on from.  A rank of a loci mesh keeps its block of
    every bucket's loci."""
    data = np.load(path)
    if int(data["format_version"]) != _FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format "
                         f"{int(data['format_version'])}, this package reads "
                         f"{_FORMAT_VERSION}")
    legacy = "grng_x" in data
    if legacy != (getattr(sampler, "rng_mode", "fast") == "legacy"):
        raise ValueError(f"{path}: a checkpoint of the "
                         f"{'legacy' if legacy else 'fast'} RNG, this "
                         f"sampler runs the {sampler.rng_mode} RNG")
    n_buckets = int(data["n_buckets"]) if "n_buckets" in data else 1
    if n_buckets != sampler.buckets:
        raise ValueError(
            f"checkpoint bucket count ({n_buckets}) does not match the "
            f"sampler ({sampler.buckets}); a non-bucketed checkpoint cannot "
            "resume a bucketed run (and vice versa)")
    conv = dict(device=sampler.device, dtype=sampler.dtype)
    C = getattr(sampler, "chains", 1)
    file_chains = (data["params_theta"].shape[0]
                   if data["params_theta"].ndim == 2 else 1)
    if file_chains != C:
        raise ValueError(f"{path}: a checkpoint of {file_chains} chain(s), "
                         f"this sampler runs {C}")

    blocks = getattr(sampler, "blocks", None) or [slice(None)] * n_buckets

    def per_locus(a, k):  # [C, L, ...] as the state's [C * L, ...]
        a = a if C == 1 else a.reshape(-1, *a.shape[2:])
        return from_numpy(a[blocks[k]], **conv)

    def rng(pre, block=slice(None)):
        if legacy:  # one bucket
            # per-locus [C, L] as [C * L], the rank's block of it; the
            # general streams stay [C, 1]
            return R.from_arrays(*(
                data[f"{pre}_{f}"].reshape(-1)[block] if pre.endswith("lrng")
                else data[f"{pre}_{f}"] for f in "xyz"),
                device=sampler.device)
        key = data[f"{pre}_key"]
        return FastRngState(key=from_numpy(key.reshape(-1)[block], **conv),
                            ctr=from_numpy(data[f"{pre}_ctr"], **conv))

    admix = data["params_admix_coeff"]
    A = sampler.ctx.num_admixed
    if admix.shape[-1] != A:
        raise ValueError(f"{path}: a checkpoint of {admix.shape[-1]} "
                         f"admixed leaves, this sampler has {A}")
    sampler.params = Params(**{
        name: from_numpy(data[f"params_{name}"], **conv)
        for name in Params._fields})
    sampler.grng = rng("grng")
    pre = ([f"b{k}_" for k in range(n_buckets)] if n_buckets > 1 else [""])
    gens, lrngs, lnlds, lnps, conds = [], [], [], [], []
    rows = getattr(sampler, "global_rows", None)
    for k, (p, sq) in enumerate(zip(pre, sampler.seqs)):
        gens.append(GenState(**{
            name: per_locus(data[f"{p}gen_{name}"], k)
            for name in GenState._fields}))
        cond = data[f"{p}cond"]
        if C > 1:
            cond = cond.reshape(-1, *cond.shape[2:])
        want = (rows[k] if rows else sq.group_id.shape[0],
                gens[-1].num_nodes, sq.group_id.shape[1], 4)
        if cond.shape != want:
            raise ValueError(
                f"{path}: conditionals of shape {cond.shape}, this sampler "
                f"carries {want} ([L, N, P, 4]); a checkpoint in the Pallas "
                "kernels' lane layout (written on a TPU) is not supported")
        lrngs.append(rng(f"{p}lrng", blocks[k]))
        lnlds.append(per_locus(data[f"{p}lnld"], k))
        lnps.append(per_locus(data[f"{p}lnp"], k))
        conds.append(from_numpy(cond[blocks[k]], **conv))
    sampler.gens, sampler.lrngs = tuple(gens), tuple(lrngs)
    sampler.lnlds, sampler.lnps = tuple(lnlds), tuple(lnps)
    sampler.conds = tuple(conds)
    sampler.rate_var = float(data["rate_var"])
    for k, tracker in sampler.ft_search.items():
        tracker.value, tracker.lo, tracker.hi = map(float, data[f"ft_{k}"])
    for t, row in zip(sampler.ft_taus, data["ft_taus"]):
        t.value, t.lo, t.hi = map(float, row)
    sampler._update_ft_device()
    return int(data["iteration"])
