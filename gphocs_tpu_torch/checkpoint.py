"""Checkpoint / resume (twin of gphocs_tpu/checkpoint.py, same file).

The reference has no resume: a killed run keeps its flushed trace and
loses the sampler's state (SURVEY §5).  Here the whole state of a sampler
(genealogies, parameters, both RNG streams, carried conditionals and
likelihoods, finetune searches, the iteration) goes into one .npz, so a
run resumes bit for bit as the uninterrupted run would go on.

The file is gphocs_tpu's: the same keys, dtypes (int32 indices, uint32
RNG keys and counters, the sampler's float dtype) and format version, so a
checkpoint written by either package resumes in the other.  An unbucketed
sampler writes `gen_*`, `lrng_*`, `lnld`, `lnp`, `cond`; a bucketed one
`b<k>_*` per bucket.  The conditionals are [L, N, P, 4] in both packages;
a file written on a TPU with the Pallas kernels' lane layout is not.  A
sampler of C chains writes gphocs_tpu's stacked layout: a leading chain
axis on every per-chain array ([C, L, ...] per locus, [C, P] parameters,
[C] counters, the general streams' keys [C, 1]).
"""

from __future__ import annotations

import os

import numpy as np
import torch

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


def _rng_np(st: FastRngState, C: int):
    """A stream as gphocs_tpu stores it; C chains' keys [C, K]."""
    key = st.key.cpu().numpy().astype(np.uint32)
    return (key if C == 1 else key.reshape(C, -1),
            st.ctr.cpu().numpy().astype(np.uint32))


def save_checkpoint(sampler, path: str, iteration: int) -> None:
    """Write the sampler's state to `path` (through a temporary file and a
    rename, so a crash never leaves half a checkpoint)."""
    real = np.float32 if sampler.dtype == torch.float32 else np.float64
    C = getattr(sampler, "chains", 1)

    def per_locus(t):  # C chains' [C * L, ...] as [C, L, ...]
        a = _np(t, real)
        return a if C == 1 else a.reshape(C, -1, *a.shape[1:])

    arrays = {"n_buckets": np.asarray(sampler.buckets)}
    if sampler.buckets > 1:
        pre = [f"b{k}_" for k in range(sampler.buckets)]
    else:
        pre = [""]
    for k, p in enumerate(pre):
        for name, val in sampler.gens[k]._asdict().items():
            arrays[f"{p}gen_{name}"] = per_locus(val)
        arrays[f"{p}lrng_key"], arrays[f"{p}lrng_ctr"] = _rng_np(
            sampler.lrngs[k], C)
        arrays[f"{p}lnld"] = per_locus(sampler.lnlds[k])
        arrays[f"{p}lnp"] = per_locus(sampler.lnps[k])
        # saved, not rebuilt on load: a rebuild may differ in the last bit
        # from the carried values
        arrays[f"{p}cond"] = per_locus(sampler.conds[k])
    for name in Params._fields:
        val = getattr(sampler.params, name)
        arrays[f"params_{name}"] = (
            np.zeros(sampler.params.theta.shape[:-1] + (0,), real)
            if val is None else _np(val, real))
    arrays["grng_key"], arrays["grng_ctr"] = _rng_np(sampler.grng, C)
    arrays["iteration"] = np.asarray(iteration)
    arrays["rate_var"] = np.asarray(sampler.rate_var)
    arrays["format_version"] = np.asarray(_FORMAT_VERSION)
    for k, v in sampler.ft_search.items():
        arrays[f"ft_{k}"] = np.asarray([v.value, v.lo, v.hi])
    arrays["ft_taus"] = np.asarray(
        [[t.value, t.lo, t.hi] for t in sampler.ft_taus])
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(sampler, path: str) -> int:
    """Restore the state of an initialized sampler from `path`; returns
    the iteration to go on from."""
    data = np.load(path)
    if int(data["format_version"]) != _FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format "
                         f"{int(data['format_version'])}, this package reads "
                         f"{_FORMAT_VERSION}")
    if "grng_key" not in data:
        raise NotImplementedError(
            f"{path}: a checkpoint of the legacy Wichmann-Hill RNG "
            "(ROADMAP Queue 1 item 17)")
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

    def per_locus(a):  # [C, L, ...] as the state's [C * L, ...]
        return from_numpy(a if C == 1 else a.reshape(-1, *a.shape[2:]),
                          **conv)

    def rng(pre):
        key = data[f"{pre}_key"]
        return FastRngState(key=from_numpy(key.reshape(-1), **conv),
                            ctr=from_numpy(data[f"{pre}_ctr"], **conv))

    admix = data["params_admix_coeff"]
    if admix.size:
        raise NotImplementedError(
            f"{path}: admixture coefficients (ROADMAP Queue 1 item 10b)")
    sampler.params = Params(**{
        name: from_numpy(data[f"params_{name}"], **conv)
        for name in Params._fields if name != "admix_coeff"})
    sampler.grng = rng("grng")
    pre = ([f"b{k}_" for k in range(n_buckets)] if n_buckets > 1 else [""])
    gens, lrngs, lnlds, lnps, conds = [], [], [], [], []
    for p, sq in zip(pre, sampler.seqs):
        gens.append(GenState(**{
            name: per_locus(data[f"{p}gen_{name}"])
            for name in GenState._fields}))
        cond = data[f"{p}cond"]
        if C > 1:
            cond = cond.reshape(-1, *cond.shape[2:])
        want = (sq.group_id.shape[0], gens[-1].num_nodes,
                sq.group_id.shape[1], 4)
        if cond.shape != want:
            raise ValueError(
                f"{path}: conditionals of shape {cond.shape}, this sampler "
                f"carries {want} ([L, N, P, 4]); a checkpoint in the Pallas "
                "kernels' lane layout (written on a TPU) is not supported")
        lrngs.append(rng(f"{p}lrng"))
        lnlds.append(per_locus(data[f"{p}lnld"]))
        lnps.append(per_locus(data[f"{p}lnp"]))
        conds.append(from_numpy(cond, **conv))
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
