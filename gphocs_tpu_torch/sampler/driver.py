"""Sampler driver: the performMCMC orchestration loop (twin of the
single-device part of gphocs_tpu/sampler/driver.py, pattern buckets,
chains and the loci mesh included).

Initialization, burn-in + sampling loop with the per-iteration schedule
(sampler/bucketed.py), start-mig gating, trace emission, acceptance-rate
logging, the finetune binary search (reference src/GPhoCS.c:1232-2267,
constants src/GPhoCS.h:21-25), checkpoints, the state check of
--debug-check and the coal-stats file.

The per-locus state is held per pattern bucket (`gens`, `seqs`, `lrngs`,
`lnlds`, `lnps`, `conds`: one entry per bucket, in the bucket order of
`bucket_perm`); an unbucketed sampler has one bucket, and for it `gen`,
`seq`, `lrng`, `lnld`, `lnp` and `cond` name that bucket's entries.

`chains=C` runs C independent chains, as gphocs_tpu's vmapped chains do:
chain c is initialized from seed base + 7919 c (its host stream, its
genealogies, its per-locus and general streams, over its loci padded as
one chain's: `loci_multiple` pads each chain, as gphocs_tpu pads
`num_loci` before it stacks its chains), shares the sequence data,
and draws and decides every move on its own, so that it equals a one-chain
run with its seed.  The state holds the chains side by side, not in a
loop: the per-locus tensors chain-major ([C * L, ...], one bucket), the
parameters [C, P], the counters [C] (kernels/common.py).  Every sweep
kernel is launched once per sweep for all C * L loci.  Chain 0 writes the
trace; `chain_rows` keeps every chain's rows of the last run().  The
acceptance log shows the chains' mean (gphocs_tpu sums them, C times the
rate).  Chains are refused with pattern buckets, as in gphocs_tpu, and
with a coal-stats file, whose writer takes one chain.

Admixture (`admixture TRUE` and a sample named in two current
populations): the coefficients move every iteration and get their
finetune search and `AdmxCoefs` column in the acceptance log, the trace
gains an `A<slot>[<pop>]` column per admixed leaf (chain 0's), and a
one-chain run writes admixture-trace.out beside the trace at every log
point: the iteration, then each admixed leaf's share of the sampling
iterations in its second population, per locus (reference
src/GPhoCS.c:1781-1805).  Refused with pattern buckets, as in gphocs_tpu.

A loci mesh (`mesh`, a parallel/mesh.LociMesh: one process per rank)
shards the loci as gphocs_tpu's shard_map path does.  The loci are padded
to a multiple of the world size with inert loci (parallel/mesh.py's rule:
an unbucketed state pads its loci before the initialization, which then
covers them, as gphocs_tpu pads `num_loci`; a bucketed one pads each
bucket with copies of its first locus).  Every rank builds the global
initial state from the host stream and keeps its block of every bucket,
so rank r's state is rows [r Ls, (r + 1) Ls) of the padded unsharded
state (`loci_multiple` pads one process's state the same way).  With C
chains (one bucket) each chain's loci are padded on their own, to Lp, and
rank r keeps its block of every chain, rows [c Lp + r Ls, c Lp + (r + 1)
Ls) for every c (LociMesh.chain_block): chain-major again, [C * Ls, ...],
so each kernel launches once per sweep for all C chains of the rank, and
every all-reduce carries the chains' [C] values (the collectives of an
iteration are those of one chain).  Chain c equals the one-chain meshed
run with seed base + 7919 c.  The parameters and the general streams are
replicated; the all-reduces are sampler/bucketed.py's.  Rank 0 alone
writes the trace, the log, the coal-stats file, admixture-trace.out and
the checkpoint (gathered from every rank); every rank makes every
collective, those of the log points included.

`rng_mode="legacy"` is the conformance mode: the reference's
Wichmann-Hill streams (rng.py), initialized as gphocs_tpu's legacy mode
does (the genealogies simulated from the host stream, init_gen_state; the
device streams the host stream's state afterwards, the first L slots per
locus and the last the general stream), and consumed lane by lane as
gphocs_tpu's XLA path consumes them, so that a run equals
gphocs_tpu.Sampler(rng_mode="legacy") draw for draw.  The mode is fixed at
construction and picks the sweeps: the node-age, migration-age and SPR
kernels implement the counter streams, so this mode runs their plain
versions, on the state's device, while the rubber band keeps its kernel
(sampler/bucketed.py).  It takes chains (each chain's streams from its
own host stream, as gphocs_tpu initializes each of its vmapped legacy
chains) and one bucket: pattern buckets are refused as in gphocs_tpu.
On a loci mesh every rank initializes the padded Lp loci of every chain
(HostRng(Lp + 1) per chain) and keeps its block of the genealogies and
of the per-locus Wichmann-Hill streams; the general streams ([1], or
[C, 1]) are replicated.  The serial rate update hands its carry from
rank to rank, each rank keeping the reference locus's data row
(`ref_seq`), so W ranks equal one process with `loci_multiple` = W bit
for bit; gphocs_tpu's legacy run on a mesh is that padded run too.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch.config.settings import RunConfig
from gphocs_tpu_torch.constants import (FINETUNE_RESOLUTION, MAX_FINETUNE,
                                        TARGET_ACCEPTANCE_PERCENT,
                                        TARGET_ACCEPTANCE_RANGE)
from gphocs_tpu_torch.io import trace as trace_io
from gphocs_tpu_torch.io.sequences import (build_seq_data,
                                           build_seq_data_buckets,
                                           group_members, read_seq_file)
from gphocs_tpu_torch.kernels.common import (gen_log_prior, make_context,
                                             maybe_psum)
from gphocs_tpu_torch.model.poptree import PopTree, build_poptree
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.parallel.mesh import gather_rows, pad_bucket, pad_seq
from gphocs_tpu_torch.profiling import span
from gphocs_tpu_torch.rng_fast import FastRngState, init_fast
from gphocs_tpu_torch.rng_host import HostRng
from gphocs_tpu_torch.sampler.bucketed import mcmc_chunk_buckets
from gphocs_tpu_torch.sampler.init import (init_gen_state,
                                           init_gen_state_fast,
                                           sample_locus_rates,
                                           sample_pop_parameters)
from gphocs_tpu_torch.sampler.step import Finetunes
from gphocs_tpu_torch.state import GenState, Params, SeqData, from_numpy


def _running(total: float, deltas) -> list:
    """total + deltas[0], + deltas[1], ...: the running sums, added on the
    host one iteration at a time, so that they do not depend on how the
    iterations were chunked."""
    out = []
    for d in deltas.tolist():
        total += d
        out.append(total)
    return out


def route(rng_mode: str) -> str:
    """How a sampler of `rng_mode` runs its sweeps (the command line's
    start line)."""
    if rng_mode == "legacy":
        return ("legacy RNG: node-age/migration-age/SPR sweeps as tensor "
                "code")
    return "fast RNG"


def _write_admix_trace(trace_path: str, iteration: int,
                       in2: torch.Tensor, count: int) -> None:
    """admixture-trace.out beside the trace file (gphocs_tpu's twin of
    reference src/GPhoCS.c:1781-1805): one overwritten row, the iteration,
    then per admixed leaf and locus (leaf-major) the share of the `count`
    counted iterations that ended with the leaf in its second population
    (in2 [L, A] holds the counts)."""
    shares = in2.cpu().numpy().astype(np.float64).T / count
    path = os.path.join(os.path.dirname(trace_path) or ".",
                        "admixture-trace.out")
    with open(path, "w") as f:
        f.write(str(iteration) + "".join("\t%f" % v for v in shares.ravel())
                + "\n")


@dataclass
class _FinetuneSearch:
    """One binary-search tracker (reference src/GPhoCS.c:1898-2250)."""

    value: float
    lo: float = 0.0
    hi: float = MAX_FINETUNE

    def adjust(self, percent: float) -> float:
        if percent > TARGET_ACCEPTANCE_PERCENT + TARGET_ACCEPTANCE_RANGE:
            self.lo = self.value
            if self.hi - self.lo < FINETUNE_RESOLUTION:
                if self.hi >= MAX_FINETUNE:
                    self.hi = self.lo = MAX_FINETUNE
                else:
                    self.hi *= 2.0
        elif percent < TARGET_ACCEPTANCE_PERCENT - TARGET_ACCEPTANCE_RANGE:
            self.hi = self.value
            if self.hi - self.lo < FINETUNE_RESOLUTION:
                self.lo /= 2.0
        self.value = 0.5 * (self.hi + self.lo)
        return self.value


@dataclass
class AcceptCounts:
    coal_time: int = 0
    mig_time: int = 0
    spr: int = 0
    theta: int = 0
    mig_rate: int = 0
    taus: Optional[np.ndarray] = None
    mixing: int = 0
    locus_rate: int = 0
    admix: int = 0
    conflicts: int = 0

    def reset(self, P: int):
        self.coal_time = self.mig_time = self.spr = 0
        self.theta = self.mig_rate = self.mixing = self.locus_rate = 0
        self.admix = self.conflicts = 0
        self.taus = np.zeros(P)

    def add(self, st, chains: int) -> None:
        """Add a chunk's totals (StepStats), the chains' mean."""
        def total(x):
            return float(x.sum()) / chains

        self.coal_time += total(st.acc_coal_time)
        self.mig_time += total(st.acc_mig_time)
        self.spr += total(st.acc_spr)
        self.theta += total(st.acc_theta)
        self.mig_rate += total(st.acc_mig_rate)
        self.taus += st.acc_taus.reshape(chains, -1).sum(dim=0).cpu(
        ).numpy() / chains
        self.mixing += total(st.acc_mixing)
        self.locus_rate += total(st.acc_locus_rate)
        self.admix += total(st.acc_admix)
        self.conflicts += total(st.tau_conflicts)


def _one_bucket(name: str):
    """A property naming the one bucket's entry of the per-bucket tuple
    `name` (unbucketed samplers only)."""
    def get(self):
        if len(getattr(self, name)) != 1:
            raise AttributeError(
                f"a sampler with {len(getattr(self, name))} pattern buckets "
                f"keeps its per-locus state per bucket: use .{name}")
        return getattr(self, name)[0]

    def put(self, value):
        if self.buckets != 1:
            raise AttributeError(f"bucketed sampler: set .{name}")
        setattr(self, name, (value,))

    return property(get, put)


class Sampler:
    """End-to-end sampler for one control-file configuration."""

    gen = _one_bucket("gens")
    seq = _one_bucket("seqs")
    lrng = _one_bucket("lrngs")
    lnld = _one_bucket("lnlds")
    lnp = _one_bucket("lnps")
    cond = _one_bucket("conds")

    def __init__(self, cfg: RunConfig, seq_path: Optional[str] = None,
                 num_loci: Optional[int] = None, dtype=torch.float64,
                 device="cuda", rng_mode: str = "fast",
                 legacy_rng: bool = True, mesh=None, chains: int = 1,
                 buckets: int = 1, loci_multiple: int = 1):
        """device: where the state lives and the iteration runs ("cuda"
        by default; asking for CUDA without a CUDA device raises).  With
        a mesh, the rank's device (mesh.device), of the same type.

        mesh: the loci mesh of this process (the module's docstring);
        its loci pad to a multiple of the world size.  loci_multiple pads
        a state without a mesh the same way, so that one process runs the
        padded state that a mesh of that many ranks shards.

        rng_mode: "fast", the counter-based streams of the kernels, or
        "legacy", the conformance mode's Wichmann-Hill streams (the
        module's docstring).

        legacy_rng: seed the host initialization stream (prior draws of
        the starting parameters and rates, and in the legacy mode the
        genealogies and the device streams) as the reference does, the
        same seed in every slot; False gives every slot its own seed
        (--production-rng).

        buckets: sort the loci by phased-pattern count into at most this
        many buckets, each padded only to its own largest count
        (io/sequences.build_seq_data_buckets, which may use fewer).

        chains: independent chains run side by side (the module's
        docstring); not with buckets or a coal-stats file."""
        if rng_mode not in ("fast", "legacy"):
            raise ValueError(f"rng_mode={rng_mode!r}: 'fast' or 'legacy'")
        self.rng_mode = rng_mode
        if rng_mode == "legacy" and buckets > 1:
            raise ValueError("pattern buckets require the fast RNG (as in "
                             "gphocs_tpu): drop buckets")
        if mesh is not None:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r}: the mesh's rank runs "
                                 f"on {mesh.device}")
            device = mesh.device
            loci_multiple = mesh.world
        self.mesh = mesh
        if chains < 1:
            raise ValueError(f"chains={chains}: at least one chain")
        if chains > 1 and buckets > 1:
            raise ValueError("pattern buckets require one chain (as in "
                             "gphocs_tpu): drop buckets or chains")
        if chains > 1 and cfg.mcmc.coal_stats_file != "NONE":
            raise ValueError("a coal-stats file takes one chain: its "
                             "writer reads one chain's state (gphocs_tpu "
                             "hands it the stacked chains); drop "
                             "coal-stats-file or chains")
        if cfg.admixed and buckets > 1:
            raise ValueError("admixture requires one pattern bucket (as in "
                             "gphocs_tpu): drop buckets")
        self.chains = chains
        self.legacy_rng = legacy_rng
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Sampler(device='cuda'): no CUDA device")
        if mesh is not None and self.device.type == "cuda":
            # rank 0 builds the kernels; the others load them after it
            from gphocs_tpu_torch.ops import cuda_lib

            if mesh.rank == 0:
                cuda_lib.build()
            mesh.barrier()
        self.cfg = cfg
        self.tree: PopTree = build_poptree(cfg)
        self.ctx = make_context(self.tree, dtype, self.device)
        self.dtype = dtype

        seed = cfg.mcmc.random_seed
        if seed < 0:
            seed = int(time.time())
        self.seed = seed

        if seq_path is None and cfg.mcmc.seq_file != "NONE":
            seq_path = cfg.mcmc.seq_file
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.bucket_perm = None
        if seq_path is not None:
            raw = read_seq_file(seq_path, cfg.sample_names,
                                cfg.mcmc.num_loci)
            self.num_loci = raw.num_loci
            if buckets > 1:
                self.bucket_perm, sizes, seqs = build_seq_data_buckets(
                    raw, cfg.is_diploid(), buckets, dtype=np_dtype)
            else:
                seqs = [build_seq_data(raw, cfg.is_diploid(),
                                       dtype=np_dtype)]
        else:
            # prior-only run (reference initLociWithoutData,
            # src/GPhoCS.c:447-483)
            if not (num_loci or cfg.mcmc.num_loci > 0):
                raise ValueError("num-loci required without sequence data")
            if buckets > 1:
                raise ValueError("pattern buckets need sequence data")
            self.num_loci = num_loci or cfg.mcmc.num_loci
            S = cfg.num_samples
            gid = np.zeros((self.num_loci, 1), np.int32)
            seqs = [SeqData(
                leaf_base=np.full((self.num_loci, S, 1), 4, np.int8),
                group_id=gid, group_count=np.zeros((self.num_loci, 1)),
                group_nphases=np.ones((self.num_loci, 1)),
                pattern_valid=np.zeros((self.num_loci, 1), bool),
                group_members=group_members(gid))]
        # inert padding loci: an unbucketed state pads num_loci (each
        # chain's), and the initialization covers them; a bucketed one
        # pads every bucket with copies of its first locus (initialize)
        self.bucket_pads = [(-sq.group_id.shape[0]) % loci_multiple
                            for sq in seqs]
        self.pad_loci = 0
        if self.bucket_perm is None:
            self.pad_loci = self.bucket_pads[0]
            self.num_loci += self.pad_loci
        seqs = [pad_seq(sq, pad) for sq, pad in zip(seqs, self.bucket_pads)]
        if chains > 1:  # the chains share the data: [C * Lp, ...]
            seqs = [SeqData(*(None if x is None
                              else np.concatenate([x] * chains)
                              for x in seqs[0]))]
        # every bucket's loci, padded (all chains'), and the rows of them
        # that this process holds: its block of every chain
        self.global_rows = [sq.group_id.shape[0] for sq in seqs]
        self.blocks = [slice(0, n) if mesh is None
                       else mesh.chain_block(n // chains, chains)
                       for n in self.global_rows]
        self.seqs = tuple(
            from_numpy(SeqData(*(None if x is None else x[b] for x in sq)),
                       device=self.device, dtype=dtype)
            for sq, b in zip(seqs, self.blocks))
        # the legacy rate update's reference locus (locus 0) on a mesh:
        # its data row, which every rank keeps
        self.ref_seq = None
        if mesh is not None and rng_mode == "legacy":
            self.ref_seq = from_numpy(
                SeqData(*(None if x is None else x[:1] for x in seqs[0])),
                device=self.device, dtype=dtype)
        # the cost-minimizing partition may use fewer buckets than asked
        self.buckets = len(self.seqs)
        self.host_rng = HostRng(self.num_loci + 1, seed, legacy=legacy_rng)

    @property
    def bucket_sizes(self):
        return [sq.group_id.shape[0] for sq in self.seqs]

    def _initial_chain(self, seed: int, host_rng: HostRng):
        """One chain's starting state from `seed` and its host stream:
        (gen, params, per-locus stream, general stream, rate variance)."""
        cfg = self.cfg
        params = sample_pop_parameters(self.tree, host_rng)
        fixed = None
        if cfg.mcmc.mut_rate_mode == 2:
            # per-locus rates normalized to mean 1 (readRateFile)
            fixed = np.loadtxt(cfg.mcmc.rate_file).ravel()[:self.num_loci]
            if len(fixed) < self.num_loci:
                raise ValueError(f"rate file has {len(fixed)} rates, "
                                 f"need {self.num_loci}")
        rates, rate_var = sample_locus_rates(
            self.num_loci, cfg.mcmc.mut_rate_mode, host_rng, fixed)
        conv = dict(device=self.device, dtype=self.dtype)
        if self.rng_mode == "legacy":
            gen_np = init_gen_state(self.tree, params, host_rng,
                                    self.num_loci, rates)
            # the host stream goes on on the device: the first L slots
            # per locus, the last the general stream
            x, y, z = host_rng.state_arrays()
            L = self.num_loci
            lrng = R.from_arrays(x[:L], y[:L], z[:L], self.device)
            grng = R.from_arrays(x[L:], y[L:], z[L:], self.device)
        else:
            gen_np = init_gen_state_fast(self.tree, params,
                                         seed ^ 0x243F6A88, self.num_loci,
                                         rates)
            # per-locus streams [L] and the general stream [1]
            lrng = init_fast(self.num_loci, seed, self.device)
            grng = init_fast(1, seed + 0x5F3759DF, self.device)
        return (from_numpy(gen_np, GenState, **conv),
                from_numpy(params, Params, **conv), lrng, grng, rate_var)

    # -- initialization (reference initializeMCMC, src/GPhoCS.c:1122) --
    def initialize(self):
        cfg = self.cfg
        if self.chains == 1:
            gen, self.params, lrng, self.grng, self.rate_var = \
                self._initial_chain(self.seed, self.host_rng)
        else:
            # chain c from seed base + 7919 c, side by side; the variance
            # is the last chain's, as gphocs_tpu leaves it
            parts = [self._initial_chain(
                seed, HostRng(self.num_loci + 1, seed,
                              legacy=self.legacy_rng))
                for seed in (self.seed + 7919 * c
                             for c in range(self.chains))]
            gens, params, lrngs, grngs, rvars = zip(*parts)
            gen = GenState(*(torch.cat(f) for f in zip(*gens)))
            self.params = Params(*(None if f[0] is None else torch.stack(f)
                                   for f in zip(*params)))
            if self.rng_mode == "legacy":
                # per-locus streams [C * L], general streams [C, 1]
                lrng = R.WhRngState(*(torch.cat(f) for f in zip(*lrngs)))
                self.grng = R.WhRngState(*(torch.stack(f)
                                           for f in zip(*grngs)))
            else:
                lrng, self.grng = (FastRngState(
                    key=torch.cat([r.key for r in rs]),
                    ctr=torch.stack([r.ctr for r in rs]))
                    for rs in (lrngs, grngs))
            self.rate_var = rvars[-1]
        if self.pad_loci:  # the last pad_loci of every chain
            valid = gen.valid.clone()
            valid.view(self.chains, -1)[:, self.num_loci - self.pad_loci:] \
                = False
            gen = gen._replace(valid=valid)
        if self.bucket_perm is not None:
            # loci in bucket order; every locus keeps its own key, every
            # bucket's counter starts at 0
            perm = torch.as_tensor(self.bucket_perm, device=self.device)
            gen = GenState(*(x[perm] for x in gen))
            lrng = lrng._replace(key=lrng.key[perm])
        gens, lrngs, conds, lnlds, lnps = [], [], [], [], []
        off = 0
        for sq, rows, pad, b in zip(self.seqs, self.global_rows,
                                    self.bucket_pads, self.blocks):
            if self.bucket_perm is None:  # initialized with num_loci
                pad = 0
            n = rows - pad
            g = GenState(*(x[off:off + n] for x in gen))
            if self.rng_mode == "legacy":  # one bucket: its block
                r = R.WhRngState(*(f[b] for f in lrng))
            else:
                g, key = pad_bucket(g, lrng.key[off:off + n], pad)
                r = lrng._replace(key=key[b])
            g = GenState(*(x[b] for x in g))
            cond, lnld = full_rebuild_and_lnld(g, sq)
            gens.append(g)
            lrngs.append(r)
            conds.append(cond)
            lnlds.append(lnld)
            lnps.append(gen_log_prior(g, self.params, self.ctx))
            off += n
        self.gens, self.lrngs = tuple(gens), tuple(lrngs)
        self.conds, self.lnlds, self.lnps = (tuple(conds), tuple(lnlds),
                                             tuple(lnps))

        ftc = cfg.mcmc.finetunes
        if cfg.mcmc.find_finetunes:
            # the reference seeds the search at 1.0 for unspecified ones
            seedv = lambda v: v if v > 0 else 1.0  # noqa: E731
        else:
            seedv = lambda v: v  # noqa: E731
        self.ft_search = {
            k: _FinetuneSearch(seedv(getattr(ftc, k)))
            for k in ("coal_time", "mig_time", "theta", "mig_rate",
                      "mixing", "locus_rate", "admix")}
        self.ft_taus = [
            _FinetuneSearch(seedv(v) if v > 0 or cfg.mcmc.find_finetunes
                            else v)
            for v in ftc.taus]
        self._update_ft_device()

    def _update_ft_device(self):
        def t(v):
            return torch.as_tensor(v, dtype=self.dtype, device=self.device)

        self.ft = Finetunes(
            **{k: t(s.value) for k, s in self.ft_search.items()},
            taus=t([s.value for s in self.ft_taus]))

    def _sample_mig_rates_device(self):
        """m ~ U[0.9, 1.1] * prior mean via the general stream
        (reference sampleMigRates, src/PopulationTree.c:414-433)."""
        B = self.tree.num_bands
        means = torch.as_tensor(self.tree.mig_alpha / self.tree.mig_beta,
                                dtype=self.dtype, device=self.device)
        rates = []
        for b in range(B):
            u, self.grng = R.general_draw_u(self.grng, self.dtype)
            rates.append(means[b] * (0.9 + 0.2 * u))  # [C] for C chains
        if B:
            self.params = self.params._replace(
                mig_rate=torch.stack(rates, dim=-1))
        self.lnps = tuple(gen_log_prior(g, self.params, self.ctx)
                          for g in self.gens)

    def _var_deltas(self, deltas: torch.Tensor) -> torch.Tensor:
        """The VAR rate variance's change per iteration: the chains' mean
        (gphocs_tpu: the chunk's sum over chains / C)."""
        if self.chains == 1:
            return deltas
        return deltas.sum(dim=-1) / self.chains

    def step_chunk(self, n_iters: int, do_migrate: bool):
        """Run n_iters iterations; returns (totals, trace), each chain's
        ([C, ...] fields) for C chains.  With admixed leaves, `chunk_in2`
        then holds the chunk's counts of each leaf of each locus in its
        second population ([L, A], on the device)."""
        cfg = self.cfg
        tree = self.tree
        sample_age_mask = tuple(
            bool(x) for x in tree.update_sample_age[:tree.num_cur_pops])
        with span("chunk"):
            (gens, self.params, lrngs, self.grng, lnlds, lnps, conds, stats,
             trace, self.chunk_in2) = mcmc_chunk_buckets(
                self.gens, self.params, self.seqs, self.lrngs, self.grng,
                self.lnlds, self.lnps, self.conds, self.ft, ctx=self.ctx,
                n_iters=n_iters,
                genetree_samples=cfg.mcmc.genetree_samples,
                do_migrate=do_migrate,
                do_mixing=cfg.mcmc.do_mixing,
                num_pops=self.tree.num_pops,
                num_cur_pops=self.tree.num_cur_pops,
                sample_age_mask=sample_age_mask,
                coal_time_on=self.ft_search["coal_time"].value > 0,
                mig_time_on=self.ft_search["mig_time"].value > 0,
                theta_on=self.ft_search["theta"].value > 0,
                mig_rate_on=self.ft_search["mig_rate"].value > 0,
                mixing_on=self.ft_search["mixing"].value > 0,
                var_rates=cfg.mcmc.mut_rate_mode == 1,
                locus_rate_on=self.ft_search["locus_rate"].value > 0,
                var_alpha=cfg.mcmc.var_rates_alpha, loci_axis=self.mesh,
                legacy=self.rng_mode == "legacy", ref_seq=self.ref_seq)
        self.gens, self.lrngs = tuple(gens), tuple(lrngs)
        self.lnlds, self.lnps, self.conds = (tuple(lnlds), tuple(lnps),
                                             tuple(conds))
        if cfg.mcmc.mut_rate_mode == 1:
            self.rate_var = _running(
                self.rate_var, self._var_deltas(trace.rate_var_delta))[-1]
        return stats, trace

    def _tau_pops(self):
        """Populations with a rubber-band proposal: current ones with an
        estimated sample age, then the ancestral ones."""
        tree = self.tree
        return [pop for pop in range(tree.num_pops)
                if pop >= tree.num_cur_pops or tree.update_sample_age[pop]]

    def _log_header(self):
        """Reference stdout header (src/GPhoCS.c:1357-1374)."""
        cols = ["Samples", "CoalTimes", "MigTimes", "SPRs", "Thetas",
                "MigRates"]
        if self.ctx.num_admixed:
            cols.append("AdmxCoefs")
        cols += [f"TAU_{pop:2d}" for pop in self._tau_pops()]
        cols += ["RbberBnd", "MutRates", "Mixing"]
        line = "".join(f"{c:<10}" for c in cols)
        return line + "| DATA-ln-ld |  TIME\n" + "-" * (len(line) + 25)

    def _log_line(self, iteration, pct, lnld_avg, elapsed):
        """Reference per-log acceptance row (src/GPhoCS.c:1823-1895)."""
        parts = [f"{iteration + 1:7d}  "]
        for key in ("coal_time", "mig_time", "spr", "theta", "mig_rate"):
            parts.append(f"{pct[key]:5.1f}%    ")
        if self.ctx.num_admixed:
            parts.append(f"{pct['admix']:5.1f}%    ")
        for pop in self._tau_pops():
            parts.append(f"{pct['taus'][pop]:5.1f}%    ")
        parts.append(f"{pct['rubberband']:6.1f}%    ")
        parts.append(f"{pct['locus_rate']:5.1f}%    ")
        parts.append(f"{pct['mixing']:5.1f}%    ")
        h, rem = divmod(int(elapsed), 3600)
        m, sec = divmod(rem, 60)
        parts.append(f"|{lnld_avg:12.6f}| {h:02d}:{m:02d}:{sec:02d}")
        return "".join(parts)

    def run(self, trace_path: Optional[str] = None, progress: bool = False,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0, resume: bool = False,
            debug_check: bool = False):
        """Full MCMC per the control file.  Returns the trace as
        (header_cols, numpy array).

        progress=True prints the reference-format acceptance log to stderr.
        checkpoint_path / checkpoint_every: save the whole sampler state
        every checkpoint_every iterations and at the end (checkpoint.py);
        resume=True restores it from checkpoint_path where that file
        exists and continues bit for bit as the uninterrupted run would.
        debug_check=True runs check_state() at every log point (reference
        checkAll, src/GPhoCS.c:1814-1821) and raises on a violation.
        A `coal-stats-file` in the control file gets one row per iteration
        (tools/coalstats_out.py) from the current state of all buckets.
        With admixed leaves and one chain, admixture-trace.out goes beside
        the trace file (the module's docstring).
        With chains, the trace is chain 0's, and `chain_rows` gets every
        chain's rows.  On a loci mesh every rank calls run() with the same
        arguments; rank 0 writes the files and the log."""
        from gphocs_tpu_torch import checkpoint as ckpt

        cfg = self.cfg
        self.initialize()
        start = -cfg.mcmc.burn_in
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            start = ckpt.load_checkpoint(self, checkpoint_path)
        tree = self.tree
        P = tree.num_pops
        L = self.num_loci
        total_coals = L * (tree.num_samples - 1)

        var_mut = cfg.mcmc.mut_rate_mode == 1
        header = trace_io.trace_header(tree, var_mut)
        factors = trace_io.print_factors(tree, var_mut)
        C = self.chains
        chain_rows = [[] for _ in range(C)]
        rows = chain_rows[0]
        counts = AcceptCounts()
        counts.reset(P)
        log_count = 0
        mig_nodes_accum = 0
        A = self.ctx.num_admixed
        admix_in2, admix_count = None, 0
        finding = cfg.mcmc.find_finetunes
        spl = (cfg.mcmc.find_finetunes_samples_per_step if finding
               else cfg.mcmc.iterations_per_log)
        t0 = time.time()
        writer = self.mesh is None or self.mesh.rank == 0
        progress = progress and writer
        if progress:
            print(self._log_header(), file=sys.stderr)

        tf = open(trace_path, "w") if trace_path and writer else None
        coal_stats = cfg.mcmc.coal_stats_file != "NONE"
        cs_file = None
        if coal_stats:
            from gphocs_tpu_torch.tools.coalstats_out import (
                coal_stats_header, write_coal_stats_row)

            nparts = max(cfg.mcmc.num_pop_partitions, 1)
            if writer:
                cs_file = open(cfg.mcmc.coal_stats_file, "w")
                cs_file.write(coal_stats_header(tree, nparts) + "\n")
        try:
            if tf:
                tf.write(header + "\n")
            iteration = start
            while iteration < cfg.mcmc.mcmc_iterations:
                # chunk until the next boundary: a log point, the
                # start-mig switch, a checkpoint, or the end of the run;
                # with a coal-stats file, one iteration (one row each).
                # Chunking does not change the draws.
                next_log = ((iteration + spl) // spl) * spl \
                    if spl > 0 else cfg.mcmc.mcmc_iterations
                boundaries = [next_log, cfg.mcmc.mcmc_iterations]
                if iteration <= cfg.mcmc.start_mig:
                    boundaries.append(cfg.mcmc.start_mig + 1)
                if checkpoint_path and checkpoint_every > 0:
                    boundaries.append((iteration // checkpoint_every + 1)
                                      * checkpoint_every)
                if coal_stats:
                    boundaries.append(iteration + 1)
                end = max(min(boundaries), iteration + 1)
                n_iters = end - iteration
                rate_var = self.rate_var
                st, tr = self.step_chunk(
                    n_iters, do_migrate=iteration > cfg.mcmc.start_mig)
                counts.add(st, C)
                mig_nodes_accum += float(st.num_migs_total.sum()) / C
                log_count += n_iters

                if (self.chunk_in2 is not None and iteration >= 0
                        and C == 1):
                    # the sampling iterations (a chunk never spans 0, a
                    # log point), added up on the device
                    admix_in2 = (self.chunk_in2 if admix_in2 is None
                                 else admix_in2 + self.chunk_in2)
                    admix_count += n_iters
                # [K, C, ...] for C chains
                theta, tau, sage, mrate, lnld_s, lnp_s, dvar, adm = (
                    t.cpu().numpy() for t in tr)
                # the variance after each iteration of the chunk
                rate_var = _running(rate_var, self._var_deltas(
                    torch.as_tensor(dvar)))
                for j in range(n_iters):
                    it = iteration + j
                    if it < 0 or it % (cfg.mcmc.mcmc_sample_skip + 1):
                        continue
                    for c in range(C):
                        pick = ((lambda x: x[j]) if C == 1  # noqa: E731
                                else (lambda x: x[j, c]))
                        ld = float(pick(lnld_s))
                        full = (ld + float(pick(lnp_s))) / L
                        vals = trace_io.record_param_vals(
                            tree, pick(theta), pick(tau), pick(sage),
                            pick(mrate), rate_var[j] if var_mut else None,
                            pick(adm) if A else None)
                        chain_rows[c].append(
                            [it] + [v * f for v, f in zip(vals, factors)]
                            + [full, ld])
                        if tf and c == 0:
                            tf.write(trace_io.format_row(
                                it, vals, factors, full, ld) + "\n")
                if tf:
                    tf.flush()

                iteration = end
                if iteration == cfg.mcmc.start_mig + 1:
                    self._sample_mig_rates_device()
                if iteration % spl == 0:
                    if admix_count and C == 1:
                        in2 = (admix_in2 if self.mesh is None
                               else gather_rows(self.mesh, admix_in2, C))
                        if trace_path and writer:
                            _write_admix_trace(trace_path, iteration - 1,
                                               in2, admix_count)
                    pct = self._percents(counts, log_count, total_coals,
                                         mig_nodes_accum)
                    if progress:  # chain 0's
                        lnld_avg = (float(lnld_s[-1].flat[0])
                                    + float(lnp_s[-1].flat[0])) / L
                        print(self._log_line(iteration - 1, pct, lnld_avg,
                                             time.time() - t0),
                              file=sys.stderr)
                    if debug_check:
                        errs = self.check_state()
                        if errs:
                            raise AssertionError(
                                "state inconsistency at iteration "
                                f"{iteration}: " + "; ".join(errs[:10]))
                    if finding:
                        self._adjust_finetunes(pct)
                        if (iteration >= cfg.mcmc.find_finetunes_num_steps
                                * cfg.mcmc.find_finetunes_samples_per_step):
                            finding = False
                            spl = cfg.mcmc.iterations_per_log
                    counts.reset(P)
                    log_count = 0
                    mig_nodes_accum = 0
                if coal_stats:
                    write_coal_stats_row(cs_file, iteration - 1, self.gens,
                                         self.params, self.ctx, tree, nparts,
                                         self.mesh)
                if (checkpoint_path and checkpoint_every > 0
                        and iteration % checkpoint_every == 0):
                    ckpt.save_checkpoint(self, checkpoint_path, iteration)
            if checkpoint_path:
                ckpt.save_checkpoint(self, checkpoint_path, iteration)
        finally:
            for f in (tf, cs_file):
                if f:
                    f.close()
        self.chain_rows = [np.asarray(r) for r in chain_rows]
        return header.split("\t"), np.asarray(rows)

    def check_state(self) -> list:
        """The state check of --debug-check (debugcheck.py): structural
        invariants of every bucket's genealogies and the carried lnld/lnp
        against a recomputation.  Returns the violations, each naming its
        bucket or its chain where there are several.  On a loci mesh each
        rank checks its own loci (its block of every chain; the messages
        name the rank), the global carried sums are checked after their
        all-reduce (each chain's), and the count of violations is
        all-reduced once, so that every rank fails together."""
        from gphocs_tpu_torch.debugcheck import (check_gen_state,
                                                 check_global_sums,
                                                 check_likelihoods)

        errs = []
        if self.chains > 1:
            for c in range(self.chains):
                errs += [f"chain {c}: " + e
                         for e in check_gen_state(*self.chain_state(c),
                                                  self.tree)]
        for k, g in enumerate(self.gens if self.chains == 1 else ()):
            pre = f"bucket {k}: " if self.buckets > 1 else ""
            errs += [pre + e for e in check_gen_state(g, self.params,
                                                      self.tree)]
        errs += check_likelihoods(self)
        if self.mesh is None:
            return errs
        rank = self.mesh.rank
        errs = [f"rank {rank}: " + e for e in errs] + check_global_sums(self)
        n = int(maybe_psum(torch.tensor(len(errs)), self.mesh))
        return errs or ([f"rank {rank}: {n} violation(s) on other ranks"]
                        if n else [])

    def chain_state(self, c: int):
        """Chain c's genealogies and parameters, as one chain's (views; on
        a loci mesh, the rank's block of chain c)."""
        L = self.gen.num_loci // self.chains
        return (GenState(*(x[c * L:(c + 1) * L] for x in self.gen)),
                Params(*(None if x is None else x[c] for x in self.params)))

    def _percents(self, c: AcceptCounts, log_count, total_coals,
                  mig_nodes_accum):
        gts = max(self.cfg.mcmc.genetree_samples, 1)
        P = self.tree.num_pops
        B = self.tree.num_bands
        L = max(self.num_loci - self.pad_loci, 2)
        lc = max(log_count, 1)
        n_anc = max(self.tree.num_pops - self.tree.num_cur_pops, 1)
        A = self.ctx.num_admixed
        return {
            "coal_time": c.coal_time * 100.0 / (lc * total_coals * gts),
            "mig_time": c.mig_time * 100.0 / (mig_nodes_accum + 1e-6),
            "spr": c.spr * 100.0 / (lc * 2 * total_coals * gts),
            "theta": c.theta * 100.0 / (lc * P),
            "mig_rate": c.mig_rate * 100.0 / (lc * B + 1e-6),
            "taus": c.taus * 100.0 / lc,
            "mixing": c.mixing * 100.0 / lc,
            "rubberband": c.conflicts * 100.0 / (lc * n_anc),
            # reference: accepted / (logCount * (numLoci-1) * genetreeSamples)
            # (src/GPhoCS.c:1842-1846) and / (logCount * #admixed) (:1848)
            "locus_rate": c.locus_rate * 100.0 / (lc * (L - 1) * gts),
            "admix": (c.admix * 100.0 / (lc * A)) if A else 0.0,
        }

    def _adjust_finetunes(self, pct):
        for k in ("coal_time", "mig_time", "theta", "mig_rate", "mixing"):
            self.ft_search[k].adjust(pct[k])
        # locus-rate / admixture finetunes (reference src/GPhoCS.c:2163-2185)
        if self.cfg.mcmc.mut_rate_mode == 1:
            self.ft_search["locus_rate"].adjust(pct["locus_rate"])
        if self.ctx.num_admixed:
            self.ft_search["admix"].adjust(pct["admix"])
        for p in self._tau_pops():
            self.ft_taus[p].adjust(pct["taus"][p])
        self._update_ft_device()
