"""Run configuration dataclasses.

These mirror the reference's three configuration singletons — ioSetup,
mcmcSetup, dataSetup (reference: src/MCMCcontrol.h:48-115) — restructured
as plain dataclasses.  Defaults follow initGeneralInfo
(reference: src/MCMCcontrol.c:66-113).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Finetunes:
    """Proposal step sizes (reference: src/MCMCcontrol.h finetunes struct)."""

    coal_time: float = -1.0
    mig_time: float = -1.0
    theta: float = -1.0
    mig_rate: float = -1.0
    locus_rate: float = -1.0
    mixing: float = -1.0
    admix: float = -1.0
    # per-population tau finetunes, length numPops (current pops unused);
    # filled from the global `finetune-tau` plus per-POP overrides.
    taus: List[float] = field(default_factory=list)


@dataclass
class PopSpec:
    """One population (current or ancestral)."""

    name: str
    # current pops: per-sample (name, 'h'|'d') pairs
    samples: List[tuple] = field(default_factory=list)
    # ancestral pops: names of the two children
    children: Optional[List[str]] = None
    theta_alpha: float = -1.0
    theta_beta: float = -1.0
    theta_print: float = 1.0
    tau_alpha: float = -1.0
    tau_beta: float = -1.0
    tau_print: float = 1.0
    tau_initial: float = -1.0  # agePrior.sampleStart
    finetune_tau: float = -1.0
    sample_age: float = 0.0  # ancient-sample age for current pops
    update_sample_age: bool = False  # 'age <v> e' => estimated


@dataclass
class BandSpec:
    """One migration band (reference: MIG-BANDS module)."""

    source: str
    target: str
    mig_rate_alpha: float = -1.0
    mig_rate_beta: float = -1.0
    mig_rate_print: float = 1.0


@dataclass
class MCMCSettings:
    """GENERAL-INFO attributes (reference: src/MCMCcontrol.c:575-784)."""

    seq_file: str = "NONE"
    trace_file: str = "mcmc-trace.out"
    coal_stats_file: str = "NONE"
    comb_stats_file: str = "NONE"
    num_pop_partitions: int = 0
    num_loci: int = -1
    random_seed: int = -1
    burn_in: int = 0
    mcmc_iterations: int = 10000
    mcmc_sample_skip: int = 0
    start_mig: int = 0
    do_mixing: bool = True  # 'no-mixing TRUE' flips this off
    iterations_per_log: int = 100
    logs_per_line: int = 100
    tau_theta_print: float = 1.0
    tau_theta_alpha: float = -1.0
    tau_theta_beta: float = -1.0
    mig_rate_print: float = 1.0
    mig_rate_alpha: float = -1.0
    mig_rate_beta: float = -1.0
    # 0 = CONST, 1 = VAR (alpha of Dirichlet), 2 = FIXED (rate file)
    mut_rate_mode: int = 0
    var_rates_alpha: float = -1.0
    rate_file: str = "NONE"
    genetree_samples: int = 1  # fixed at 1 in the reference (initGeneralInfo)
    allow_admixture: bool = False
    find_finetunes: bool = False
    find_finetunes_num_steps: int = 100
    find_finetunes_samples_per_step: int = 100
    finetunes: Finetunes = field(default_factory=Finetunes)


@dataclass
class RunConfig:
    """Fully parsed control file: settings + population model."""

    mcmc: MCMCSettings = field(default_factory=MCMCSettings)
    cur_pops: List[PopSpec] = field(default_factory=list)
    anc_pops: List[PopSpec] = field(default_factory=list)
    bands: List[BandSpec] = field(default_factory=list)
    # admixed samples: (name, first_pop_idx, second_pop_idx, 'h'|'d'),
    # filled during validation when 'admixture TRUE'
    admixed: List[tuple] = field(default_factory=list)

    @property
    def num_cur_pops(self) -> int:
        return len(self.cur_pops)

    @property
    def num_pops(self) -> int:
        return len(self.cur_pops) + len(self.anc_pops)

    @property
    def pops(self) -> List[PopSpec]:
        return self.cur_pops + self.anc_pops

    def pop_index(self) -> Dict[str, int]:
        return {p.name: i for i, p in enumerate(self.pops)}

    @property
    def sample_names(self) -> List[str]:
        """Haploid sample-slot names; a diploid sample 'X d' contributes
        slots ['X', ''] (reference: src/MCMCcontrol.c:1335-1345)."""
        out = []
        for p in self.cur_pops:
            for nm, fmt in p.samples:
                out.append(nm)
                if fmt == "d":
                    out.append("")
        return out

    @property
    def num_samples(self) -> int:
        return len(self.sample_names)

    def samples_per_pop(self) -> List[int]:
        out = []
        for p in self.cur_pops:
            n = 0
            for _, fmt in p.samples:
                n += 2 if fmt == "d" else 1
            out.append(n)
        return out

    def is_diploid(self) -> List[bool]:
        """Per haploid slot: True if the slot belongs to a diploid sample
        (both slots of a 'd' pair are marked diploid)."""
        out = []
        for p in self.cur_pops:
            for _, fmt in p.samples:
                if fmt == "d":
                    out += [True, True]
                else:
                    out.append(False)
        return out

    def num_ancient_pops(self) -> int:
        return sum(
            1 for p in self.cur_pops if p.update_sample_age or p.sample_age > 0.0
        )

    def admixed_slots(self):
        """Haploid slot indices + pop pairs of admixed samples:
        [(slot, popA, popB)], both slots for diploids."""
        slot_of = {}
        slot = 0
        for p in self.cur_pops:
            for nm, fmt in p.samples:
                slot_of[nm] = slot
                slot += 2 if fmt == "d" else 1
        out = []
        for (nm, pa, pb, fmt) in self.admixed:
            s0 = slot_of[nm]
            out.append((s0, pa, pb))
            if fmt == "d":
                out.append((s0 + 1, pa, pb))
        return out

    def num_parameters(self) -> int:
        """reference: src/MCMCcontrol.c:428-441."""
        return (
            2 * self.num_pops
            - self.num_cur_pops
            + len(self.bands)
            + self.num_ancient_pops()
            + len(self.admixed_slots())
            + (1 if self.mcmc.mut_rate_mode == 1 else 0)
        )
