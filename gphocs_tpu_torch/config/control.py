"""G-PhoCS control-file parser.

Grammar: four modules GENERAL-INFO / CURRENT-POPS / ANCESTRAL-POPS /
MIG-BANDS, each delimited by <MODULE>-START / <MODULE>-END tokens;
whitespace-separated key/value tokens; '#' starts a comment to end of line
(reference: src/MCMCcontrol.c:121-216,575-1256; tokenizer src/utils.c:695).

Also supports the "secondary control file" mechanism: GENERAL-INFO
attributes are overridden and the MIG-BANDS module is replaced wholesale
(reference: src/MCMCcontrol.c:178-210).
"""

from __future__ import annotations

import re
from typing import List, Optional

from gphocs_tpu_torch.config.settings import (
    BandSpec,
    Finetunes,
    MCMCSettings,
    PopSpec,
    RunConfig,
)


class ControlFileError(ValueError):
    pass


def _tokenize(text: str) -> List[str]:
    """Strip '#' comments per line, split on whitespace."""
    toks: List[str] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        toks.extend(line.split())
    return toks


class _Cursor:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise ControlFileError("unexpected end of control file")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, token: str):
        t = self.next()
        if t != token:
            raise ControlFileError(f"expected token {token!r}, got {t!r}")

    def next_float(self, what: str) -> float:
        t = self.next()
        try:
            return float(t)
        except ValueError:
            raise ControlFileError(f"expected number for {what}, got {t!r}")

    def next_int(self, what: str) -> int:
        t = self.next()
        try:
            return int(t)
        except ValueError:
            raise ControlFileError(f"expected integer for {what}, got {t!r}")

    def next_bool(self, what: str) -> bool:
        t = self.next()
        if t == "TRUE":
            return True
        if t == "FALSE":
            return False
        raise ControlFileError(f"expected TRUE/FALSE for {what}, got {t!r}")


def _parse_general_info(c: _Cursor, m: MCMCSettings):
    c.expect("GENERAL-INFO-START")
    ft = m.finetunes
    while True:
        tok = c.next()
        if tok == "GENERAL-INFO-END":
            return
        elif tok == "seq-file":
            m.seq_file = c.next()
        elif tok == "trace-file":
            m.trace_file = c.next()
        elif tok == "coal-stats-file":
            m.coal_stats_file = c.next()
        elif tok == "comb-stats-file":
            m.comb_stats_file = c.next()
        elif tok == "num-pop-partitions":
            m.num_pop_partitions = c.next_int(tok)
        elif tok == "num-loci":
            m.num_loci = c.next_int(tok)
        elif tok == "random-seed":
            m.random_seed = c.next_int(tok)
        elif tok == "burn-in":
            m.burn_in = c.next_int(tok)
        elif tok == "mcmc-iterations":
            m.mcmc_iterations = c.next_int(tok)
        elif tok == "mcmc-sample-skip":
            m.mcmc_sample_skip = c.next_int(tok)
        elif tok == "start-mig":
            m.start_mig = c.next_int(tok)
        elif tok == "no-mixing":
            m.do_mixing = False
            # reference consumes no value token for no-mixing (src/MCMCcontrol.c:649)
        elif tok == "iterations-per-log":
            m.iterations_per_log = c.next_int(tok)
        elif tok == "logs-per-line":
            m.logs_per_line = c.next_int(tok)
        elif tok == "tau-theta-print":
            m.tau_theta_print = c.next_float(tok)
        elif tok == "tau-theta-alpha":
            m.tau_theta_alpha = c.next_float(tok)
        elif tok == "tau-theta-beta":
            m.tau_theta_beta = c.next_float(tok)
        elif tok == "mig-rate-print":
            m.mig_rate_print = c.next_float(tok)
        elif tok == "mig-rate-alpha":
            m.mig_rate_alpha = c.next_float(tok)
        elif tok == "mig-rate-beta":
            m.mig_rate_beta = c.next_float(tok)
        elif tok == "admixture":
            # present-but-commented-out in the reference
            # (src/MCMCcontrol.c:691-699); re-enabled here
            m.allow_admixture = c.next_bool(tok)
        elif tok == "finetune-admix":
            ft.admix = c.next_float(tok)
        elif tok == "locus-mut-rate":
            v = c.next()
            if v == "CONST":
                m.mut_rate_mode = 0
            elif v == "VAR":
                m.mut_rate_mode = 1
                m.var_rates_alpha = c.next_float("locus-mut-rate VAR alpha")
            elif v == "FIXED":
                m.mut_rate_mode = 2
                m.rate_file = c.next()
            else:
                raise ControlFileError(f"locus-mut-rate must be CONST/VAR/FIXED, got {v!r}")
        elif tok == "finetune-coal-time":
            ft.coal_time = c.next_float(tok)
        elif tok == "finetune-mig-time":
            ft.mig_time = c.next_float(tok)
        elif tok == "finetune-theta":
            ft.theta = c.next_float(tok)
        elif tok == "finetune-mig-rate":
            ft.mig_rate = c.next_float(tok)
        elif tok == "finetune-tau":
            # global tau finetune applied to all pops (may be overridden per-POP)
            ft.taus = [c.next_float(tok)]
        elif tok == "finetune-locus-rate":
            ft.locus_rate = c.next_float(tok)
        elif tok == "finetune-mixing":
            ft.mixing = c.next_float(tok)
        elif tok == "find-finetunes":
            m.find_finetunes = c.next_bool(tok)
        elif tok == "find-finetunes-num-steps":
            m.find_finetunes_num_steps = c.next_int(tok)
        elif tok == "find-finetunes-samples-per-step":
            m.find_finetunes_samples_per_step = c.next_int(tok)
        else:
            raise ControlFileError(
                f"unknown GENERAL-INFO attribute {tok!r}"
            )


_SAMPLE_RE = re.compile(r"^[hd]$")


def _parse_current_pops(c: _Cursor, cfg: RunConfig):
    c.expect("CURRENT-POPS-START")
    while True:
        tok = c.next()
        if tok == "CURRENT-POPS-END":
            break
        if tok != "POP-START":
            raise ControlFileError(f"expected POP-START, got {tok!r}")
        pop = PopSpec(name="")
        pop.theta_alpha = cfg.mcmc.tau_theta_alpha
        pop.theta_beta = cfg.mcmc.tau_theta_beta
        pop.theta_print = cfg.mcmc.tau_theta_print
        # ancient-sample-age trace columns scale by the global print factor
        # (reference finalizeNumParameters, src/MCMCcontrol.c:452-456), and
        # the age prior of a current pop defaults to the global tau-theta
        # prior (reference agePrior defaults, src/MCMCcontrol.c:276-300)
        pop.tau_print = cfg.mcmc.tau_theta_print
        pop.tau_alpha = cfg.mcmc.tau_theta_alpha
        pop.tau_beta = cfg.mcmc.tau_theta_beta
        while True:
            tok = c.next()
            if tok == "POP-END":
                break
            elif tok == "name":
                pop.name = c.next()
            elif tok == "samples":
                # read (name, h|d) pairs until the next known keyword
                while True:
                    nxt = c.peek()
                    if nxt is None or nxt in (
                        "POP-END", "name", "theta-print", "theta-alpha",
                        "theta-beta", "age", "samples",
                    ):
                        break
                    nm = c.next()
                    fmt = c.next()
                    if not _SAMPLE_RE.match(fmt):
                        raise ControlFileError(
                            f"sample format must be h or d, got {fmt!r} "
                            f"for sample {nm!r} in pop {pop.name!r}"
                        )
                    pop.samples.append((nm, fmt))
            elif tok == "theta-print":
                pop.theta_print = c.next_float(tok)
            elif tok == "theta-alpha":
                pop.theta_alpha = c.next_float(tok)
            elif tok == "theta-beta":
                pop.theta_beta = c.next_float(tok)
            elif tok == "age":
                pop.sample_age = c.next_float(tok)
                flag = c.next()
                if flag == "f":
                    pop.update_sample_age = False
                    if pop.sample_age != 0.0:
                        # fixed ancient age disables mixing
                        # (reference: src/MCMCcontrol.c:903-906)
                        cfg.mcmc.do_mixing = False
                elif flag == "e":
                    pop.update_sample_age = True
                else:
                    raise ControlFileError(
                        f"POP age flag must be f or e, got {flag!r}"
                    )
            else:
                raise ControlFileError(
                    f"unknown CURRENT-POPS attribute {tok!r}"
                )
        if not pop.name:
            raise ControlFileError("current pop without a name")
        if not pop.samples:
            raise ControlFileError(f"no samples for pop {pop.name!r}")
        cfg.cur_pops.append(pop)


def _parse_ancestral_pops(c: _Cursor, cfg: RunConfig):
    c.expect("ANCESTRAL-POPS-START")
    while True:
        tok = c.next()
        if tok == "ANCESTRAL-POPS-END":
            break
        if tok != "POP-START":
            raise ControlFileError(f"expected POP-START, got {tok!r}")
        pop = PopSpec(name="", children=[])
        pop.theta_alpha = cfg.mcmc.tau_theta_alpha
        pop.theta_beta = cfg.mcmc.tau_theta_beta
        pop.theta_print = cfg.mcmc.tau_theta_print
        pop.tau_alpha = cfg.mcmc.tau_theta_alpha
        pop.tau_beta = cfg.mcmc.tau_theta_beta
        pop.tau_print = cfg.mcmc.tau_theta_print
        while True:
            tok = c.next()
            if tok == "POP-END":
                break
            elif tok == "name":
                pop.name = c.next()
            elif tok == "children":
                pop.children = [c.next(), c.next()]
            elif tok == "theta-print":
                pop.theta_print = c.next_float(tok)
            elif tok == "theta-alpha":
                pop.theta_alpha = c.next_float(tok)
            elif tok == "theta-beta":
                pop.theta_beta = c.next_float(tok)
            elif tok == "tau-print":
                pop.tau_print = c.next_float(tok)
            elif tok == "tau-alpha":
                pop.tau_alpha = c.next_float(tok)
            elif tok == "tau-beta":
                pop.tau_beta = c.next_float(tok)
            elif tok == "tau-initial":
                pop.tau_initial = c.next_float(tok)
            elif tok == "finetune-tau":
                pop.finetune_tau = c.next_float(tok)
            else:
                raise ControlFileError(
                    f"unknown ANCESTRAL-POPS attribute {tok!r}"
                )
        if not pop.name:
            raise ControlFileError("ancestral pop without a name")
        if not pop.children or len(pop.children) != 2:
            raise ControlFileError(
                f"ancestral pop {pop.name!r} must name exactly 2 children"
            )
        cfg.anc_pops.append(pop)


def _parse_mig_bands(c: _Cursor, cfg: RunConfig):
    if c.peek() != "MIG-BANDS-START":
        return
    c.expect("MIG-BANDS-START")
    while True:
        tok = c.next()
        if tok == "MIG-BANDS-END":
            break
        if tok != "BAND-START":
            raise ControlFileError(f"expected BAND-START, got {tok!r}")
        band = BandSpec(source="", target="")
        band.mig_rate_alpha = cfg.mcmc.mig_rate_alpha
        band.mig_rate_beta = cfg.mcmc.mig_rate_beta
        band.mig_rate_print = cfg.mcmc.mig_rate_print
        while True:
            tok = c.next()
            if tok == "BAND-END":
                break
            elif tok == "source":
                band.source = c.next()
            elif tok == "target":
                band.target = c.next()
            elif tok == "mig-rate-print":
                band.mig_rate_print = c.next_float(tok)
            elif tok == "mig-rate-alpha":
                band.mig_rate_alpha = c.next_float(tok)
            elif tok == "mig-rate-beta":
                band.mig_rate_beta = c.next_float(tok)
            else:
                raise ControlFileError(f"unknown MIG-BANDS attribute {tok!r}")
        if not band.source or not band.target:
            raise ControlFileError("migration band needs source and target")
        cfg.bands.append(band)


def _validate(cfg: RunConfig):
    """Settings validation (reference: src/MCMCcontrol.c:219-426)."""
    m = cfg.mcmc
    ft = m.finetunes
    if not m.find_finetunes:
        for nm, v in [
            ("coal-time", ft.coal_time), ("mig-time", ft.mig_time),
            ("theta", ft.theta), ("mig-rate", ft.mig_rate),
            ("mixing", ft.mixing),
        ]:
            if v < 0.0:
                raise ControlFileError(f"positive finetune-{nm} must be specified")
        if m.mut_rate_mode == 1 and ft.locus_rate < 0.0:
            raise ControlFileError("positive finetune-locus-rate must be specified")
    if m.iterations_per_log <= 0:
        m.iterations_per_log = 100
    if m.logs_per_line <= 0:
        m.logs_per_line = 100

    # admixture: a sample name appearing in two current pops becomes an
    # admixed sample; the second occurrence is removed (reference
    # parseSampleNames, src/MCMCcontrol.c:1368-1467 — note the reference's
    # dormant implementation decrements the wrong pop's sample count; the
    # corrected semantics are used here)
    cfg.admixed = []
    seen = {}
    for pi, p in enumerate(cfg.cur_pops):
        for (nm, fmt) in list(p.samples):
            if nm in seen:
                (pj, fmt0) = seen[nm]
                if not m.allow_admixture:
                    raise ControlFileError(
                        f"sample {nm!r} appears in two populations; "
                        "set 'admixture TRUE' to model admixture")
                if fmt0 != fmt:
                    raise ControlFileError(
                        f"admixed sample {nm!r} is {fmt0!r} in one pop "
                        f"and {fmt!r} in the other")
                p.samples.remove((nm, fmt))
                cfg.admixed.append((nm, pj, pi, fmt))
            else:
                seen[nm] = (pi, fmt)

    pop_names = [p.name for p in cfg.pops]
    if len(set(pop_names)) != len(pop_names):
        raise ControlFileError("duplicate population names")
    idx = cfg.pop_index()

    # theta priors must be set for all pops
    for p in cfg.pops:
        if p.theta_alpha < 0 or p.theta_beta < 0:
            raise ControlFileError(f"theta prior not set for pop {p.name!r}")
    # tau priors for ancestral pops; default sampleStart = prior mean
    for p in cfg.anc_pops:
        if p.tau_alpha < 0 or p.tau_beta < 0:
            raise ControlFileError(f"tau prior not set for pop {p.name!r}")
        if p.tau_initial <= 0:
            p.tau_initial = p.tau_alpha / p.tau_beta
        for ch in p.children:
            if ch not in idx:
                raise ControlFileError(
                    f"unknown child {ch!r} of ancestral pop {p.name!r}"
                )
    # topology sanity: every pop except the root has exactly one parent
    child_count = {}
    for p in cfg.anc_pops:
        for ch in p.children:
            child_count[ch] = child_count.get(ch, 0) + 1
            if child_count[ch] > 1:
                raise ControlFileError(f"pop {ch!r} has more than one parent")
    roots = [p.name for p in cfg.pops if p.name not in child_count]
    if len(roots) != 1:
        raise ControlFileError(f"expected exactly one root pop, found {roots}")
    if cfg.anc_pops and roots[0] != cfg.anc_pops[-1].name:
        raise ControlFileError(
            "last ancestral pop must be the root of the population tree"
        )

    # parent prior-mean and init-point monotonicity
    # (reference: src/MCMCcontrol.c:311-340)
    parent = {}
    for p in cfg.anc_pops:
        for ch in p.children:
            parent[ch] = p
    for p in cfg.anc_pops:
        if p.name in parent:
            fa = parent[p.name]
            if fa.tau_alpha / fa.tau_beta < p.tau_alpha / p.tau_beta:
                raise ControlFileError(
                    f"conflicting tau priors for {p.name!r} and parent {fa.name!r}"
                )
            if fa.tau_initial < p.tau_initial:
                raise ControlFileError(
                    f"conflicting tau-initial for {p.name!r} and parent {fa.name!r}"
                )
    for p in cfg.cur_pops:
        fa = parent.get(p.name)
        if fa is not None and fa.tau_alpha / fa.tau_beta < p.sample_age:
            raise ControlFileError(
                f"parent tau prior below sample age for pop {p.name!r}"
            )

    # mig band endpoints must exist and not be ancestrally related
    anc = ancestry_matrix(cfg)
    for b in cfg.bands:
        for nm in (b.source, b.target):
            if nm not in idx:
                raise ControlFileError(f"unknown pop {nm!r} in migration band")
        if b.mig_rate_alpha < 0 or b.mig_rate_beta < 0:
            raise ControlFileError(
                f"mig rate prior not set for band {b.source}->{b.target}"
            )
        s, t = idx[b.source], idx[b.target]
        if s == t or anc[s][t] or anc[t][s]:
            raise ControlFileError(
                f"invalid migration band {b.source}->{b.target}: "
                "populations are ancestrally related"
            )

    # per-pop tau finetunes
    ntaus = [ft.taus[0] if ft.taus else -1.0] * cfg.num_pops
    for i, p in enumerate(cfg.anc_pops):
        if p.finetune_tau >= 0:
            ntaus[cfg.num_cur_pops + i] = p.finetune_tau
    ft.taus = ntaus
    if not m.find_finetunes:
        for i in range(cfg.num_cur_pops, cfg.num_pops):
            if ft.taus[i] < 0:
                raise ControlFileError(
                    f"finetune not set for tau of ancestral pop "
                    f"{cfg.pops[i].name!r}"
                )


def ancestry_matrix(cfg: RunConfig):
    """anc[i][j] == True iff pop i is an ancestor of (or equal to) pop j
    (reference: isAncestralTo of src/PopulationTree.h)."""
    n = cfg.num_pops
    idx = cfg.pop_index()
    anc = [[False] * n for _ in range(n)]
    for i in range(n):
        anc[i][i] = True
    for p in cfg.anc_pops:
        i = idx[p.name]
        for ch in p.children:
            j = idx[ch]
            for k in range(n):
                if anc[j][k]:
                    anc[i][k] = True
    # propagate up repeatedly (tree depth <= n)
    changed = True
    while changed:
        changed = False
        for p in cfg.anc_pops:
            i = idx[p.name]
            for ch in p.children:
                j = idx[ch]
                for k in range(n):
                    if anc[j][k] and not anc[i][k]:
                        anc[i][k] = True
                        changed = True
    return anc


def parse_control_text(text: str, secondary_text: Optional[str] = None) -> RunConfig:
    cfg = RunConfig()
    c = _Cursor(_tokenize(text))
    _parse_general_info(c, cfg.mcmc)
    _parse_current_pops(c, cfg)
    _parse_ancestral_pops(c, cfg)
    _parse_mig_bands(c, cfg)
    if secondary_text is not None:
        toks = _tokenize(secondary_text)
        c2 = _Cursor(toks)
        if c2.peek() == "GENERAL-INFO-START":
            _parse_general_info(c2, cfg.mcmc)
        if c2.peek() == "MIG-BANDS-START":
            cfg.bands = []
            _parse_mig_bands(c2, cfg)
    _validate(cfg)
    return cfg


def parse_control_file(path: str, secondary_path: Optional[str] = None) -> RunConfig:
    with open(path) as f:
        text = f.read()
    sec = None
    if secondary_path is not None:
        with open(secondary_path) as f:
            sec = f.read()
    return parse_control_text(text, sec)
