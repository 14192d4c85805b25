"""A plain reader of G-PhoCS control files: the population tree, the
samples and the migration bands, which the data generator and the plain
reference need.

It reads one setting per line (`# ...` is a comment) and keeps what the
genealogy's prior and the data's layout depend on.  Populations are
indexed as G-PhoCS indexes them: the current populations in file order,
then the ancestral ones in file order, the last being the root.  A sample
`name d` (diploid) takes two haploid slots, `name h` one; slots follow the
current populations in order, so the leaves of a genealogy are grouped by
population.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Pop:
    name: str
    children: List[str] = field(default_factory=list)
    samples: List[tuple] = field(default_factory=list)  # (name, "d"|"h")
    theta_alpha: float = -1.0
    theta_beta: float = -1.0
    tau_alpha: float = -1.0
    tau_beta: float = -1.0
    tau_initial: float = 0.0
    sample_age: float = 0.0


@dataclass
class Band:
    source: str
    target: str
    alpha: float = -1.0
    beta: float = -1.0


@dataclass
class Control:
    pops: List[Pop]
    num_current: int
    bands: List[Band]
    settings: Dict[str, List[str]]

    @property
    def num_pops(self) -> int:
        return len(self.pops)

    def index(self, name: str) -> int:
        for i, p in enumerate(self.pops):
            if p.name == name:
                return i
        raise ValueError(f"no population {name!r}")

    @property
    def father(self) -> List[int]:
        fa = [-1] * self.num_pops
        for i, p in enumerate(self.pops):
            for ch in p.children:
                fa[self.index(ch)] = i
        return fa

    def ancestors(self, pop: int) -> List[int]:
        """pop and every population above it, from pop up to the root."""
        fa = self.father
        out = [pop]
        while fa[out[-1]] >= 0:
            out.append(fa[out[-1]])
        return out

    @property
    def slots(self) -> List[dict]:
        """One entry per haploid slot (leaf): its sample's name, whether
        the sample is diploid, whether the slot is the sample's first, and
        its population."""
        out = []
        for pi in range(self.num_current):
            for name, kind in self.pops[pi].samples:
                out.append(dict(name=name, diploid=kind == "d", first=True,
                                pop=pi))
                if kind == "d":
                    out.append(dict(name=name, diploid=True, first=False,
                                    pop=pi))
        return out

    @property
    def admixed(self) -> bool:
        names = [s for p in self.pops[:self.num_current]
                 for s, _ in p.samples]
        return len(names) != len(set(names))


def parse(text: str) -> Control:
    settings: Dict[str, List[str]] = {}
    cur: List[Pop] = []
    anc: List[Pop] = []
    bands: List[Band] = []
    section = None
    item = None
    for raw in text.splitlines():
        toks = raw.split("#", 1)[0].split()
        if not toks:
            continue
        key, vals = toks[0], toks[1:]
        if key.endswith("-START") and key not in ("POP-START", "BAND-START"):
            section = key[:-len("-START")]
            continue
        if key.endswith("-END") and key not in ("POP-END", "BAND-END"):
            section = None
            continue
        if section == "GENERAL-INFO":
            settings[key] = vals
        elif key == "POP-START":
            item = Pop(name="")
            (cur if section == "CURRENT-POPS" else anc).append(item)
        elif key == "BAND-START":
            item = Band(source="", target="")
            bands.append(item)
        elif key in ("POP-END", "BAND-END"):
            item = None
        elif isinstance(item, Pop):
            if key == "name":
                item.name = vals[0]
            elif key == "samples":
                item.samples += list(zip(vals[0::2], vals[1::2]))
            elif key == "children":
                item.children = vals[:2]
            elif key in ("theta-alpha", "theta-beta", "tau-alpha",
                         "tau-beta", "tau-initial"):
                setattr(item, key.replace("-", "_"), float(vals[0]))
            elif key == "age":
                item.sample_age = float(vals[0])
        elif isinstance(item, Band):
            if key in ("source", "target"):
                setattr(item, key, vals[0])
            elif key in ("mig-rate-alpha", "mig-rate-beta"):
                setattr(item, key.split("-")[-1], float(vals[0]))

    def general(name: str) -> float:
        return float(settings[name][0]) if name in settings else -1.0

    for p in cur + anc:
        for attr, default in (("theta_alpha", "tau-theta-alpha"),
                              ("theta_beta", "tau-theta-beta"),
                              ("tau_alpha", "tau-theta-alpha"),
                              ("tau_beta", "tau-theta-beta")):
            if getattr(p, attr) < 0:
                setattr(p, attr, general(default))
    for b in bands:
        if b.alpha < 0:
            b.alpha = general("mig-rate-alpha")
        if b.beta < 0:
            b.beta = general("mig-rate-beta")
    return Control(pops=cur + anc, num_current=len(cur), bands=bands,
                   settings=settings)
