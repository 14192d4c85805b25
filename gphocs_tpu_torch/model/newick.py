"""Newick tree reading/writing for genealogies and population trees.

Equivalent of the reference's GenericTree (src/GenericTree.c: flat-array
binary trees, readGenericTree :220 / printGenericTree :393, branch-length
<-> age conversion :118-140).  The same flat-array convention is used:
(father, lson, rson, age) int/float arrays with leaves 0..S-1.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def genealogy_to_newick(father, lson, rson, age, root: int,
                        leaf_names: Optional[List[str]] = None,
                        digits: int = 10) -> str:
    """Serialize one genealogy to a Newick string with branch lengths
    (age differences, reference ageIntoBranchLength semantics)."""

    def rec(v: int) -> str:
        if lson[v] < 0:
            name = leaf_names[v] if leaf_names else str(v)
        else:
            name = f"({rec(lson[v])},{rec(rson[v])})"
        if v == root:
            return name
        bl = age[father[v]] - age[v]
        return f"{name}:{bl:.{digits}g}"

    return rec(int(root)) + ";"


def parse_newick(text: str, leaf_names: Optional[List[str]] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            int, List[str]]:
    """Parse a (binary, rooted) Newick string.

    Returns (father, lson, rson, age, root, leaf_names).  Ages are derived
    from branch lengths with leaves at age 0 (reference
    branchLengthIntoAge, src/GenericTree.c:118).  Leaves are numbered
    0..S-1 either by `leaf_names` order or by first appearance.
    """
    text = text.strip().rstrip(";")
    pos = 0

    def parse_node():
        nonlocal pos
        if text[pos] == "(":
            pos += 1
            left = parse_node()
            assert text[pos] == ",", f"expected ',' at {pos}"
            pos += 1
            right = parse_node()
            assert text[pos] == ")", f"expected ')' at {pos}"
            pos += 1
            # optional internal label
            label = ""
            while pos < len(text) and text[pos] not in ":,();":
                label += text[pos]
                pos += 1
            node = ("internal", left, right)
        else:
            name = ""
            while pos < len(text) and text[pos] not in ":,();":
                name += text[pos]
                pos += 1
            node = ("leaf", name)
        bl = 0.0
        if pos < len(text) and text[pos] == ":":
            pos += 1
            num = ""
            while pos < len(text) and text[pos] not in ",();":
                num += text[pos]
                pos += 1
            bl = float(num)
        return (node, bl)

    tree, _ = parse_node()

    leaves: List[str] = []

    def count(node):
        kind = node[0]
        if kind == "leaf":
            leaves.append(node[1])
        else:
            count(node[1][0])
            count(node[2][0])

    count(tree)
    S = len(leaves)
    if leaf_names is None:
        leaf_names = leaves
    name_to_id = {nm: i for i, nm in enumerate(leaf_names)}
    N = 2 * S - 1
    father = np.full(N, -1, np.int32)
    lson = np.full(N, -1, np.int32)
    rson = np.full(N, -1, np.int32)
    depth = np.zeros(N)  # distance below root
    next_internal = [S]

    def build(node, bl, d) -> int:
        kind = node[0]
        if kind == "leaf":
            v = name_to_id[node[1]]
        else:
            v = next_internal[0]
            next_internal[0] += 1
            a = build(node[1][0], node[1][1], d + bl)
            b = build(node[2][0], node[2][1], d + bl)
            lson[v], rson[v] = a, b
            father[a] = father[b] = v
        depth[v] = d + bl
        return v

    root = build(tree, 0.0, 0.0)
    age = depth.max() - depth
    return father, lson, rson, age, int(root), list(leaf_names)


def poptree_to_newick(tree, tau) -> str:
    """Population tree with divergence times as an annotated Newick."""
    def rec(p: int) -> str:
        if tree.sons[p, 0] < 0:
            s = tree.names[p]
        else:
            s = f"({rec(tree.sons[p, 0])},{rec(tree.sons[p, 1])}){tree.names[p]}"
        if tree.father[p] >= 0:
            s += f":{tau[tree.father[p]] - tau[p]:.10g}"
        return s

    return rec(tree.root_pop) + ";"
