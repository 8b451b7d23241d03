"""Heterogeneous graphs: typed nodes in one id space and one CSR per
relation.

Node type t owns the global ids `[offsets[t], offsets[t] + counts[t])`,
the types laid out in the order given, so one feature table of
`num_nodes` rows serves every type.  A relation `(src_type, name,
dst_type)` holds a CSR over its destination type's rows (local row v is
global id `offsets[dst_type] + v`) listing the global ids of the sources
whose messages v receives: what a sampler draws from v.

`union()` folds every relation into one homogeneous `CSRGraph` over the
global ids: row v lists the sources of every relation into v's type,
relation by relation.  It is the graph the data plane reads (the reverse
PageRank that ranks the constant buffer, the node degrees).  A graph is
not changed after construction.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .csr import CSRGraph, index_dtype


@dataclasses.dataclass(frozen=True)
class Relation:
    """One relation's CSR: destination rows (local ids of `dst_type`) to
    global source ids of `src_type`."""

    src_type: str
    name: str
    dst_type: str
    indptr: np.ndarray     # (counts[dst_type] + 1,) int64
    indices: np.ndarray    # (E,) global source ids

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


class HeteroGraph:
    """Typed nodes and per-relation CSRs over one global id space.  Every
    relation is checked on construction: its types exist, its `indptr`
    covers its destination type and is monotone, and every source id lies
    in its source type's range."""

    def __init__(self, node_types: Mapping[str, int],
                 relations: Sequence[Relation], feature_dim: int = 0,
                 name: str = "hetero"):
        self.node_types = tuple(node_types)
        self.counts = {t: int(n) for t, n in node_types.items()}
        starts = np.concatenate([[0], np.cumsum(list(self.counts.values()))])
        self.offsets = {t: int(o) for t, o in zip(self.node_types, starts)}
        self.num_nodes = int(starts[-1])
        self.relations = tuple(relations)
        self.feature_dim = feature_dim
        self.name = name
        self._union: CSRGraph | None = None
        names = [r.name for r in self.relations]
        if len(set(names)) != len(names):
            raise ValueError(f"relation names repeat: {names}")
        for r in self.relations:
            self._check(r)

    def _check(self, r: Relation) -> None:
        for t in (r.src_type, r.dst_type):
            if t not in self.counts:
                raise ValueError(f"relation {r.name!r}: unknown node type "
                                 f"{t!r}; types are {self.node_types}")
        n_dst = self.counts[r.dst_type]
        if r.indptr.shape != (n_dst + 1,) or r.indptr[0] != 0 \
                or r.indptr[-1] != r.num_edges \
                or np.any(np.diff(r.indptr) < 0):
            raise ValueError(f"relation {r.name!r}: indptr does not cover "
                             f"the {n_dst} rows of {r.dst_type!r} and its "
                             f"{r.num_edges} edges")
        lo, hi = self.type_range(r.src_type)
        if r.num_edges and (r.indices.min() < lo or r.indices.max() >= hi):
            raise ValueError(f"relation {r.name!r}: a source id lies outside "
                             f"{r.src_type!r}'s ids [{lo}, {hi})")

    @property
    def num_edges(self) -> int:
        return sum(r.num_edges for r in self.relations)

    def type_range(self, node_type: str) -> tuple[int, int]:
        """The global ids `[lo, hi)` of `node_type`."""
        lo = self.offsets[node_type]
        return lo, lo + self.counts[node_type]

    def union(self) -> CSRGraph:
        """Every relation in one CSR over the global ids: row v holds the
        sources of each relation into v's type, in relation order.  Built
        on the first call and kept (the relations do not change)."""
        if self._union is None:
            self._union = self._build_union()
        return self._union

    def _build_union(self) -> CSRGraph:
        n, e = self.num_nodes, self.num_edges
        deg = np.zeros(n, np.int64)
        for r in self.relations:
            lo, hi = self.type_range(r.dst_type)
            deg[lo:hi] += r.degrees()
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = np.empty(e, dtype=index_dtype(max(n, e)))
        fill = indptr[:-1].copy()          # each row's next free position
        for r in self.relations:
            lo, hi = self.type_range(r.dst_type)
            d = r.degrees()
            pos = (np.repeat(fill[lo:hi] - r.indptr[:-1], d)
                   + np.arange(r.num_edges))
            indices[pos] = r.indices
            fill[lo:hi] += d
        return CSRGraph(indptr=indptr, indices=indices, num_nodes=n,
                        feature_dim=self.feature_dim, name=self.name)
