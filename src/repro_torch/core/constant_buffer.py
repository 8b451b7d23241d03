"""Constant CPU buffer (paper §3.3), the port's copy of
`repro.core.constant_buffer`.

Pins the features of hot nodes (top weighted-reverse-PageRank) in host
memory; requests for pinned nodes are redirected off the SSD.
`membership` is a dense node->slot map (int32, -1 = not pinned).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.pagerank import hot_nodes


class ConstantBuffer:
    def __init__(self, num_nodes: int, pinned_ids: np.ndarray,
                 features: np.ndarray | None = None):
        self.membership = np.full(num_nodes, -1, dtype=np.int32)
        self.membership[pinned_ids] = np.arange(len(pinned_ids),
                                                dtype=np.int32)
        self.pinned_ids = pinned_ids
        # rows stored in pinned order; optional (id-only mode for pricing)
        self.rows = features[pinned_ids] if features is not None else None

    @classmethod
    def from_graph(cls, graph: CSRGraph, fraction: float,
                   features: np.ndarray | None = None,
                   metric: np.ndarray | None = None,
                   selection: str = "pagerank", seed: int = 0,
                   ) -> "ConstantBuffer":
        """selection: 'pagerank' (paper default), 'degree', or 'random'."""
        if selection == "pagerank":
            ids = hot_nodes(graph, fraction, metric=metric)
        elif selection == "degree":
            k = max(1, int(graph.num_nodes * fraction))
            ids = np.argsort(-graph.degrees(), kind="stable")[:k]
        elif selection == "random":
            rng = np.random.default_rng(seed)
            k = max(1, int(graph.num_nodes * fraction))
            ids = rng.choice(graph.num_nodes, size=k, replace=False)
        else:
            raise ValueError(selection)
        return cls(graph.num_nodes, ids.astype(np.int64), features)

    def lookup(self, node_ids: np.ndarray) -> np.ndarray:
        """slot per request, -1 = not pinned (goes to storage)."""
        return self.membership[node_ids]

    def redirect_mask(self, node_ids: np.ndarray) -> np.ndarray:
        return self.membership[node_ids] >= 0

    def gather(self, node_ids: np.ndarray) -> np.ndarray:
        if self.rows is None:
            raise ValueError("gather() on an id-only constant buffer")
        slots = self.membership[node_ids]
        if not (slots >= 0).all():
            raise ValueError("gather() on un-pinned ids")
        return self.rows[slots]

    @property
    def size(self) -> int:
        return len(self.pinned_ids)
