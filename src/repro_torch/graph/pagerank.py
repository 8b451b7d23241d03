"""Weighted reverse PageRank, the paper's hot-node metric (§3.3); the
port's copy of `repro.graph.pagerank`."""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph


def reverse_pagerank(graph: CSRGraph, *, damping: float = 0.85,
                     iters: int = 20, weights: np.ndarray | None = None
                     ) -> np.ndarray:
    """Power-iteration PageRank on the reversed graph; `weights` are
    optional per-node teleport weights (uniform by default)."""
    rev = graph.reverse()
    n = graph.num_nodes
    if weights is None:
        tele = np.full(n, 1.0 / n)
    else:
        tele = weights / weights.sum()
    deg = rev.degrees().astype(np.float64)
    rank = tele.copy()
    src = np.repeat(np.arange(n), deg.astype(np.int64))
    dst = rev.indices
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    for _ in range(iters):
        contrib = rank * inv_deg
        new = np.zeros(n)
        np.add.at(new, dst, contrib[src])
        dangling = rank[deg == 0].sum()
        rank = (1 - damping) * tele + damping * (new + dangling * tele)
    return rank


def hot_nodes(graph: CSRGraph, fraction: float, *, iters: int = 20,
              metric: np.ndarray | None = None) -> np.ndarray:
    """Top-`fraction` node ids by reverse PageRank (or a user metric): the
    set pinned into the constant CPU buffer."""
    score = metric if metric is not None else reverse_pagerank(graph, iters=iters)
    k = max(1, int(graph.num_nodes * fraction))
    return np.argsort(-score, kind="stable")[:k].astype(np.int64)
