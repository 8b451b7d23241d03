"""RMAT, community-structured and uniform synthetic graphs standing in for
IGB/OGB, the port's copy of `repro.graph.synthetic`."""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edge_list


def rmat_edges(num_nodes: int, num_edges: int, *, a=0.57, b=0.19, c=0.19,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Recursive-matrix (RMAT) edge generator: power-law degree skew like
    real citation/web graphs."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_nodes, 2))))
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for level in range(scale):
        r = rng.random(num_edges)
        src_bit = (r >= a + b).astype(np.int64)
        # quadrant probabilities: [a, b; c, d]
        dst_bit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    src %= num_nodes
    dst %= num_nodes
    keep = src != dst
    return src[keep], dst[keep]


def rmat_graph(num_nodes: int, avg_degree: int, feature_dim: int,
               *, seed: int = 0, name: str = "rmat") -> CSRGraph:
    src, dst = rmat_edges(num_nodes, num_nodes * avg_degree, seed=seed)
    return from_edge_list(src, dst, num_nodes, feature_dim=feature_dim,
                          name=name)


def clustered_graph(num_nodes: int, avg_degree: int, feature_dim: int,
                    *, communities: int = 32, intra: float = 0.9,
                    seed: int = 0, name: str = "clustered") -> CSRGraph:
    """Community-structured power-law graph — the locality real GNN
    datasets have and pure RMAT lacks.

    ogbn-products / IGB-style graphs partition well (METIS finds cuts in
    the few-percent range) because their edges cluster: products co-bought,
    papers co-cited.  Pure RMAT scrambles endpoints at every recursion
    level, so no partitioner can find a good cut and multi-host placement
    studies degenerate.  This generator keeps RMAT's hub skew *within* each
    community (each block is its own small RMAT) and rewires a
    `1 - intra` fraction of destinations uniformly across the whole graph,
    so cut quality is a controllable property: `intra=0.9` leaves a
    ~10 % floor for an oracle partitioner, `intra=0.0` degenerates to a
    scrambled graph."""
    if not 0.0 <= intra <= 1.0:
        raise ValueError(f"intra must be in [0, 1], got {intra}")
    communities = max(1, min(int(communities), num_nodes))
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, num_nodes, communities + 1).astype(np.int64)
    srcs, dsts = [], []
    for c in range(communities):
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        m = hi - lo
        if m <= 1:
            continue
        s, d = rmat_edges(m, m * avg_degree, seed=seed + 7919 * (c + 1))
        srcs.append(s + lo)
        dsts.append(d + lo)
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    rewire = rng.random(len(dst)) >= intra
    dst[rewire] = rng.integers(0, num_nodes, int(rewire.sum()))
    keep = src != dst
    return from_edge_list(src[keep], dst[keep], num_nodes,
                          feature_dim=feature_dim, name=name)


def uniform_graph(num_nodes: int, avg_degree: int, feature_dim: int,
                  *, seed: int = 0, name: str = "uniform") -> CSRGraph:
    """Erdos-Renyi-style graph: both endpoints of every edge uniform (no
    degree skew), self-loops dropped."""
    rng = np.random.default_rng(seed)
    e = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, e)
    dst = rng.integers(0, num_nodes, e)
    keep = src != dst
    return from_edge_list(src[keep], dst[keep], num_nodes,
                          feature_dim=feature_dim, name=name)
