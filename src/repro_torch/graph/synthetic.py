"""RMAT and uniform synthetic graphs standing in for IGB/OGB, the port's
copy of `repro.graph.synthetic` (`clustered_graph` waits for the sharded
planes, ROADMAP.md Queue 1)."""
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
