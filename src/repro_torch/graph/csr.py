"""CSR graph container (host-resident numpy), the port's copy of
`repro.graph.csr`.

Graph structure stays pinned in host memory while features live on
storage, as in the paper.  `DeviceCSR` and `device_index_dtype` wait for
the device sampler (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def index_dtype(max_index: int) -> type:
    """Smallest numpy integer dtype that can index `max_index` items: past
    2^31 ids everything widens to int64 together."""
    return np.int64 if max_index >= 2 ** 31 else np.int32


@dataclasses.dataclass
class CSRGraph:
    """Host (numpy) CSR adjacency: out-neighbors of node v are
    ``indices[indptr[v]:indptr[v+1]]``."""

    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (E,)  int32/int64
    num_nodes: int
    feature_dim: int = 0
    name: str = "graph"

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def reverse(self) -> "CSRGraph":
        """Transpose (in-neighbors), used by reverse PageRank."""
        n = self.num_nodes
        counts = np.bincount(self.indices, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        indices = np.empty(self.num_edges, dtype=self.indices.dtype)
        src = np.repeat(np.arange(n, dtype=self.indices.dtype), self.degrees())
        # stable counting-sort scatter
        order = np.argsort(self.indices, kind="stable")
        indices[:] = src[order]
        return CSRGraph(indptr=indptr, indices=indices, num_nodes=n,
                        feature_dim=self.feature_dim, name=self.name + "_rev")

    def to_device(self, pad_degree=None):
        raise NotImplementedError(
            "DeviceCSR waits for the device sampler (ROADMAP.md Queue 1: "
            "device_sample_blocks with a Philox sampler)")

    def structure_bytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes

    def feature_bytes(self, dtype_size: int = 4) -> int:
        return self.num_nodes * self.feature_dim * dtype_size


def from_edge_list(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   feature_dim: int = 0, name: str = "graph",
                   dedup: bool = True) -> CSRGraph:
    """Build CSR from COO edges (src -> dst)."""
    if dedup and len(src):
        key = src.astype(np.int64) * num_nodes + dst.astype(np.int64)
        _, uniq = np.unique(key, return_index=True)
        src, dst = src[uniq], dst[uniq]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int32),
                    num_nodes=num_nodes, feature_dim=feature_dim, name=name)
