"""CSR graph container (host-resident numpy), the port's copy of
`repro.graph.csr`.

Graph structure stays pinned in host memory while features live on
storage, as in the paper.  A device-resident copy (`DeviceCSR`) serves the
device sampler (`sampling.neighbor.device_sample_blocks`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device


def index_dtype(max_index: int) -> type:
    """Smallest numpy integer dtype that can index `max_index` items: past
    2^31 ids everything widens to int64 together."""
    return np.int64 if max_index >= 2 ** 31 else np.int32


def device_index_dtype(num_nodes: int, num_edges: int) -> torch.dtype:
    """The torch dtype device-side sampling uses for this graph's node and
    edge ids: int32 below 2^31 nodes and edges, int64 beyond, the same
    decision as `index_dtype`.  Torch has int64 on every device without a
    flag, so unlike the JAX package (which needs `jax_enable_x64`) there is
    no configuration that can refuse a large graph."""
    if index_dtype(max(num_nodes, num_edges)) is np.int64:
        return torch.int64
    return torch.int32


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

    def to_device(self, device: str | torch.device = "cuda") -> "DeviceCSR":
        """A copy of the structure on `device`.  indptr values run up to
        num_edges and indices up to num_nodes: both take the one dtype of
        `device_index_dtype`."""
        dev = resolve_device(device)
        dt = device_index_dtype(self.num_nodes, self.num_edges)
        return DeviceCSR(
            indptr=torch.as_tensor(self.indptr).to(dev, dt),
            indices=torch.as_tensor(self.indices).to(dev, dt),
            num_nodes=self.num_nodes)

    def structure_bytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes

    def feature_bytes(self, dtype_size: int = 4) -> int:
        return self.num_nodes * self.feature_dim * dtype_size


@dataclasses.dataclass
class DeviceCSR:
    """Device-resident CSR for the device sampler: tensors on one device,
    of the dtype `device_index_dtype` gives."""

    indptr: torch.Tensor
    indices: torch.Tensor
    num_nodes: int


def disjoint_union(graphs: Sequence["CSRGraph"],
                   name: str = "union") -> CSRGraph:
    """Concatenate CSR graphs into one graph over disjoint node-id ranges:
    graph k's node v becomes `sum(n_i for i < k) + v`, with no edges between
    components.  This is the multi-tenant colocation layout — each tenant
    serves its own dataset, all tenants share one feature plane, one cache,
    and one storage device — and the node ranges let a workload pin each
    tenant's traffic to its own component.
    """
    if not graphs:
        raise ValueError("need at least one graph")
    n_total = sum(g.num_nodes for g in graphs)
    e_total = sum(g.num_edges for g in graphs)
    idt = index_dtype(max(n_total, e_total))
    indptr = np.zeros(n_total + 1, dtype=np.int64)
    indices = np.empty(e_total, dtype=idt)
    node_off, edge_off = 0, 0
    for g in graphs:
        indptr[node_off + 1:node_off + g.num_nodes + 1] = \
            edge_off + g.indptr[1:]
        indices[edge_off:edge_off + g.num_edges] = \
            g.indices.astype(idt) + node_off
        node_off += g.num_nodes
        edge_off += g.num_edges
    return CSRGraph(indptr=indptr, indices=indices, num_nodes=n_total,
                    feature_dim=max(g.feature_dim for g in graphs),
                    name=name)


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
