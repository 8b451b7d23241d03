"""LADIES layer-wise importance sampling (Zou et al. [51]; paper §4.7), the
port's copy of `repro.sampling.ladies`.

Instead of per-node fan-out, LADIES samples a fixed number of nodes per
*layer*, with probability proportional to the squared row norm of the
normalized Laplacian restricted to the current frontier's columns — i.e.
p(u) ∝ sum_{v in frontier} A_hat[v,u]^2.

Host implementation (numpy) used by the pipeline; sizes per layer are
fixed, so downstream shapes stay static.  Blocks are bit-identical to the
reference for the same `np.random.Generator` state: the per-frontier-node
loop and its buffered `probs[nbrs] += ...` are kept, because a node
repeated within one row counts once there (`np.add.at` would count it
twice).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph
from .neighbor import SampledBlocks


def ladies_sample_blocks(graph: CSRGraph, seeds: np.ndarray,
                         layer_sizes: Sequence[int],
                         rng: np.random.Generator) -> SampledBlocks:
    frontier = seeds.astype(np.int64)
    hop_nodes = []
    for size in layer_sizes:
        # importance: p(u) ∝ Σ_{v∈frontier} (1/deg(v))^2 over edges v->u
        probs = np.zeros(graph.num_nodes)
        for v in frontier:
            nbrs = graph.indices[graph.indptr[v]:graph.indptr[v + 1]]
            if len(nbrs):
                probs[nbrs] += 1.0 / (len(nbrs) ** 2)
        total = probs.sum()
        if total <= 0:  # isolated frontier: fall back to uniform
            cand = rng.integers(0, graph.num_nodes, size)
        else:
            p = probs / total
            nnz = int((p > 0).sum())
            if nnz >= size:
                cand = rng.choice(graph.num_nodes, size=size, replace=False,
                                  p=p)
            else:  # fewer candidates than layer size: take all + pad
                cand = np.flatnonzero(p > 0)
                pad = rng.integers(0, graph.num_nodes, size - nnz)
                cand = np.concatenate([cand, pad])
        hop_nodes.append(cand.astype(np.int64))
        frontier = cand.astype(np.int64)
    all_nodes = np.unique(np.concatenate([seeds.astype(np.int64), *hop_nodes]))
    n_req = int(seeds.shape[0] + sum(h.shape[0] for h in hop_nodes))
    return SampledBlocks(seeds=seeds, hop_nodes=hop_nodes,
                         all_nodes=all_nodes, num_requests=n_req)
