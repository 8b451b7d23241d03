"""GraphSAGE uniform neighborhood sampling (paper §2.2.2), the port of
`repro.sampling.neighbor`.

Host path (numpy) for the GIDS pipeline: blocks are bit-identical to the
reference for the same `np.random.Generator` state.  Device path
(`device_sample_blocks`, torch on the CSR's device) for the GPU sampler the
paper motivates (fig3, fig7): the reference's math with draws from a
`torch.Generator`, so it matches the reference by property (shapes,
neighbour-or-self-loop), not by bits.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, DeviceCSR, device_index_dtype


@dataclasses.dataclass
class SampledBlocks:
    """One mini-batch's sampled computational graph.

    seeds:      (B,) the hop-0 target nodes
    hop_nodes:  list per hop: (B * prod(fanouts[:l]),) source node ids
                (padded with the destination node itself when degree 0)
    all_nodes:  sorted unique node ids whose features must be gathered
    num_requests: total requests across seeds and hops
    """
    seeds: np.ndarray
    hop_nodes: list
    all_nodes: np.ndarray
    num_requests: int


def sample_hop(graph: CSRGraph, frontier: np.ndarray, fanout: int,
               rng: np.random.Generator, read_words=None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One uniform-with-replacement hop; degree-0 destinations self-loop.
    Returns the flattened sampled ids, the (F, fanout) edge positions read
    and the (F,) frontier degrees.  `read_words(pos)` reads the adjacency
    words at `pos` (default `graph.indices[pos]`; the topology plane reads
    them through its tiered page store)."""
    start = graph.indptr[frontier]
    deg = graph.indptr[frontier + 1] - start
    r = rng.random((frontier.shape[0], fanout))
    offs = np.floor(r * np.maximum(deg, 1)[:, None]).astype(np.int64)
    pos = np.minimum(start[:, None] + offs, graph.num_edges - 1)
    words = graph.indices[pos] if read_words is None else read_words(pos)
    nbr = words.astype(np.int64)
    nbr = np.where(deg[:, None] > 0, nbr, frontier[:, None])
    return nbr.reshape(-1), pos, deg


def run_sample_hops(graph: CSRGraph, seeds: np.ndarray,
                    fanouts: Sequence[int], rng: np.random.Generator,
                    hop_cb=None, read_words=None
                    ) -> tuple[list, np.ndarray, int]:
    """Frontier loop over `sample_hop`, unique-union of all hops, request
    counting.  `hop_cb(hop, read_pos, n_frontier)` observes each hop's
    adjacency reads; `read_words` is handed to `sample_hop`."""
    frontier = seeds.astype(np.int64)
    hop_nodes: list[np.ndarray] = []
    for hop, f in enumerate(fanouts):
        nbr, pos, deg = sample_hop(graph, frontier, f, rng, read_words)
        if hop_cb is not None:
            hop_cb(hop, pos[deg > 0].reshape(-1), len(frontier))
        hop_nodes.append(nbr)
        frontier = nbr
    all_nodes = np.unique(np.concatenate([seeds.astype(np.int64), *hop_nodes]))
    n_req = int(seeds.shape[0] + sum(h.shape[0] for h in hop_nodes))
    return hop_nodes, all_nodes, n_req


def host_sample_blocks(graph: CSRGraph, seeds: np.ndarray,
                       fanouts: Sequence[int], rng: np.random.Generator
                       ) -> SampledBlocks:
    hop_nodes, all_nodes, n_req = run_sample_hops(graph, seeds, fanouts, rng)
    return SampledBlocks(seeds=seeds, hop_nodes=hop_nodes,
                         all_nodes=all_nodes, num_requests=n_req)


def device_sample_blocks(csr: DeviceCSR, seeds, fanouts: Sequence[int],
                         generator: torch.Generator
                         ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Fixed-fanout uniform sampler on the CSR's device.  Returns (list of
    per-hop node tensors, flat concatenated node ids); shapes are static
    given (|seeds|, fanouts).  Ids carry `device_index_dtype`, the host
    path's policy.  Each hop draws one `torch.rand` from `generator` (a
    generator on the CSR's device); where the reference folds the hop index
    into its key, here the generator's offset advances."""
    dev = csr.indptr.device
    n_edges = csr.indices.shape[0]
    dt = device_index_dtype(csr.num_nodes, n_edges)
    seeds = torch.as_tensor(seeds).to(dev, dt)
    frontier = seeds
    hops = []
    for f in fanouts:
        start = csr.indptr[frontier]
        deg = csr.indptr[frontier + 1] - start
        r = torch.rand((frontier.shape[0], f), generator=generator,
                       device=dev)
        offs = torch.floor(r * deg.clamp(min=1)[:, None]).to(dt)
        idx = torch.clamp(start[:, None] + offs, max=n_edges - 1)
        nbr = csr.indices[idx].to(dt)
        nbr = torch.where(deg[:, None] > 0, nbr, frontier[:, None])
        nbr = nbr.reshape(-1)
        hops.append(nbr)
        frontier = nbr
    return hops, torch.cat([seeds, *hops])


def subgraph_sizes(batch: int, fanouts: Sequence[int]) -> int:
    """Closed-form node count of a padded sampled subgraph:
    B * (1 + f1 + f1*f2 + ...), equal to `SampledBlocks.num_requests`."""
    n, prod = batch, batch
    for f in fanouts:
        prod *= f
        n += prod
    return n
