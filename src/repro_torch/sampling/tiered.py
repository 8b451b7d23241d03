"""Tiered GPU-initiated sampling, the port of `repro.sampling.tiered`: the
priced twin of `host_sample_blocks`.

`tiered_sample_blocks` runs the host sampling math (`neighbor.sample_hop`,
consuming the SAME `np.random.Generator` stream) against a
`TieredTopologyStore`: per hop it records which 4 KB edge pages the sampled
reads touched, splits them by tier and prices the hop, giving one
`TopologyGatherReport` per hop and a total `sample_time_s`.  Blocks,
reports and times are bit-identical to the reference.

Unlike the reference, which reads the sampled words on the host, the port
reads them through the store's device data path
(`TieredTopologyStore.frontier_gather`: on CUDA one `frontier_read` launch
per hop, hot words from device memory and the rest read in place from the
adjacency in pinned host memory); those words equal `graph.indices[pos]`
bit for bit, so the blocks are unchanged.  A `tracer` (repro_torch.obs)
wall-clocks the whole sampling sweep as one `sample` stage and attaches the
summed priced hop time to it.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.obs import NULL_TRACER
from .neighbor import SampledBlocks, run_sample_hops

if TYPE_CHECKING:   # core imports this module through the loader
    from repro_torch.core.topology import (TieredTopologyStore,
                                           TopologyGatherReport)


@dataclasses.dataclass
class TieredSampledBlocks(SampledBlocks):
    """`SampledBlocks` plus one priced `TopologyGatherReport` per hop and
    their summed modelled time."""

    hop_reports: list = dataclasses.field(default_factory=list)
    sample_time_s: float = 0.0


def tiered_sample_blocks(graph: CSRGraph, topo: TieredTopologyStore,
                         seeds: np.ndarray, fanouts: Sequence[int],
                         rng: np.random.Generator,
                         tracer=None) -> TieredSampledBlocks:
    """`tracer` wall-clocks the sweep and attaches its priced time:
    observation only, the blocks and reports are the same without it."""
    if tracer is None:
        tracer = NULL_TRACER
    reports: list[TopologyGatherReport] = []

    def price_hop(hop: int, read_pos: np.ndarray, n_frontier: int) -> None:
        # only destinations with edges read adjacency words; degree-0 rows'
        # positions are self-loop padding, already filtered out of read_pos
        reports.append(topo.hop_report(read_pos, hop=hop,
                                       n_frontier=n_frontier))

    with tracer.stage("sample", cat="sample", seeds=len(seeds)) as sp:
        hop_nodes, all_nodes, n_req = run_sample_hops(
            graph, seeds, fanouts, rng, hop_cb=price_hop,
            read_words=topo.frontier_gather)
        sample_time_s = float(sum(r.time_s for r in reports))
        sp.modelled(sample_time_s)
    return TieredSampledBlocks(
        seeds=seeds, hop_nodes=hop_nodes, all_nodes=all_nodes,
        num_requests=n_req, hop_reports=reports,
        sample_time_s=sample_time_s)
