"""Per-relation fixed-fanout sampling over typed nodes, into deduplicated
blocks (the sampler of R-GAT on IGBH).

Hop k starts from level k, the sorted unique global ids the hop's
destinations are.  For every relation `(s, r, t)` of the graph, each node
of type t in level k draws `fanouts[k]` sources uniformly with replacement
from its row of r's CSR (the port's convention, `sampling/neighbor.py`).
A node with no edge in r draws nothing there: its slots are masked, where
the homogeneous sampler would pad with the node itself (which would put,
say, an author into a paper's slot).  Level k + 1 is the sorted unique
union of level k and every unmasked draw, so level k is a subset of level
k + 1 and each node appears once per level however many slots name it.

The last level is `all_nodes`, the rows the data plane gathers.  A node's
representation at a level depends only on its own slots, so one table row
per node and level is enough: the tree a fixed-fanout sampler keeps would
hold ~8 M rows at the last hop of a 1024-seed R-GAT batch.

Draws are taken relation by relation, in the graph's relation order, one
`rng.random((n_dst, f))` each, so the same `np.random.Generator` state
gives bit-identical blocks.  A `tracer` (repro_torch.obs) gets the draws as
`sample_relations` wall spans and the deduplication and position maps as
`build_blocks`, both in category `HOT_PATH`, a few of each per batch.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graph.hetero import HeteroGraph, Relation
from repro_torch.obs import HOT_PATH, NULL_TRACER


@dataclasses.dataclass
class RelationBlock:
    """One relation's slots at one hop, as positions into the levels.

    dst:  (n_dst,) positions in level k of the level's nodes of the
          relation's destination type, ascending
    src:  (n_dst, f) positions in level k + 1 of the drawn sources (0 where
          masked)
    mask: (n_dst, f) False where the destination has no edge in the
          relation
    """
    relation: int            # index into HeteroGraph.relations
    dst: np.ndarray
    src: np.ndarray
    mask: np.ndarray


@dataclasses.dataclass
class RelationalBlocks:
    """One mini-batch of R-GAT blocks.  `seeds`, `all_nodes` and
    `num_requests` keep `SampledBlocks`' contract, which is all the loader
    reads; `num_requests` counts the seeds and every unmasked slot.

    levels:    L + 1 sorted unique global ids, levels[k] within
               levels[k + 1]; levels[0] the seeds', levels[-1] `all_nodes`
    hops:      hops[k], one `RelationBlock` per relation of the graph
    level_pos: level_pos[k], the positions of levels[k] in levels[k + 1]
    """
    seeds: np.ndarray
    all_nodes: np.ndarray
    num_requests: int
    levels: list
    hops: list
    level_pos: list
    num_slots: int           # slots drawn, masked ones included
    num_masked: int


def _draw(rel: Relation, rows: np.ndarray, fanout: int,
          rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """`fanout` uniform draws with replacement from each local row of
    `rel`: (global source ids, 0 where masked; the mask)."""
    start = rel.indptr[rows]
    deg = rel.indptr[rows + 1] - start
    r = rng.random((rows.shape[0], fanout))
    mask = np.repeat((deg > 0)[:, None], fanout, axis=1)
    if rel.num_edges == 0:
        return np.zeros(r.shape, np.int64), mask
    offs = np.floor(r * np.maximum(deg, 1)[:, None]).astype(np.int64)
    pos = np.minimum(start[:, None] + offs, rel.num_edges - 1)
    ids = np.where(mask, rel.indices[pos], 0).astype(np.int64)
    return ids, mask


def relational_sample_blocks(hgraph: HeteroGraph, seeds: np.ndarray,
                             fanouts: Sequence[int],
                             rng: np.random.Generator,
                             tracer=None) -> RelationalBlocks:
    """Blocks of `len(fanouts)` hops from `seeds` over `hgraph`, hop k
    drawing `fanouts[k]` slots per destination and relation."""
    if tracer is None:
        tracer = NULL_TRACER
    seeds = np.asarray(seeds)
    with tracer.stage("build_blocks", cat=HOT_PATH):
        levels = [np.unique(seeds.astype(np.int64))]
    drawn: list[list[tuple[int, int, np.ndarray, np.ndarray]]] = []
    for f in fanouts:
        level = levels[-1]
        hop = []
        with tracer.stage("sample_relations", cat=HOT_PATH,
                          rows=len(level)):
            for i, rel in enumerate(hgraph.relations):
                lo, hi = np.searchsorted(level, hgraph.type_range(
                    rel.dst_type))
                rows = level[lo:hi] - hgraph.offsets[rel.dst_type]
                ids, mask = _draw(rel, rows, f, rng)
                hop.append((i, int(lo), ids, mask))
        with tracer.stage("build_blocks", cat=HOT_PATH):
            levels.append(np.unique(np.concatenate(
                [level] + [ids[mask] for _, _, ids, mask in hop])))
        drawn.append(hop)
    with tracer.stage("build_blocks", cat=HOT_PATH):
        hops, slots, masked = [], 0, 0
        for k, hop in enumerate(drawn):
            blocks = []
            for i, lo, ids, mask in hop:
                src = np.searchsorted(levels[k + 1], ids)
                src[~mask] = 0
                blocks.append(RelationBlock(
                    relation=i, dst=np.arange(lo, lo + len(ids)), src=src,
                    mask=mask))
                slots += mask.size
                masked += int(mask.size - np.count_nonzero(mask))
            hops.append(blocks)
        level_pos = [np.searchsorted(levels[k + 1], levels[k])
                     for k in range(len(fanouts))]
    return RelationalBlocks(
        seeds=seeds, all_nodes=levels[-1],
        num_requests=int(len(seeds) + slots - masked), levels=levels,
        hops=hops, level_pos=level_pos, num_slots=slots, num_masked=masked)
