"""Plain checks of what the timed path produced: the sampled blocks against
the graph, the gathered feature rows against the feature table, and a
training step's numbers against the plain step in `gnn`.

Everything here reads the benchmark's own inputs (the CSR it generated,
the feature table, the labels, the initial parameters) and the program's
outputs, and nothing the program derived from them.
"""
from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np
import torch


class Graph:
    """The reference's reading of a CSR: every edge as one sorted int64 key
    `src * N + dst`, and each node's out-degree."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray):
        self.n = len(indptr) - 1
        self.degree = np.diff(indptr)
        src = np.repeat(np.arange(self.n, dtype=np.int64), self.degree)
        keys = src * self.n + indices.astype(np.int64)
        if np.any(keys[1:] <= keys[:-1]):
            keys = np.unique(keys)
        self.keys = keys

    def has_edges(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        q = src.astype(np.int64) * self.n + dst.astype(np.int64)
        pos = np.minimum(np.searchsorted(self.keys, q), len(self.keys) - 1)
        return self.keys[pos] == q


def bad_sample_ids(graph: Graph, pool: np.ndarray, seeds: np.ndarray,
                   hop_nodes: Sequence[np.ndarray], all_nodes: np.ndarray,
                   fanouts: Sequence[int], batch: int) -> int:
    """Ids of one sampled batch that break what the sampler guarantees:
    `batch` distinct seeds from `pool` (sorted); each hop `fanouts[l]`
    ids per frontier row, each an out-neighbour of that row (the row itself
    where it has none); `all_nodes` the sorted union of them all."""
    bad = 0
    seeds = np.asarray(seeds, np.int64)
    if seeds.shape != (batch,):
        return batch
    bad += batch - len(np.unique(seeds))
    in_range = (seeds >= 0) & (seeds < graph.n)
    bad += int((~in_range).sum())
    pos = np.minimum(np.searchsorted(pool, seeds), len(pool) - 1)
    bad += int((pool[pos] != seeds).sum())
    frontier = seeds[in_range]
    for hop, f in enumerate(fanouts):
        got = np.asarray(hop_nodes[hop], np.int64)
        if got.shape != (len(frontier) * f,):
            return bad + len(frontier) * f
        src = np.repeat(frontier, f)
        ok_range = (got >= 0) & (got < graph.n)
        bad += int((~ok_range).sum())
        isolated = graph.degree[src] == 0
        ok = np.where(isolated, got == src,
                      graph.has_edges(src, np.where(ok_range, got, 0)))
        bad += int((ok_range & ~ok).sum())
        frontier = got
    want = np.unique(np.concatenate(
        [seeds, *[np.asarray(h, np.int64) for h in hop_nodes]]))
    got_all = np.asarray(all_nodes, np.int64)
    if got_all.shape != want.shape:
        bad += abs(len(got_all) - len(want)) + 1
    else:
        bad += int((got_all != want).sum())
    return bad


def row_checksums(table: np.ndarray, ids: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per row and per column, the int64 sum of the float32 words' bits of
    `table[ids]`: any changed word changes a row's and a column's sum."""
    bits = table[np.asarray(ids, np.int64)].view(np.int32)
    return bits.sum(axis=1, dtype=np.int64), bits.sum(axis=0, dtype=np.int64)


def bad_rows(table: np.ndarray, ids: np.ndarray, row_sums: np.ndarray,
             col_sums: np.ndarray) -> int:
    """Rows of a gathered batch whose checksum differs from the table's,
    plus one if the column sums differ (words moved within rows)."""
    want_rows, want_cols = row_checksums(table, ids)
    if row_sums.shape != want_rows.shape:
        return len(want_rows) + 1
    return (int((row_sums != want_rows).sum())
            + int(np.any(col_sums != want_cols)))


def leaf_norms(tree: dict) -> dict:
    return {(g, k): float(torch.linalg.vector_norm(v.double()))
            for g, group in tree.items() for k, v in group.items()}


def leaf_gaps(got: dict, want: dict, counted: Sequence) -> dict:
    """Per counted leaf, the gap between two norms, |got - want|, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want[k] for k in counted)
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in counted}


def counted_leaves(grad_norms: dict) -> list:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the rest move by round-off alone."""
    med = statistics.median(grad_norms.values())
    return sorted(k for k, v in grad_norms.items() if v > 1e-3 * med)


def difference(a: dict, b: dict) -> dict:
    return {g: {k: a[g][k].double() - b[g][k].double() for k in a[g]}
            for g in a}


def sgd_gradient(before: dict, after: dict, lr: float) -> dict:
    """The gradient an SGD step applied, (before - after) / lr."""
    return {g: {k: v / lr for k, v in grp.items()}
            for g, grp in difference(before, after).items()}
