"""A cell's inputs, made from the configuration and `--seed`: the graph, the
feature table, the labels, the seed pool and the initial parameters.

Each family's `make_inputs` (`families/<name>.py`) draws them with the
helpers here.  The graph is the configuration's dataset and is drawn from
the configuration's own `graph.seed`, so every run of a configuration trains
on the same graph; `--seed` draws the features, labels, initial parameters
and (through the loader) the batches, each from a stream of its own
(`stream_seed`).  Everything is drawn on the device in a few large calls and
copied to the host where the loader reads it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: rows of the feature table drawn per call (512 MB at 1024 float32)
FEATURE_CHUNK_ROWS = 1 << 17


@dataclasses.dataclass
class Inputs:
    indptr: np.ndarray        # (N + 1,) int64
    indices: np.ndarray       # (E,) int32, each row sorted
    features: np.ndarray      # (N, D) float32, on the host
    labels: np.ndarray        # (N,) int64
    seed_pool: np.ndarray     # node ids a batch's seeds are drawn from
    params: dict              # initial parameters, reference layout
    #: what a family adds (typed id offsets, per-relation CSRs, ...)
    extras: dict = dataclasses.field(default_factory=dict)


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one of a run's input streams, from `--seed`.
    Streams in use: 1 the features, 2 the labels, 3 the initial parameters,
    4 the loader's batches, 5 the window's sample of checked steps."""
    return (seed % (1 << 59)) * 16 + stream


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def seed_pool(indptr: np.ndarray, pool: dict, split_seed: int
              ) -> np.ndarray:
    """Node ids a batch's seeds are drawn from, as a mix's `seed_pool`
    describes them: the nodes with at least `min_out_degree` out-edges, of
    which a fixed share `fraction` (a labelled split).  The split is drawn
    from the configuration's graph seed, so it belongs to the dataset and
    every run of the configuration trains on the same one."""
    unknown = set(pool) - {"min_out_degree", "fraction"}
    if unknown:
        raise ValueError(f"unknown seed_pool keys {sorted(unknown)}")
    ids = np.flatnonzero(np.diff(indptr) >= pool.get("min_out_degree", 0))
    fraction = pool.get("fraction", 1.0)
    if not 0 < fraction <= 1:
        raise ValueError(f"seed_pool fraction {fraction} is not in (0, 1]")
    if fraction < 1:
        keep = max(1, round(fraction * len(ids)))
        ids = np.sort(np.random.default_rng(split_seed).choice(
            ids, keep, replace=False))
    return ids


def feature_table(n: int, dim: int, seed: int, device: torch.device
                  ) -> np.ndarray:
    """The (n, dim) float32 feature table on the host, drawn on the device
    a chunk at a time.  On a card each chunk comes back through one pinned
    buffer and is spread into the table by a multi-threaded copy, which
    also takes the table's first-touch page faults on every thread: a
    pageable copy of the whole table takes them on one thread, and its
    time swings by over a second from run to run."""
    host = torch.empty((n, dim), dtype=torch.float32)
    gen = generator(device, stream_seed(seed, 1))
    staging = None
    if device.type == "cuda":
        staging = torch.empty((min(n, FEATURE_CHUNK_ROWS), dim),
                              dtype=torch.float32, pin_memory=True)
    for lo in range(0, n, FEATURE_CHUNK_ROWS):
        hi = min(n, lo + FEATURE_CHUNK_ROWS)
        chunk = torch.randn((hi - lo, dim), generator=gen, device=device)
        if staging is not None:
            staging[:hi - lo].copy_(chunk)
            chunk = staging[:hi - lo]
        host[lo:hi].copy_(chunk)
    return host.numpy()
