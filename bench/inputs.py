"""A cell's inputs, made from the configuration and `--seed`: the graph, the
feature table, the labels, the seed pool and the initial parameters.

The graph is the configuration's dataset and is drawn from the
configuration's own `graph.seed`, so every run of a configuration trains on
the same graph; `--seed` draws the features, labels, initial parameters and
(through the loader) the batches.  Everything is drawn on the device in a
few large calls and copied to the host where the loader reads it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rmat
from .reference import gnn as ref_gnn

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


def heads(config: dict) -> int:
    """Attention heads of a configuration's model (1 where it has none)."""
    return config.get("num_heads", 1)


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one of a run's input streams, from `--seed`."""
    return (seed % (1 << 59)) * 16 + stream


def _generator(device: torch.device, seed: int) -> torch.Generator:
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


def _features(n: int, dim: int, seed: int, device: torch.device
              ) -> np.ndarray:
    """The (n, dim) float32 feature table on the host, drawn on the device
    a chunk at a time.  On a card each chunk comes back through one pinned
    buffer and is spread into the table by a multi-threaded copy, which
    also takes the table's first-touch page faults on every thread: a
    pageable copy of the whole table takes them on one thread, and its
    time swings by over a second from run to run."""
    host = torch.empty((n, dim), dtype=torch.float32)
    gen = _generator(device, stream_seed(seed, 1))
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


def make(config: dict, traffic: dict, seed: int,
         device: torch.device) -> Inputs:
    g = config["graph"]
    n, dim = config["nodes"], config["in_dim"]
    indptr, indices = rmat.rmat_csr(
        n, config["edges"], a=g["a"], b=g["b"], c=g["c"],
        generator=_generator(device, g["seed"]), device=device)
    features = _features(n, dim, seed, device)
    labels = torch.randint(0, config["num_classes"], (n,),
                           generator=_generator(device, stream_seed(seed, 2)),
                           device=device).cpu().numpy()
    pool = seed_pool(indptr, traffic["seed_pool"], g["seed"])
    shapes = ref_gnn.param_shapes(
        config["model"], dim, config["hidden_dim"], config["num_classes"],
        len(config["fanouts"]), heads(config))
    params = ref_gnn.init_params(shapes,
                                 _generator(device, stream_seed(seed, 3)),
                                 device)
    return Inputs(indptr, indices, features, labels, pool, params)
