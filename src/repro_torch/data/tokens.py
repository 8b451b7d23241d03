"""LM token pipeline fed by the GIDS prefetch machinery, the port of
`repro.data.tokens`.

The paper's dataloader problem (keep the accelerator fed from storage that
is slower than its compute) recurs in LM pretraining, and the same pieces
apply:

  * storage tier: token shards live in memmapped files (the SSD namespace);
  * accumulator: Little's-law dispatch-ahead depth sets how many batch
    fetches are in flight (`DynamicAccessAccumulator`);
  * prefetch queue: sequences for future steps are staged ahead of the
    train loop, as sampled sub-graphs are.

Tokens, labels, the cursor, the rng and the queue depth are host numpy,
bit-identical to the reference's.  For a vlm the per-example patch rows
come through the tiered `FeatureStore` (an embedding table indexed by
example id is a node-feature table), which delivers them on its device:
the unique ids are gathered once and expanded per example with one index
on the device, the rows the reference's expansion gives.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.accumulator import (AccumulatorConfig,
                                          DynamicAccessAccumulator)
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.storage_sim import INTEL_OPTANE, SSDSpec


@dataclasses.dataclass
class TokenPipelineConfig:
    batch_size: int = 8
    seq_len: int = 1024
    vocab_size: int = 32000
    prefetch_depth: int = 4
    seed: int = 0
    # modality sidecar (vlm/audio): rows fetched per example from the store
    modality_dim: int = 0
    modality_tokens: int = 0


class TokenPipeline:
    """Iterates {"tokens", "labels"} batches (B, S) int32 numpy from a
    memmap shard, plus "patches" (B, modality_tokens, D) on the modality
    store's device when one is given."""

    def __init__(self, shard_path: str | Path | None,
                 cfg: TokenPipelineConfig,
                 ssd: SSDSpec = INTEL_OPTANE,
                 modality_store: FeatureStore | None = None,
                 num_tokens: int = 1 << 22):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        if shard_path is None:                        # synthetic shard
            self.tokens = self.rng.integers(
                0, cfg.vocab_size, num_tokens).astype(np.int32)
        else:
            self.tokens = np.memmap(shard_path, dtype=np.int32, mode="r")
        self.modality_store = modality_store
        self.accumulator = DynamicAccessAccumulator(
            ssd, AccumulatorConfig(max_merge_iters=cfg.prefetch_depth))
        self._queue: deque = deque()
        self._cursor = 0

    def _snapshot(self) -> dict:
        return {"cursor": self._cursor,
                "rng": self.rng.bit_generator.state}

    def _fetch_one(self) -> dict:
        cfg = self.cfg
        n = cfg.batch_size * (cfg.seq_len + 1)
        if self._cursor + n > len(self.tokens):
            self._cursor = 0
        window = np.asarray(self.tokens[self._cursor:self._cursor + n])
        self._cursor += n
        window = window.reshape(cfg.batch_size, cfg.seq_len + 1)
        batch = {"tokens": window[:, :-1].copy(),
                 "labels": window[:, 1:].copy()}
        if self.modality_store is not None and cfg.modality_tokens:
            ids = self.rng.integers(0, self.modality_store.features.shape[0],
                                    cfg.batch_size * cfg.modality_tokens)
            uniq, inverse = np.unique(ids, return_inverse=True)
            rows, report = self.modality_store.gather(uniq)
            # re-expand to the per-example layout
            take = torch.from_numpy(inverse.astype(np.int64)).to(rows.device)
            batch["patches"] = rows[take].reshape(
                cfg.batch_size, cfg.modality_tokens, -1)
            self.accumulator.update(report.n_requests, report.redirected)
        return batch

    def _refill(self) -> None:
        bytes_per = self.cfg.batch_size * self.cfg.seq_len * 4
        depth = max(self.cfg.prefetch_depth,
                    self.accumulator.merge_depth(max(bytes_per // 4096, 1)))
        depth = min(depth, 4 * self.cfg.prefetch_depth)
        while len(self._queue) < depth:
            # snapshot BEFORE fetching: a checkpoint records the logical
            # consumption position, not the prefetch frontier, or a restart
            # would skip every batch that was in flight
            self._queue.append((self._snapshot(), self._fetch_one()))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        self._refill()
        return self._queue.popleft()[1]

    # checkpointable logical position (fault tolerance)
    def state_dict(self) -> dict:
        return self._queue[0][0] if self._queue else self._snapshot()

    def load_state_dict(self, st: dict) -> None:
        self._cursor = st["cursor"]
        self.rng.bit_generator.state = st["rng"]
        self._queue.clear()
