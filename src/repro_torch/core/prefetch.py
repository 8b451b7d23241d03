"""Overlapped prefetch execution engine (paper §3.2, Fig. 13), the port's
copy of `repro.core.prefetch`.

Sampling and gather for batch k+1 run while batch k trains, so storage
latency stops adding serially to the iteration time.  `PrefetchEngine`
drives the loader's `plan_next()` and `execute()` for up to `depth` future
batches ahead of the consumer, then prices each consumed batch's exposed
prep against the model-compute time the caller reports
(`StorageTimeline.price_batch_overlapped`: only the excess is exposed).

Determinism contract: the engine makes exactly the same plan and execute
calls in exactly the same order as a synchronous loader, earlier in wall
time and never reordered, with no threads.  So the `Batch` sequence
(blocks, rows, reports, raw prep times) equals the synchronous plane's bit
for bit; only `exposed_prep_s` differs.  Every staged `Batch` owns its
feature tensor: the fills of a later staged batch and the reuse of the
staging buffer never change an earlier batch's rows.

On a merged plane (`merge_execute`, e.g. `gids-merged-async`) the engine's
staging unit is the whole merged window: every batch of the window enters
the ready queue together, each with its own resume snapshot.  Topology
planes ride through unchanged: their priced sampling time is part of
`Batch.prep_time_s`, so the overlap hides it like gather time.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import TYPE_CHECKING

if TYPE_CHECKING:                       # pipeline imports this module
    from .pipeline import Batch, GIDSDataLoader


@dataclasses.dataclass
class PrefetchStats:
    """Engine telemetry: how much modelled prep time the overlap hid."""

    staged_batches: int = 0
    consumed_batches: int = 0
    prep_s_total: float = 0.0
    exposed_s_total: float = 0.0

    @property
    def hidden_s_total(self) -> float:
        return self.prep_s_total - self.exposed_s_total

    @property
    def hidden_fraction(self) -> float:
        if self.prep_s_total <= 0:
            return 0.0
        return self.hidden_s_total / self.prep_s_total


class PrefetchEngine:
    """Stage up to `depth` executed batches ahead of consumption.

    `next(compute_s)` returns the oldest staged batch with its
    `exposed_prep_s` re-priced against the `compute_s` seconds of model
    compute the caller overlapped it with, then tops the stage queue back
    up.  `depth` bounds staging memory: each staged batch holds its
    gathered feature rows.
    """

    def __init__(self, loader: "GIDSDataLoader", depth: int):
        self.loader = loader
        self.depth = max(1, int(depth))
        self._ready: deque[tuple[dict, "Batch"]] = deque()
        self.stats = PrefetchStats()

    def __len__(self) -> int:
        return len(self._ready)

    def _stage(self) -> None:
        while len(self._ready) < self.depth:
            if self.loader.plane.merge_execute:
                # a merged plane's unit is the whole window, staged at once:
                # the queue may exceed `depth` by window - 1 batches
                plans = self.loader.plan_window()
                batches = self.loader.execute_window(plans)
            else:
                plan = self.loader.plan_next()
                plans, batches = [plan], [self.loader.execute(plan)]
            for p, b in zip(plans, batches, strict=True):
                self._ready.append((p.snapshot, b))
                self.stats.staged_batches += 1

    def next(self, compute_s: float = 0.0) -> "Batch":
        self._stage()
        _, batch = self._ready.popleft()
        exposed = self.loader.plane.exposed_prep(
            self.loader.timeline, batch.prep_time_s, compute_s)
        batch = dataclasses.replace(batch, exposed_prep_s=exposed)
        self.stats.consumed_batches += 1
        self.stats.prep_s_total += batch.prep_time_s
        self.stats.exposed_s_total += exposed
        return batch

    def oldest_snapshot(self) -> dict | None:
        """Sampler snapshot of the oldest staged-but-unconsumed batch: the
        point a resumed loader restarts from."""
        if self._ready:
            return self._ready[0][0]
        return None

    def reset(self) -> None:
        self._ready.clear()
        self.stats = PrefetchStats()
