"""Tiered feature store, the port's subset of `repro.core.feature_store`:
an ordered tier stack folded into one `GatherPlan` per batch.

`gather()` returns the batch's feature rows and a `GatherReport` whose
per-tier counts feed the storage-timeline pricing.  With a device-store
tier on top, the rows are that tier's device tensor and never pass through
the host.  Merged-window gathers and sharded reports wait for their slices
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .constant_buffer import ConstantBuffer
from .tiers import (LATENCY_CLASSES, ConstantBufferTier, GatherPlan, Tier,
                    build_plan)


@dataclasses.dataclass(frozen=True)
class GatherReport:
    """Per-batch tier split.  `bytes_per_row` is the size of ONE feature row
    (dim * itemsize).  The `n_hbm_hits` / `n_host_hits` / `n_storage` views
    aggregate tiers by latency class."""

    n_requests: int
    bytes_per_row: int
    tier_names: tuple[str, ...]
    tier_classes: tuple[str, ...]
    tier_counts: tuple[int, ...]

    def _class_count(self, latency_class: str) -> int:
        return sum(n for c, n in zip(self.tier_classes, self.tier_counts)
                   if c == latency_class)

    @property
    def n_hbm_hits(self) -> int:
        return self._class_count("hbm")

    @property
    def n_host_hits(self) -> int:
        return self._class_count("host")

    @property
    def n_storage(self) -> int:
        return self._class_count("storage")

    @property
    def redirected(self) -> int:
        return self.n_requests - self.n_storage

    @classmethod
    def from_plan(cls, plan: GatherPlan, bytes_per_row: int) -> "GatherReport":
        return cls(
            n_requests=len(plan.node_ids),
            bytes_per_row=bytes_per_row,
            tier_names=tuple(t.name for t in plan.tiers),
            tier_classes=tuple(t.latency_class for t in plan.tiers),
            tier_counts=tuple(int(c) for c in plan.counts()),
        )


class TieredFeatureStore:
    """An ordered tier stack folded into one gather plan per batch.  The
    last tier must be a storage backstop exposing `.features`."""

    def __init__(self, tiers: Sequence[Tier]):
        tiers = tuple(tiers)
        if not tiers:
            raise ValueError("empty tier stack")
        for t in tiers:
            if t.latency_class not in LATENCY_CLASSES:
                raise ValueError(
                    f"tier {t.name!r} has unknown latency_class "
                    f"{t.latency_class!r}; pricing/telemetry aggregate by "
                    f"class and only know {LATENCY_CLASSES}")
        backstop = tiers[-1]
        if backstop.latency_class != "storage" \
                or not hasattr(backstop, "features"):
            raise ValueError(
                f"last tier {backstop.name!r} "
                f"({backstop.latency_class}) is not a storage backstop")
        for i, t in enumerate(tiers):
            # window semantics need the tier to see EVERY batch: a faster
            # tier claiming requests first would starve its reuse-counter
            # decrements (lines pinned forever)
            if getattr(t, "window_depth", 0) > 0 and i != 0:
                raise ValueError(
                    f"windowed tier {t.name!r} must be first in the stack "
                    f"(got position {i}): tiers above it would starve its "
                    "reuse-counter decrements")
        self.tiers = tiers
        self.features = backstop.features
        self.feature_dim = self.features.shape[1]
        self.itemsize = self.features.dtype.itemsize
        self.last_plan: GatherPlan | None = None

    @property
    def cbuf(self) -> ConstantBuffer | None:
        for t in self.tiers:
            if isinstance(t, ConstantBufferTier):
                return t.cbuf
        return None

    @property
    def windowed_tier(self) -> Tier | None:
        """First tier with a look-ahead window (drives lookahead sync)."""
        for t in self.tiers:
            if hasattr(t, "window_depth") and hasattr(t, "window"):
                return t
        return None

    def plan(self, node_ids: np.ndarray) -> GatherPlan:
        return build_plan(self.tiers, node_ids)

    def gather(self, node_ids: np.ndarray
               ) -> tuple[torch.Tensor | np.ndarray, GatherReport]:
        """Fetch feature rows for (deduplicated) node_ids through the tiers.
        A device-store tier on top already gathered them on the device
        during its probe; otherwise they come from the backstop."""
        plan = self.plan(node_ids)
        rows = getattr(plan.tiers[0], "last_rows", None)
        if rows is None or len(rows) != len(node_ids):
            rows = np.asarray(self.features[node_ids])
        report = GatherReport.from_plan(
            plan, bytes_per_row=self.feature_dim * self.itemsize)
        self.last_plan = plan
        return rows, report

    def push_window(self, future_nodes: np.ndarray) -> None:
        """Announce a future batch to every tier (window pinning etc.)."""
        for t in self.tiers:
            t.admit(future_nodes)

    def reset(self) -> None:
        for t in self.tiers:
            t.reset()
