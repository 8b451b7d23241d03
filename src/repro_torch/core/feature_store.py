"""Tiered feature store, the port's subset of `repro.core.feature_store`:
an ordered tier stack folded into one `GatherPlan` per batch.

`gather()` returns the batch's feature rows as a tensor on the loader's
device, and a `GatherReport` whose per-tier counts feed the storage-
timeline pricing.  With a device tier on top (the host planes' window
cache or the device store), the rows are the device gather that tier made
during its probe.  Otherwise (`pinned-host`, `mmap`, a stack with the
constant buffer first) they are `features[node_ids]` staged through a
pinned buffer and copied to the device.  `gather_merged()` folds the stack
once over a merged window's unique set; its per-batch rows are the device
tier's expansions, or else the staged unique rows expanded per batch on
the device.  On a sharded namespace the reports carry the per-shard split
of the storage rows (and, on the host plane, the rows and lines that cross
a host link), and a merged window coalesces 4 KB lines shard-locally.

An enabled `tracer` (the loader hands it its own, and to every tier that
takes one) gets the gather as two wall spans: `gather` (the tier fold,
one `probe` span per tier, and the rows' delivery) and `report` (the
reports built from the plan).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs import HOT_PATH, NULL_TRACER
from .accumulator import MergedWindow
from .constant_buffer import ConstantBuffer
from .software_cache import WindowBufferedCache
from .storage_sim import (IO_BYTES, coalesce_lines,
                          coalesce_lines_by_shard)
from .tiers import (LATENCY_CLASSES, ConstantBufferTier, DeviceCacheTier,
                    GatherPlan, HostStager, StorageTier, Tier, build_plan,
                    build_plan_merged)


@dataclasses.dataclass(frozen=True)
class GatherReport:
    """Per-batch tier split.  `bytes_per_row` is the size of ONE feature row
    (dim * itemsize) — multiply by a count to get transfer bytes.  The
    `n_hbm_hits` / `n_host_hits` / `n_storage` views aggregate tiers by
    latency class so pricing and telemetry are stack-shape-agnostic.

    On a sharded storage namespace `shard_rows` carries the per-shard split
    of this report's storage-bound requests (`n_shards` entries summing to
    `n_storage`); empty on an unsharded plane.  Per-shard pricing and the
    straggler/imbalance telemetry key off it.

    On a multi-host plane (core/hosts.py) `remote_rows` additionally splits
    out, per SERVING shard, the storage rows requested by a different host
    — the traffic that rides each host's link in
    `StorageTimeline.price_host_burst`.  Empty everywhere else."""

    n_requests: int
    bytes_per_row: int
    tier_names: tuple[str, ...]
    tier_classes: tuple[str, ...]
    tier_counts: tuple[int, ...]
    n_shards: int = 1
    shard_rows: tuple[int, ...] = ()
    remote_rows: tuple[int, ...] = ()

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

    @property
    def shard_imbalance(self) -> float:
        """Max-over-mean of the per-shard storage row counts; 1.0 when
        balanced (or unsharded).  Row-count imbalance — the time-domain
        version (device-aware) lives on `ShardedBurstResult`."""
        if not self.shard_rows or sum(self.shard_rows) == 0:
            return 1.0
        return max(self.shard_rows) / (sum(self.shard_rows)
                                       / len(self.shard_rows))

    @classmethod
    def from_plan(cls, plan: GatherPlan, bytes_per_row: int) -> "GatherReport":
        ns = plan.n_shards
        shard_rows, remote_rows = (), ()
        if ns > 1:
            shard_rows = tuple(int(c) for c in plan.shard_counts())
            if plan.remote is not None:
                remote_rows = tuple(int(c) for c in plan.remote_counts())
        return cls(
            n_requests=len(plan.node_ids),
            bytes_per_row=bytes_per_row,
            tier_names=tuple(t.name for t in plan.tiers),
            tier_classes=tuple(t.latency_class for t in plan.tiers),
            tier_counts=tuple(int(c) for c in plan.counts()),
            n_shards=ns, shard_rows=shard_rows, remote_rows=remote_rows,
        )


@dataclasses.dataclass(frozen=True)
class CoalescedReport(GatherReport):
    """`GatherReport` for a gather executed inside a merged window.

    The base fields keep their per-scope meaning (`n_requests` /
    `tier_counts` cover whatever request set this report describes — one
    batch's requests for the per-batch reports the loader attaches to each
    `Batch`, the unique set for the window-level report that prices the
    burst).  The extra fields carry the window-wide merge telemetry, shared
    by every report of the same window:

    window_batches:   batches merged into this window
    window_requests:  total requests across the window (duplicates included)
    n_unique:         unique rows in the window (gathered exactly once)
    n_duplicate:      window_requests - n_unique — storage fetches the
                      per-batch path would have re-issued
    n_storage_unique: unique rows the fold assigned to the storage tier
    n_storage_lines:  4 KB IOs after coalescing storage rows that share a
                      line (< n_storage_unique when rows are narrower than
                      one line and neighbours were both requested).
                      Coalescing is SHARD-LOCAL on a sharded namespace —
                      rows sharing a logical line but living on different
                      shards are separate IOs
    shard_lines:      per-shard coalesced IO counts (sums to
                      n_storage_lines); empty on an unsharded plane.
                      Pairs with the inherited `shard_rows` to drive the
                      max-over-shards burst pricing
    remote_lines:     host planes only — per serving host, the coalesced
                      4 KB IOs requested by OTHER hosts: the second level
                      of the two-level merge (dedup per host first, then
                      line-granular link transit per host-local queue).
                      Feeds `price_host_burst`'s link term
    """

    window_batches: int = 1
    window_requests: int = 0
    n_unique: int = 0
    n_duplicate: int = 0
    n_storage_unique: int = 0
    n_storage_lines: int = 0
    shard_lines: tuple[int, ...] = ()
    remote_lines: tuple[int, ...] = ()

    @property
    def dedup_factor(self) -> float:
        return self.window_requests / max(self.n_unique, 1)

    @property
    def coalesce_factor(self) -> float:
        return self.n_storage_unique / max(self.n_storage_lines, 1)


class TieredFeatureStore:
    """An ordered tier stack folded into one gather plan per batch.  The
    last tier must be a storage backstop exposing `.features`; rows are
    delivered on `device`."""

    def __init__(self, tiers: Sequence[Tier],
                 device: str | torch.device = "cuda"):
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
        self.device = resolve_device(device)
        self._stager = HostStager(
            torch.from_numpy(np.ascontiguousarray(self.features)),
            self.device)
        self.last_plan: GatherPlan | None = None
        self.tracer = NULL_TRACER

    def use_tracer(self, tracer) -> None:
        """Hand `tracer` to the store and to every tier that takes one."""
        self.tracer = tracer
        for t in self.tiers:
            if hasattr(t, "tracer"):
                t.tracer = tracer

    @property
    def cache(self) -> WindowBufferedCache | None:
        """The numpy window cache of the first tier that has one."""
        for t in self.tiers:
            c = getattr(t, "cache", None)
            if isinstance(c, WindowBufferedCache):
                return c
        return None

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
        return build_plan(self.tiers, node_ids, tracer=self.tracer)

    def host_rows(self, node_ids: np.ndarray) -> torch.Tensor:
        """features[node_ids] staged on the host and copied to the device."""
        return self._stager.to_device(self._stager.stage(node_ids))

    def gather(self, node_ids: np.ndarray
               ) -> tuple[torch.Tensor, GatherReport]:
        """Fetch feature rows for (deduplicated) node_ids through the tiers.
        A device tier on top already gathered them on the device during its
        probe; otherwise they come from the backstop through the host."""
        with self.tracer.stage("gather", cat=HOT_PATH, rows=len(node_ids)):
            plan = self.plan(node_ids)
            rows = getattr(plan.tiers[0], "last_rows", None)
            if rows is None or len(rows) != len(node_ids):
                rows = self.host_rows(node_ids)
        with self.tracer.stage("report", cat=HOT_PATH):
            report = GatherReport.from_plan(
                plan, bytes_per_row=self.feature_dim * self.itemsize)
        self.last_plan = plan
        return rows, report

    def gather_merged(self, merged: MergedWindow, io_bytes: int = IO_BYTES
                      ) -> tuple[list, list[CoalescedReport],
                                 CoalescedReport]:
        """Gather a whole merged window through ONE tier fold over its
        unique request set.  Each unique row is staged once: a device tier
        on top expands its rows to every batch on the device; otherwise the
        unique rows are copied to the device and expanded there per batch.
        Storage-bound unique rows sharing a 4 KB line coalesce into single
        IOs, shard-locally on a sharded namespace.

        Returns `(rows_list, reports, window_report)`: per-batch device
        tensors of rows, per-batch `CoalescedReport`s (batch-local tier
        split + window telemetry), and the window-level report over the
        unique set that `StorageTimeline.price_merged_burst` prices."""
        unique = merged.unique_nodes
        with self.tracer.stage("gather", cat=HOT_PATH, rows=len(unique)):
            inverses = [merged.batch_inverse(i)
                        for i in range(merged.n_batches)]
            plan = build_plan_merged(self.tiers, unique,
                                     merged.batch_multiplicity(), inverses,
                                     tracer=self.tracer)
            rows_list = getattr(self.tiers[0], "last_window_rows", None)
            if rows_list is None:
                rows_u = self.host_rows(unique)
                rows_list = [rows_u.index_select(0, torch.from_numpy(
                    np.asarray(inv, np.int64)).to(self.device))
                    for inv in inverses]
        with self.tracer.stage("report", cat=HOT_PATH):
            return rows_list, *self._merged_reports(merged, plan, inverses,
                                                    io_bytes)

    def _merged_reports(self, merged: MergedWindow, plan: GatherPlan,
                        inverses: list[np.ndarray], io_bytes: int
                        ) -> tuple[list[CoalescedReport], CoalescedReport]:
        """The per-batch and window-level reports of a merged window's
        plan; sets `last_plan`."""
        unique = merged.unique_nodes
        bytes_per_row = self.feature_dim * self.itemsize
        storage_mask = plan.storage_mask()
        n_storage_unique = int(storage_mask.sum())
        n_shards = plan.n_shards
        # shard-local coalescing: the line key is (shard, line) — rows on
        # the same logical 4 KB line but different devices are separate IOs
        shard = plan.shard if plan.shard is not None \
            else np.where(storage_mask, 0, -1).astype(np.int16)
        shard_rows, shard_lines = (), ()
        remote_rows, remote_lines = (), ()
        if n_shards > 1:
            shard_rows = tuple(int(c) for c in np.bincount(
                shard[storage_mask], minlength=n_shards))
            per_shard = coalesce_lines_by_shard(
                unique[storage_mask], shard[storage_mask], n_shards,
                bytes_per_row, io_bytes)
            shard_lines = tuple(int(c) for c in per_shard)
            n_storage_lines = int(per_shard.sum())
            if plan.remote is not None and plan.remote.any():
                # two-level merge, level 2: of each host's deduplicated
                # line set, the lines requested by OTHER hosts transit its
                # link (level 1, the (shard, line) dedup above, already
                # collapsed duplicate remote rows into one line)
                rm = storage_mask & plan.remote
                remote_rows = tuple(int(c) for c in np.bincount(
                    shard[rm], minlength=n_shards))
                remote_lines = tuple(int(c) for c in coalesce_lines_by_shard(
                    unique[rm], shard[rm], n_shards, bytes_per_row,
                    io_bytes))
        else:
            n_storage_lines = coalesce_lines(unique[storage_mask],
                                             bytes_per_row, io_bytes)
        window_stats = dict(
            window_batches=merged.n_batches,
            window_requests=merged.n_requests,
            n_unique=merged.n_unique,
            n_duplicate=merged.n_duplicate,
            n_storage_unique=n_storage_unique,
            n_storage_lines=n_storage_lines,
            shard_lines=shard_lines,
            remote_lines=remote_lines,
        )
        tier_meta = dict(
            bytes_per_row=bytes_per_row,
            tier_names=tuple(t.name for t in plan.tiers),
            tier_classes=tuple(t.latency_class for t in plan.tiers),
            n_shards=n_shards,
        )
        window_report = CoalescedReport(
            n_requests=merged.n_unique,
            tier_counts=tuple(int(c) for c in plan.counts()),
            shard_rows=shard_rows, remote_rows=remote_rows,
            **tier_meta, **window_stats)
        reports = []
        for inv in inverses:
            counts = np.bincount(plan.assignment[inv],
                                 minlength=len(plan.tiers))
            batch_shard_rows, batch_remote_rows = (), ()
            if n_shards > 1:
                bsm = shard[inv] >= 0
                batch_shard_rows = tuple(int(c) for c in np.bincount(
                    shard[inv][bsm], minlength=n_shards))
                if plan.remote is not None:
                    brm = bsm & plan.remote[inv]
                    batch_remote_rows = tuple(int(c) for c in np.bincount(
                        shard[inv][brm], minlength=n_shards))
            reports.append(CoalescedReport(
                n_requests=len(inv),
                tier_counts=tuple(int(c) for c in counts),
                shard_rows=batch_shard_rows, remote_rows=batch_remote_rows,
                **tier_meta, **window_stats))
        self.last_plan = plan
        return reports, window_report

    def push_window(self, future_nodes: np.ndarray) -> None:
        """Announce a future batch to every tier (window pinning etc.)."""
        for t in self.tiers:
            t.admit(future_nodes)

    def retire_window(self, n_batches: int) -> None:
        """Drop the windowed tier's look-ahead entries for `n_batches`
        consumed batches.  The merged executor calls this (then re-syncs
        the window) BEFORE `gather_merged`, so the one merged access pins
        its fills by the NEXT window's reuse."""
        wt = self.windowed_tier
        if wt is None or wt.window_depth == 0:
            return
        for _ in range(min(n_batches, len(wt.window))):
            wt.window.popleft()

    def reset(self) -> None:
        self._stager.reset()
        for t in self.tiers:
            t.reset()

    # -- checkpoint ------------------------------------------------------------
    def state_dict(self) -> dict:
        """Durable per-tier state, keyed by tier name.  Only tiers exposing
        `state_dict` contribute (the sharded backstop's placement
        assignment); cache contents are deliberately not checkpointed, they
        rebuild deterministically on resume."""
        return {t.name: t.state_dict() for t in self.tiers
                if hasattr(t, "state_dict")}

    def load_state_dict(self, state: dict) -> None:
        by_name = {t.name: t for t in self.tiers}
        for name, tier_state in state.items():
            tier = by_name.get(name)
            if tier is None or not hasattr(tier, "load_state_dict"):
                raise ValueError(
                    f"checkpoint carries state for tier {name!r} but the "
                    f"stack has no such stateful tier "
                    f"({sorted(by_name)}) — plane/checkpoint mismatch")
            tier.load_state_dict(tier_state)

    def device_rows(self, tier_index: int = 0) -> torch.Tensor:
        """The resident row store of a device tier, as `tiered_gather`
        consumes it with `GatherPlan.kernel_slots(tier_index)`."""
        return self.tiers[tier_index].device_rows()


class FeatureStore(TieredFeatureStore):
    """Classic keyword construction of the cache/cbuf/storage stack, the
    reference's compatibility wrapper over `TieredFeatureStore`; new code
    builds a stack through `DataPlaneSpec`.  The cache, where given, keeps
    its row store on `device`, where the rows are delivered."""

    def __init__(self, features: np.ndarray,
                 cache: WindowBufferedCache | None = None,
                 constant_buffer: ConstantBuffer | None = None,
                 device: str | torch.device = "cuda"):
        tiers: list[Tier] = []
        if cache is not None:
            tiers.append(DeviceCacheTier(cache, features, device=device))
        if constant_buffer is not None:
            tiers.append(ConstantBufferTier(
                constant_buffer,
                row_bytes=features.shape[1] * features.dtype.itemsize))
        tiers.append(StorageTier(features))
        super().__init__(tiers, device=device)

    @classmethod
    def memmap(cls, path: str, num_nodes: int, dim: int,
               dtype=np.float32, create: bool = False, seed: int = 0,
               **kw) -> "FeatureStore":
        """Features in a file read through memmap, the storage namespace;
        with `create`, the file is written first from default_rng(seed) in
        64 slabs, as the reference writes it."""
        mode = "w+" if create else "r+"
        arr = np.memmap(path, dtype=dtype, mode=mode, shape=(num_nodes, dim))
        if create:
            rng = np.random.default_rng(seed)
            step = max(1, num_nodes // 64)
            for i in range(0, num_nodes, step):
                j = min(num_nodes, i + step)
                arr[i:j] = rng.standard_normal((j - i, dim), dtype=np.float32)
            arr.flush()
        return cls(arr, **kw)

    @classmethod
    def synthetic(cls, num_nodes: int, dim: int, dtype=np.float32,
                  seed: int = 0, **kw) -> "FeatureStore":
        """Features drawn in memory from default_rng(seed), as the
        reference draws them."""
        rng = np.random.default_rng(seed)
        feats = rng.standard_normal((num_nodes, dim)).astype(dtype)
        return cls(feats, **kw)
