"""Pluggable data-plane tiers, the port's subset of `repro.core.tiers`: the
`Tier` protocol, the device-store, constant-buffer and storage tiers, and
the gather plan that folds a tier stack over one batch.

  DeviceStoreTier    — device cache metadata + device row store + the
                       `tiered_gather` kernel, via `device_store`; a merged
                       window goes through `tiered_gather_unique`
  ConstantBufferTier — `ConstantBuffer` (pinned host memory)
  StorageTier        — the storage backstop (always hits)
  KVSlotTier         — the serve engine's KV-cache slot pool

The numpy-cache, tenant and sharded tiers wait for their slices
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from . import cache_device, device_store
from .constant_buffer import ConstantBuffer

#: Valid latency classes, fastest first.  Pricing keys off the class.
LATENCY_CLASSES = ("hbm", "host", "storage")


@runtime_checkable
class Tier(Protocol):
    """One placement in the data plane.

    `probe(node_ids)` returns a boolean hit mask over the requests that
    reached this tier, and may mutate tier state (a cache fills on miss).
    `admit(node_ids)` announces a future batch's nodes (window buffering);
    tiers without look-ahead ignore it.
    """

    name: str
    latency_class: str

    @property
    def capacity_bytes(self) -> int | None: ...      # None = unbounded

    def probe(self, node_ids: np.ndarray) -> np.ndarray: ...

    def admit(self, node_ids: np.ndarray) -> None: ...

    def reset(self) -> None: ...


class _TierBase:
    """Default no-op admit/reset so simple tiers stay two methods."""

    name = "tier"
    latency_class = "storage"

    @property
    def capacity_bytes(self) -> int | None:
        return None

    def admit(self, node_ids: np.ndarray) -> None:
        del node_ids

    def reset(self) -> None:
        pass


class DeviceStoreTier(_TierBase):
    """Device tier: cache metadata, row store and gather on the loader's
    device, via `device_store.device_gather`.

    Each probe stages the requested host rows (through a pinned buffer and
    a non-blocking copy on CUDA) and gathers every requested row on the
    device; `last_rows` holds them as a device tensor, the real data path
    of this tier.  No shape bucket is needed: requests are not padded.
    A merged-window probe (`probe_merged`) stages the window's unique rows
    once and leaves one device tensor per batch in `last_window_rows`.
    On CUDA, `last_split_ms` holds the last probe's time per stage: host
    staging on the host clock, the rest between CUDA events.
    """

    latency_class = "hbm"

    def __init__(self, features: np.ndarray, num_lines: int, ways: int = 8,
                 window_depth: int = 0, name: str = "device-store",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._host_features = torch.from_numpy(np.ascontiguousarray(features))
        self._init_args = (num_lines, features.shape[1], ways,
                           self._host_features.dtype, self.device)
        self.store = device_store.init_store(*self._init_args)
        self.window_depth = window_depth
        self.window: deque[np.ndarray] = deque()
        self.name = name
        self.last_rows: torch.Tensor | None = None
        self.last_window_rows: list[torch.Tensor] | None = None
        self.last_split_ms: dict[str, float] = {}
        self._pinned: torch.Tensor | None = None
        self._staged_copy: torch.cuda.Event | None = None

    @property
    def capacity_bytes(self) -> int:
        rows = self.store.rows
        return rows.numel() * rows.element_size()

    def _future_counts(self, ids: np.ndarray) -> np.ndarray:
        """Per-id count of future window batches containing it: each window
        entry contributes its unique ids once, the sorted concatenation is
        binary-searched from both sides, and the span width is the count."""
        if not self.window:
            return np.zeros(len(ids), np.int32)
        cat = np.sort(np.concatenate(
            [np.unique(np.asarray(w)) for w in self.window]))
        lo = np.searchsorted(cat, ids, side="left")
        hi = np.searchsorted(cat, ids, side="right")
        return (hi - lo).astype(np.int32)

    def _stage_host(self, node_ids: np.ndarray) -> torch.Tensor:
        """features[node_ids] on the host.  On CUDA the rows land in a
        pinned buffer, reused once the previous copy out of it completed."""
        idx = torch.from_numpy(np.asarray(node_ids, np.int64))
        if self.device.type == "cpu":
            return self._host_features.index_select(0, idx)
        n = len(idx)
        if self._pinned is None or self._pinned.shape[0] < n:
            self._pinned = torch.empty(
                (n, self._host_features.shape[1]),
                dtype=self._host_features.dtype, pin_memory=True)
        elif self._staged_copy is not None:
            self._staged_copy.synchronize()
        buf = self._pinned[:n]
        torch.index_select(self._host_features, 0, idx, out=buf)
        return buf

    def probe(self, node_ids: np.ndarray) -> np.ndarray:
        if self.window_depth > 0 and self.window:
            self.window.popleft()
        return self._probe_rows(node_ids)

    def probe_merged(self, node_ids: np.ndarray, multiplicity: np.ndarray,
                     inverses: list[np.ndarray]) -> np.ndarray:
        """Merged-window probe: one deduplicated device access for the whole
        window (the caller has already retired the consumed look-ahead
        entries).  As in the reference, the metadata takes one reservation
        per hit, not the full multiplicity.  `inverses` holds one index
        array per batch into `node_ids`; each batch's rows land in
        `last_window_rows`."""
        del multiplicity
        return self._probe_rows(node_ids, inverses)

    def _probe_rows(self, node_ids: np.ndarray,
                    inverses: list[np.ndarray] | None = None) -> np.ndarray:
        ids = np.asarray(node_ids).astype(np.int32)
        fc = self._future_counts(node_ids)
        events: dict[str, torch.cuda.Event] = {}

        def mark(stage: str) -> None:
            if self.device.type == "cuda":
                events[stage] = torch.cuda.Event(enable_timing=True)
                events[stage].record()

        t0 = time.perf_counter()
        host_rows = self._stage_host(node_ids)
        t_stage = time.perf_counter() - t0
        mark("start")
        staged = host_rows.to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self._staged_copy = torch.cuda.Event()
            self._staged_copy.record()
        ids_d = torch.from_numpy(ids).to(self.device, non_blocking=True)
        fc_d = torch.from_numpy(fc).to(self.device, non_blocking=True)
        if inverses is None:
            mark("h2d")
            _, rows, hits = device_store.device_gather(
                self.store, ids_d, staged, fc_d, mark=mark)
            self.last_rows, self.last_window_rows = rows, None
        else:
            # one int64 upload for the window, cast to int32 on the device
            inv_d = torch.from_numpy(np.concatenate(inverses)).to(
                self.device, non_blocking=True).to(torch.int32)
            mark("h2d")
            _, rows_list, hits = device_store.device_gather_merged(
                self.store, ids_d, staged, fc_d,
                torch.split(inv_d, [len(i) for i in inverses]), mark=mark)
            self.last_rows, self.last_window_rows = None, rows_list
        hit_mask = hits.cpu().numpy()      # waits for the whole probe
        if events:
            order = ["start", "h2d", "cache_access", "gather", "fill"]
            self.last_split_ms = {"stage_host": t_stage * 1e3} | {
                b: events[a].elapsed_time(events[b])
                for a, b in zip(order, order[1:])}
        return hit_mask

    def admit(self, node_ids: np.ndarray) -> None:
        if self.window_depth == 0:
            return
        self.window.append(np.asarray(node_ids))
        nodes = torch.from_numpy(np.asarray(node_ids, np.int32))
        device_store.push_window(self.store.cache, nodes.to(self.device))

    def lookup_slots(self, node_ids: np.ndarray) -> np.ndarray:
        """Resident row per node from the cache metadata, -1 if absent
        (read-only)."""
        tags = self.store.cache.tags.cpu()
        slots = self.store.cache.slots.cpu().numpy()
        ids = np.asarray(node_ids)
        sets = cache_device._set_of(torch.from_numpy(ids),
                                    tags.shape[0]).numpy()
        match = tags.numpy()[sets] == ids[:, None]
        way = match.argmax(axis=1)                # first matching way
        return np.where(match.any(axis=1),
                        slots[sets, way], -1).astype(np.int32)

    def reset(self) -> None:
        self.store = device_store.init_store(*self._init_args)
        self.window.clear()
        self.last_rows = self.last_window_rows = None


class ConstantBufferTier(_TierBase):
    """Pinned-host tier backed by the constant CPU buffer (§3.3)."""

    latency_class = "host"

    def __init__(self, cbuf: ConstantBuffer, row_bytes: int | None = None,
                 name: str = "host-cbuf"):
        self.cbuf = cbuf
        self.row_bytes = row_bytes
        self.name = name

    @property
    def capacity_bytes(self) -> int | None:
        if self.cbuf.rows is not None:
            return int(self.cbuf.rows.nbytes)
        if self.row_bytes is not None:
            return self.cbuf.size * self.row_bytes
        return None

    def probe(self, node_ids: np.ndarray) -> np.ndarray:
        return self.cbuf.redirect_mask(node_ids)


class StorageTier(_TierBase):
    """The storage namespace backstop (memmap file or in-memory array).
    Always hits: a tier stack is valid iff it ends in a backstop."""

    latency_class = "storage"

    def __init__(self, features: np.ndarray, name: str = "storage"):
        self.features = features
        self.name = name

    @property
    def capacity_bytes(self) -> int:
        return int(self.features.nbytes)

    def probe(self, node_ids: np.ndarray) -> np.ndarray:
        return np.ones(len(node_ids), dtype=bool)

    def rows(self, node_ids: np.ndarray) -> np.ndarray:
        return np.asarray(self.features[node_ids])


class KVSlotTier(_TierBase):
    """KV-cache slot pool as a data-plane tier (serve engine).

    A request "hits" while it holds a slot — its KV lines are resident and
    un-evictable, the serving analogue of the window cache's USE state.  A
    retired request's slot returns to safe-to-evict and is recycled for the
    next admission.
    """

    latency_class = "hbm"

    def __init__(self, slots: int, bytes_per_slot: int = 0,
                 name: str = "kv-slots"):
        self.num_slots = slots
        self.bytes_per_slot = bytes_per_slot
        self.name = name
        self._free: deque[int] = deque(range(slots))
        self._held: dict[int, int] = {}              # rid -> slot

    @property
    def capacity_bytes(self) -> int:
        return self.num_slots * self.bytes_per_slot

    @property
    def occupancy(self) -> float:
        return len(self._held) / self.num_slots if self.num_slots else 0.0

    def probe(self, request_ids: np.ndarray) -> np.ndarray:
        held = np.fromiter(self._held.keys(), dtype=np.int64,
                           count=len(self._held))
        return np.isin(np.asarray(request_ids, dtype=np.int64), held)

    def admit(self, request_ids: np.ndarray) -> None:
        """Best-effort bulk admission: ids beyond the free capacity are NOT
        admitted (no queueing at this layer).  Callers that must know the
        outcome use `acquire()` per id — the serve engine does, keeping its
        own queue for the overflow."""
        for r in request_ids:
            self.acquire(int(r))

    def acquire(self, rid: int) -> int | None:
        """Assign a free slot to `rid` (idempotent); None when full."""
        if rid in self._held:
            return self._held[rid]
        if not self._free:
            return None
        slot = self._free.popleft()
        self._held[rid] = slot
        return slot

    def release(self, rid: int) -> int:
        slot = self._held.pop(rid)
        self._free.append(slot)
        return slot

    def reset(self) -> None:
        self._free = deque(range(self.num_slots))
        self._held.clear()


@dataclasses.dataclass
class GatherPlan:
    """Per-request tier assignment for one batch (or one merged window's
    unique set): `assignment[i]` indexes the tier that serves request i.
    Folding guarantees a partition.  Storage shards (`shard`, `remote`)
    wait for the sharded planes (ROADMAP.md Queue 1); the storage namespace
    is one shard."""

    node_ids: np.ndarray
    assignment: np.ndarray          # (B,) int8 index into `tiers`
    tiers: tuple

    def counts(self) -> np.ndarray:
        return np.bincount(self.assignment, minlength=len(self.tiers))

    def mask(self, tier_index: int) -> np.ndarray:
        return self.assignment == tier_index

    def is_partition(self) -> bool:
        a = self.assignment
        return bool(((a >= 0) & (a < len(self.tiers))).all()
                    and int(self.counts().sum()) == len(self.node_ids))

    def storage_mask(self) -> np.ndarray:
        """Requests whose serving tier is storage-class."""
        classes = np.array([t.latency_class == "storage" for t in self.tiers])
        return classes[self.assignment]

    @property
    def n_shards(self) -> int:
        """Shard count of the storage namespace: 1 until the sharded planes
        are ported."""
        return 1

    def kernel_slots(self, tier_index: int = 0) -> np.ndarray:
        """Slot array for `ops.tiered_gather`: requests served by the device
        tier carry their cache line, everything else -1 (staged row i).
        Slots resolve against the tier's post-probe metadata, so a hit whose
        line a later fill of the same batch took resolves to -1 and is
        served from the staged path."""
        tier = self.tiers[tier_index]
        slots = np.full(len(self.node_ids), -1, np.int32)
        m = self.mask(tier_index)
        if m.any():
            slots[m] = tier.lookup_slots(self.node_ids[m])
        return slots


def build_plan(tiers: Sequence[Tier], node_ids: np.ndarray,
               multiplicity: np.ndarray | None = None,
               inverses: list[np.ndarray] | None = None) -> GatherPlan:
    """Fold the ordered tier stack over one batch: each tier is offered the
    requests every faster tier declined; its hits are claimed.  The last
    tier must be a backstop (probe everything True).

    With `multiplicity` the fold is a merged-window one over a window's
    UNIQUE request set: a tier with `probe_merged` (the device store) takes
    the window in one pass, together with the per-batch `inverses` into
    `node_ids` that expand its rows; other tiers see a plain probe.  Only
    the top tier is offered the whole unique set, so a `probe_merged` tier
    must be first."""
    node_ids = np.asarray(node_ids)
    n = len(node_ids)
    assignment = np.full(n, -1, np.int8)
    unclaimed = np.ones(n, dtype=bool)
    for ti, tier in enumerate(tiers):
        idx = np.nonzero(unclaimed)[0]
        if len(idx) == 0:
            break
        if multiplicity is not None and hasattr(tier, "probe_merged"):
            if ti != 0:
                raise NotImplementedError(
                    f"merged window over tier {tier.name!r} at position "
                    f"{ti}: the port's merged executor needs the device "
                    "store on top (ROADMAP.md Queue 1: host planes)")
            hits = tier.probe_merged(node_ids, multiplicity, inverses)
        else:
            hits = tier.probe(node_ids[idx])
        hits = np.asarray(hits, dtype=bool)
        took = idx[hits]
        assignment[took] = ti
        unclaimed[took] = False
    if unclaimed.any():
        raise RuntimeError(
            f"tier stack {[t.name for t in tiers]} left "
            f"{int(unclaimed.sum())} of {n} requests unserved — the stack "
            "must end in a storage backstop")
    return GatherPlan(node_ids=node_ids, assignment=assignment,
                      tiers=tuple(tiers))


def build_plan_merged(tiers: Sequence[Tier], unique_nodes: np.ndarray,
                      multiplicity: np.ndarray,
                      inverses: list[np.ndarray]) -> GatherPlan:
    """Dedup-aware fold for a merged window: `build_plan` over the unique
    set with the window multiplicity and the per-batch inverses.  Same
    partition guarantee."""
    return build_plan(tiers, unique_nodes, multiplicity=multiplicity,
                      inverses=inverses)
