"""Pluggable data-plane tiers, the port's subset of `repro.core.tiers`: the
`Tier` protocol, the device, constant-buffer and storage tiers, and the
gather plan that folds a tier stack over one batch.

  DeviceCacheTier    — the host planes' cache: the numpy window-buffered
                       cache (`software_cache`) decides hits, fills and
                       evictions, and a row store on the loader's device
                       serves the hits through `tiered_gather`
  TenantCacheTier    — the serve plane's cache: one numpy cache partition
                       per tenant, their lines concatenated in one row
                       store on the device, served the same way
  DeviceStoreTier    — device cache metadata + device row store + the
                       `tiered_gather` kernel, via `device_store`; a merged
                       window goes through `tiered_gather_unique`
  ConstantBufferTier — `ConstantBuffer` (pinned host memory)
  StorageTier        — the storage backstop (always hits)
  ShardedStorageTier — the backstop partitioned across `n_shards` queues by
                       a `PlacementPolicy` (core/sharding.py); per-request
                       shard ids feed the per-shard burst pricing.  Shards
                       change pricing and telemetry, never bytes: the rows
                       still come from the device tiers or the host
  KVSlotTier         — the serve engine's KV-cache slot pool
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import HOT_PATH, NULL_TRACER
from . import cache_device, device_store
from .constant_buffer import ConstantBuffer
from .software_cache import WindowBufferedCache
from .storage_sim import IO_BYTES

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


class HostStager:
    """Rows of a host feature table staged for one copy to `device`.

    On CUDA the rows land in one pinned buffer that every call reuses, once
    the previous copy out of it has completed, and `to_device` starts a
    non-blocking copy that yields a new device tensor.  On the CPU each
    call returns a new tensor and `to_device` returns it as it is.  Either
    way a caller owns what `to_device` returns: a later staging never
    changes it."""

    def __init__(self, features: torch.Tensor, device: torch.device):
        self.features = features
        self.device = device
        self._pinned: torch.Tensor | None = None
        self._copied: torch.cuda.Event | None = None

    def stage(self, node_ids: np.ndarray) -> torch.Tensor:
        """features[node_ids] on the host, one row per id in their order."""
        idx = torch.from_numpy(np.asarray(node_ids, np.int64))
        if self.device.type == "cpu":
            return self.features.index_select(0, idx)
        shape = (len(idx), self.features.shape[1])
        if self._pinned is None or self._pinned.shape[0] < shape[0]:
            self._pinned = torch.empty(shape, dtype=self.features.dtype,
                                       pin_memory=True)
        elif self._copied is not None:
            self._copied.synchronize()
        return torch.index_select(self.features, 0, idx,
                                  out=self._pinned[:shape[0]])

    def to_device(self, host: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return host
        out = host.to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return out

    def reset(self) -> None:
        """Back to the built state: wait for the last copy out of the pinned
        buffer, then let the buffer go."""
        if self._copied is not None:
            self._copied.synchronize()
        self._pinned = self._copied = None


def _stage_timer(device: torch.device):
    """(events, mark): `mark(stage)` records a CUDA event named `stage` on
    the current stream; on the CPU it records nothing."""
    events: dict[str, torch.cuda.Event] = {}

    def mark(stage: str) -> None:
        if device.type == "cuda":
            events[stage] = torch.cuda.Event(enable_timing=True)
            events[stage].record()
    return events, mark


def _event_split(events: dict, stages: dict[str, tuple[str, ...]]
                 ) -> dict[str, float]:
    """ms per stage between CUDA events, once the last ("fill") completed:
    a stage sums the spans between its events taken in pairs."""
    events["fill"].synchronize()
    return {stage: sum(events[a].elapsed_time(events[b])
                       for a, b in zip(names[::2], names[1::2]))
            for stage, names in stages.items()}


#: Each tier's stages between CUDA events.  The device tier's `cache_access`
#: starts once the host has prepared the access's launches, so that their
#: enqueue on an idle stream is not read as the card's time.
_ROW_STORE_STAGES = {"h2d": ("start", "h2d"), "gather": ("h2d", "gather"),
                     "fill": ("gather", "fill")}
_DEVICE_STAGES = {"h2d": ("start", "ids", "rows_start", "rows"),
                  "cache_access": ("access", "cache_access"),
                  "gather": ("rows", "gather"), "fill": ("gather", "fill")}


class _StagedRows:
    """Rows of the requests `need` marks, staged compacted in request order
    on the host, and the (B,) int32 map from each request to its staged row
    (-1 where the row store serves it).  `copy()` starts both copies to the
    device.  Every tier that serves rows stages them this way."""

    def __init__(self, stager: HostStager, node_ids: np.ndarray,
                 need: np.ndarray):
        self.stager = stager
        self.host = stager.stage(node_ids[need])
        self.rows_map = np.full(len(need), -1, np.int32)
        self.rows_map[need] = np.arange(len(self.host), dtype=np.int32)
        self.rows_bytes = self.host.numel() * self.host.element_size()
        self.h2d_bytes = self.rows_bytes + self.rows_map.nbytes

    def copy(self) -> tuple[torch.Tensor, torch.Tensor]:
        staged = self.stager.to_device(self.host)
        rows_map = torch.from_numpy(self.rows_map).to(self.stager.device,
                                                      non_blocking=True)
        return staged, rows_map


class _StageNeeded:
    """The device tier's staging callable for `device_store.device_gather`:
    asked once the cache access has run, it reads the access's verdict back
    (the need and hit masks, in one copy), and stages and copies the needed
    requests' rows (`_StagedRows`).  It keeps the hit mask, the staged rows
    and its clock reads (`t_verdict` → `t_staging`: the wait for the
    verdict; → `t_staged`: the staging) for the probe."""

    def __init__(self, stager: HostStager, node_ids: np.ndarray, mark):
        self.stager, self.node_ids, self.mark = stager, node_ids, mark

    def __call__(self, need: torch.Tensor, hits: torch.Tensor):
        self.t_verdict = time.perf_counter()
        need, self.hits = torch.stack((need, hits)).cpu().numpy()
        self.t_staging = time.perf_counter()
        self.rows = _StagedRows(self.stager, self.node_ids, need)
        self.t_staged = time.perf_counter()
        self.mark("rows_start")
        out = self.rows.copy()
        self.mark("rows")
        return out


def _line_fillers(before: np.ndarray, after: np.ndarray,
                  node_ids: np.ndarray, slots: np.ndarray,
                  name: str) -> np.ndarray:
    """(L,) int32: for each line whose tag changed from `before` to `after`
    (flat tag arrays), the index of the request whose node is the new tag;
    -1 elsewhere.  That request must be a staged miss of the probe."""
    changed = np.flatnonzero(after != before)
    filler = np.full(len(after), -1, np.int32)
    if len(changed):
        order = np.argsort(node_ids, kind="stable")
        at = np.minimum(np.searchsorted(node_ids[order], after[changed]),
                        len(order) - 1)
        idx = order[at]
        if (node_ids[idx] != after[changed]).any() \
                or (slots[idx] >= 0).any():
            raise ValueError(
                f"{name}: a line was filled by a request that is not a "
                "staged miss of this probe; node ids must be unique within "
                "a probe")
        filler[changed] = idx
    return filler


class _RowStoreTier(_TierBase):
    """A numpy-metadata cache tier whose resident rows live in a row store
    `rows` (L, D) on the loader's device, zeros at first, one row per cache
    line at the index `lookup_slots` returns.

    Each probe runs the subclass's numpy access (`_access`), then:
      - `slots` = the post-probe line of each hit, -1 elsewhere (a miss, a
        bypass, or a hit whose line a later fill of its set took);
      - the host stages `features[node_ids[i]]` for the slot -1 rows only,
        compacted with their map (`_StagedRows`), and copies both;
      - `tiered_gather(slots, rows, staged, map)` serves every row into
        `last_rows` (a merged probe: one `tiered_gather_unique` per batch
        into `last_window_rows`);
      - `store_fill` writes each line whose tag changed during the probe
        from the staged row of the request whose node is its new tag.
    So after every probe each resident line l holds `features[tag[l]]` bit
    for bit.  Node ids must be unique within a probe, as a batch's or a
    window's are: the new tag of a line is then a miss of the probe, whose
    staged row is real.

    On CUDA, `last_split_ms` holds the last probe's time per stage (the
    numpy probe with its slots and fillers, and host staging, on the host
    clock; the rest between CUDA events) and `last_counts` its rows, hits,
    staged rows, filled lines, H2D bytes (the map included) and the staged
    rows' bytes.  An enabled `tracer` gets the two host stages as wall spans
    `access` and `stage_host`, from the same clock reads.
    """

    latency_class = "hbm"

    def _init_row_store(self, features: np.ndarray, num_lines: int,
                        device: str | torch.device) -> None:
        self.device = resolve_device(device)
        host = torch.from_numpy(np.ascontiguousarray(features))
        self._stager = HostStager(host, self.device)
        self.rows = torch.zeros((num_lines, host.shape[1]),
                                dtype=host.dtype, device=self.device)
        self.last_rows: torch.Tensor | None = None
        self.last_window_rows: list[torch.Tensor] | None = None
        self.last_split_ms: dict[str, float] = {}
        self.last_counts: dict[str, int] = {}
        self.tracer = NULL_TRACER

    def _flat_tags(self) -> np.ndarray:
        """The tag of every line of the row store, in its order."""
        raise NotImplementedError

    def _access(self, node_ids: np.ndarray,
                multiplicity: np.ndarray | None) -> np.ndarray:
        """The numpy cache access of one probe: its hit mask."""
        raise NotImplementedError

    def probe(self, node_ids: np.ndarray) -> np.ndarray:
        return self._probe_rows(np.asarray(node_ids))

    def probe_merged(self, node_ids: np.ndarray, multiplicity: np.ndarray,
                     inverses: list[np.ndarray] | None = None) -> np.ndarray:
        """One deduplicated probe for a whole merged window: each node
        consumes its full multiplicity at once (on a windowed cache the
        caller has already retired the consumed window entries and pushed
        the next window's).  `inverses` holds one index array per batch (or
        request) into `node_ids`; each one's rows land in
        `last_window_rows`.  Without them (the tier below the top of a
        merged fold) the rows of `node_ids` land in `last_rows`."""
        return self._probe_rows(np.asarray(node_ids), multiplicity, inverses)

    def _probe_rows(self, node_ids: np.ndarray,
                    multiplicity: np.ndarray | None = None,
                    inverses: list[np.ndarray] | None = None) -> np.ndarray:
        t0 = time.perf_counter()
        before = self._flat_tags().copy()
        hits = self._access(node_ids, multiplicity)
        slots = np.full(len(node_ids), -1, np.int32)
        slots[hits] = self.lookup_slots(node_ids[hits])
        filler = _line_fillers(before, self._flat_tags(), node_ids, slots,
                               self.name)
        t1 = time.perf_counter()
        rows = _StagedRows(self._stager, node_ids, slots < 0)
        t2 = time.perf_counter()
        events, mark = _stage_timer(self.device)
        mark("start")
        staged, rows_map = rows.copy()
        slots_d = torch.from_numpy(slots).to(self.device, non_blocking=True)
        filled = bool((filler >= 0).any())
        if filled:
            filler_d = torch.from_numpy(filler).to(self.device,
                                                   non_blocking=True)
        if inverses is not None:
            inv_d = torch.from_numpy(np.concatenate(inverses)).to(
                self.device, non_blocking=True).to(torch.int32)
        mark("h2d")
        if inverses is None:
            self.last_rows = ops.tiered_gather(slots_d, self.rows, staged,
                                               rows_map)
            self.last_window_rows = None
        else:
            self.last_rows = None
            self.last_window_rows = [
                ops.tiered_gather_unique(slots_d, self.rows, staged, inv,
                                         rows_map)
                for inv in torch.split(inv_d, [len(i) for i in inverses])]
        mark("gather")
        if filled:                  # after the gather: it reads no new line
            ops.store_fill(self.rows, filler_d, staged, rows_map)
        mark("fill")
        self.last_counts = {"rows": len(node_ids), "hits": int(hits.sum()),
                            "staged_rows": rows.host.shape[0],
                            "filled_lines": int((filler >= 0).sum()),
                            "h2d_bytes": rows.h2d_bytes,
                            "needed_bytes": rows.rows_bytes}
        if events:
            self.last_split_ms = {"probe": (t1 - t0) * 1e3,
                                  "stage_host": (t2 - t1) * 1e3} \
                | _event_split(events, _ROW_STORE_STAGES)
        if self.tracer.enabled:
            self.tracer.record("access", t0, t1, rows=len(node_ids),
                               hits=self.last_counts["hits"])
            self.tracer.record("stage_host", t1, t2,
                               rows=self.last_counts["staged_rows"],
                               bytes=self.last_counts["needed_bytes"])
        return hits

    def device_rows(self) -> torch.Tensor:
        """The resident row store on the loader's device."""
        return self.rows

    def _reset_row_store(self, num_lines: int) -> None:
        """Back to the built state: wait for the copies out of the pinned
        staging buffer, and zero the row store (reallocated when the line
        count changed)."""
        self._stager.reset()
        if self.rows.shape[0] == num_lines:
            self.rows.zero_()
        else:
            self.rows = torch.zeros((num_lines, self.rows.shape[1]),
                                    dtype=self.rows.dtype,
                                    device=self.device)
        self.last_rows = self.last_window_rows = None


class DeviceCacheTier(_RowStoreTier):
    """Device tier of the host planes (§3.4): the numpy window-buffered
    cache keeps the metadata on the host, and a row store `rows`
    (num_lines, D) on the loader's device holds the row of every resident
    line at index `set * ways + way`, the index `lookup` returns.  Probes
    serve and fill it as `_RowStoreTier` sets out."""

    def __init__(self, cache: WindowBufferedCache, features: np.ndarray,
                 name: str = "hbm-cache", line_bytes: int = IO_BYTES,
                 device: str | torch.device = "cuda"):
        self.cache = cache
        self.name = name
        self.line_bytes = line_bytes
        self._init_row_store(features, cache.num_sets * cache.ways, device)

    @property
    def capacity_bytes(self) -> int:
        return self.cache.num_sets * self.cache.ways * self.line_bytes

    @property
    def window_depth(self) -> int:
        return self.cache.window_depth

    @property
    def window(self) -> deque:
        return self.cache.window

    def _flat_tags(self) -> np.ndarray:
        return self.cache.tags.reshape(-1)

    def _access(self, node_ids: np.ndarray,
                multiplicity: np.ndarray | None) -> np.ndarray:
        return (self.cache.access(node_ids) if multiplicity is None
                else self.cache.access_merged(node_ids, multiplicity))

    def admit(self, node_ids: np.ndarray) -> None:
        self.cache.push_window(node_ids)

    def lookup_slots(self, node_ids: np.ndarray) -> np.ndarray:
        """Resident cache line per node (post-probe), -1 if absent."""
        return self.cache.lookup(node_ids)

    def reset(self) -> None:
        self._reset_row_store(self.rows.shape[0])
        self.cache.reset()


class TenantCacheTier(_RowStoreTier):
    """Device software-cache tier partitioned per tenant, with priced
    isolation: the serving twin of `DeviceCacheTier`.

    The line budget is split into per-tenant `WindowBufferedCache`
    partitions (window_depth=0: serving has no epoch lookahead, so eviction
    is random within the partition).  A request fills and evicts ONLY
    inside its own tenant's partition, so a noisy tenant cannot evict
    another tenant's hot set, and the misses a quota creates are priced in
    the storage burst like any other miss.

    The serving engine announces who is asking via `stage_tenants(
    tenant_of)` immediately before the gather: one tenant id per node
    offered to the next `probe` / `probe_merged`.  This tier must therefore
    sit FIRST in the stack.  A node two tenants share is served from (and
    filled into) the first requester's partition for that window.
    Un-staged probes default to tenant 0.

    The partitions' lines are concatenated in one row store on the device,
    partition t's lines after the budgets of the partitions before it (the
    offsets `lookup_slots` returns), and served as `_RowStoreTier` sets
    out.  `lookup_slots` is tenant-agnostic, so a hit may be served from
    another tenant's partition; every resident line holds its tag's row
    either way.  A `repartition` rebuilds the partitions cold, and with
    them the row store: zeroed, at the new total of lines.
    """

    def __init__(self, num_lines: int, ways: int = 8, tenants: int = 1,
                 quotas: Sequence[float] | None = None, seed: int = 0,
                 line_bytes: int = IO_BYTES, name: str = "hbm-tenant-cache",
                 *, features: np.ndarray,
                 device: str | torch.device = "cuda"):
        if tenants < 1:
            raise ValueError(f"need at least one tenant, got {tenants}")
        if quotas is None:
            quotas = (1.0 / tenants,) * tenants
        self.ways = ways
        self.line_bytes = line_bytes
        self.name = name
        self._num_lines = int(num_lines)
        self._seed = seed
        self._tenants = tenants
        self._init_quotas = self._check_quotas(quotas)
        self.quotas = self._init_quotas
        self.partitions = self._build_partitions(self.quotas)
        self._staged: np.ndarray | None = None
        self._init_row_store(features, self.total_lines, device)

    def _check_quotas(self, quotas: Sequence[float]) -> tuple[float, ...]:
        quotas = tuple(float(q) for q in quotas)
        if len(quotas) != self._tenants:
            raise ValueError(
                f"{len(quotas)} quotas for {self._tenants} tenants — pass "
                "one capacity share per tenant")
        if any(q <= 0 for q in quotas):
            raise ValueError(f"quotas must be positive, got {quotas}")
        return quotas

    def _build_partitions(self, quotas: tuple[float, ...]
                          ) -> tuple[WindowBufferedCache, ...]:
        total = sum(quotas)
        # per-partition line budget: quota share rounded down to a whole
        # number of sets, floored at one set; partition seeds derive from
        # the tenant index, so a tenant's hash placement is stable across
        # repartitions
        return tuple(
            WindowBufferedCache(
                max(self.ways,
                    (int(self._num_lines * q / total) // self.ways)
                    * self.ways),
                self.ways, window_depth=0, seed=self._seed + 17 * t)
            for t, q in enumerate(quotas))

    def repartition(self, quotas: Sequence[float]) -> None:
        """Online quota re-split (the `QuotaController`'s actuator): rebuild
        the per-tenant partitions at the new shares, cold, and the row
        store with them.  Each tenant's cumulative hit/access counters
        carry over, so `hit_ratio(tenant)` stays a run-long signal."""
        quotas = self._check_quotas(quotas)
        stats = [c.stats for c in self.partitions]
        self.partitions = self._build_partitions(quotas)
        for cache, old in zip(self.partitions, stats):
            cache.stats = old
        self.quotas = quotas
        self._reset_row_store(self.total_lines)

    @property
    def tenants(self) -> int:
        return len(self.partitions)

    @property
    def total_lines(self) -> int:
        return sum(c.num_sets * c.ways for c in self.partitions)

    @property
    def capacity_bytes(self) -> int:
        return self.total_lines * self.line_bytes

    def partition_lines(self, tenant: int) -> int:
        c = self.partitions[tenant]
        return c.num_sets * c.ways

    def stage_tenants(self, tenant_of: np.ndarray) -> None:
        """Announce the requesting tenant of each node in the NEXT probe —
        (n,) int array positionally aligned with the node list the fold
        will offer.  Consumed by that one probe."""
        t = np.asarray(tenant_of)
        if len(t) and (t.min() < 0 or t.max() >= self.tenants):
            raise ValueError(
                f"tenant ids in [{t.min()}, {t.max()}] out of range for "
                f"{self.tenants} partitions")
        self._staged = t

    def _take_staged(self, n: int) -> np.ndarray:
        t = self._staged
        self._staged = None
        if t is None:
            return np.zeros(n, np.int64)
        if len(t) != n:
            raise ValueError(
                f"staged {len(t)} tenant ids but the fold offered {n} "
                "nodes — the tenant tier must be first in the stack")
        return t

    def _flat_tags(self) -> np.ndarray:
        return np.concatenate([c.tags.reshape(-1) for c in self.partitions])

    def _access(self, node_ids: np.ndarray,
                multiplicity: np.ndarray | None) -> np.ndarray:
        tenant = self._take_staged(len(node_ids))
        hits = np.zeros(len(node_ids), dtype=bool)
        for tid, cache in enumerate(self.partitions):
            m = tenant == tid
            if not m.any():
                continue
            mult = None if multiplicity is None else multiplicity[m]
            hits[m] = cache.access(node_ids[m], multiplicity=mult)
        return hits

    def lookup_slots(self, node_ids: np.ndarray) -> np.ndarray:
        """Resident line per node across the concatenated partitions
        (partition t's lines offset by the budgets before it), -1 if the
        node is resident in no partition.  Read-only, tenant-agnostic."""
        out = np.full(len(node_ids), -1, np.int64)
        offset = 0
        for cache in self.partitions:
            slot = cache.lookup(np.asarray(node_ids))
            found = (out == -1) & (slot >= 0)
            out[found] = slot[found] + offset
            offset += cache.num_sets * cache.ways
        return out

    def hit_ratio(self, tenant: int) -> float:
        return self.partitions[tenant].stats.hit_ratio

    def hit_ratios(self) -> tuple[float, ...]:
        """Cumulative per-tenant hit ratios — the quota controller's input,
        rolled up into `ServeResult.tenant_hit_ratios`."""
        return tuple(c.stats.hit_ratio for c in self.partitions)

    def reset(self) -> None:
        # full post-construction state: construction-time quotas restored,
        # partitions cold, fresh counters, the row store zeroed
        self.quotas = self._init_quotas
        self.partitions = self._build_partitions(self.quotas)
        self._staged = None
        self._reset_row_store(self.total_lines)


class DeviceStoreTier(_TierBase):
    """Device tier: cache metadata, row store and gather on the loader's
    device, via `device_store.device_gather`.

    Each probe copies the ids and their reuse counts to the device and runs
    the cache access there first.  It then reads back the access's verdict
    (which requests the card reads from staged rows, and the hit mask), and
    stages and copies only those rows with their map (`_StagedRows`): the
    misses and bypasses.  A hit's row is never staged (on a cold probe
    every row is, and the map is the identity).  The gather and the fill
    read staged rows through the map.
    `last_rows` holds every requested row as a device tensor, the real data
    path of this tier.  No shape bucket is needed: requests are not padded.
    A merged-window probe (`probe_merged`) does the same once over the
    window's unique rows and leaves one device tensor per batch in
    `last_window_rows`.

    `last_counts` holds the last probe's rows, hits, staged rows, the bytes
    copied for them (`h2d_bytes`, the map included) and the staged rows'
    bytes (`needed_bytes`).  On CUDA, `last_split_ms` holds its time per
    stage: on the host clock the window's reuse counts (`future_counts`),
    host staging (`stage_host`) and the host's wait for the card
    (`probe_wait`: the verdict's read, and the wait from the end of the
    enqueue until the CUDA events are read); between CUDA events the two
    copies together (`h2d`) and the three device stages, no pair of them
    spanning a host wait or the staging.  An enabled `tracer` gets the host
    stages as wall spans from the same clock reads, `probe_wait` once for
    each of its two waits.
    """

    latency_class = "hbm"

    def __init__(self, features: np.ndarray, num_lines: int, ways: int = 8,
                 window_depth: int = 0, name: str = "device-store",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        host = torch.from_numpy(np.ascontiguousarray(features))
        self._stager = HostStager(host, self.device)
        self._init_args = (num_lines, features.shape[1], ways, host.dtype,
                           self.device)
        self.store = device_store.init_store(*self._init_args)
        self.window_depth = window_depth
        self.window: deque[np.ndarray] = deque()
        self.name = name
        self.last_rows: torch.Tensor | None = None
        self.last_window_rows: list[torch.Tensor] | None = None
        self.last_split_ms: dict[str, float] = {}
        self.last_counts: dict[str, int] = {}
        self.tracer = NULL_TRACER

    @property
    def capacity_bytes(self) -> int:
        rows = self.store.rows
        return rows.numel() * rows.element_size()

    def _future_counts(self, ids: np.ndarray) -> tuple[np.ndarray, int]:
        """Per-id count of future window batches containing it: each window
        entry contributes its unique ids once, the sorted concatenation is
        binary-searched from both sides, and the span width is the count.
        Also returns how many ids the concatenation sorted."""
        if not self.window:
            return np.zeros(len(ids), np.int32), 0
        cat = np.sort(np.concatenate(
            [np.unique(np.asarray(w)) for w in self.window]))
        lo = np.searchsorted(cat, ids, side="left")
        hi = np.searchsorted(cat, ids, side="right")
        return (hi - lo).astype(np.int32), len(cat)

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
        `last_window_rows`.  Without them (the tier below the top of a
        merged fold) the rows of `node_ids` land in `last_rows`."""
        del multiplicity
        return self._probe_rows(node_ids, inverses)

    def _probe_rows(self, node_ids: np.ndarray,
                    inverses: list[np.ndarray] | None = None) -> np.ndarray:
        node_ids = np.asarray(node_ids)
        ids = node_ids.astype(np.int32)
        events, mark = _stage_timer(self.device)
        t0 = time.perf_counter()
        fc, n_sorted = self._future_counts(node_ids)
        t1 = time.perf_counter()
        mark("start")
        ids_d = torch.from_numpy(ids).to(self.device, non_blocking=True)
        fc_d = torch.from_numpy(fc).to(self.device, non_blocking=True)
        if inverses is not None:
            # one int64 upload for the window, cast to int32 on the device
            inv_d = torch.from_numpy(np.concatenate(inverses)).to(
                self.device, non_blocking=True).to(torch.int32)
        mark("ids")
        stage = _StageNeeded(self._stager, node_ids, mark)
        if inverses is None:
            _, rows, _ = device_store.device_gather(
                self.store, ids_d, stage, fc_d, mark=mark)
            self.last_rows, self.last_window_rows = rows, None
        else:
            _, rows_list, _ = device_store.device_gather_merged(
                self.store, ids_d, stage, fc_d,
                torch.split(inv_d, [len(i) for i in inverses]), mark=mark)
            self.last_rows, self.last_window_rows = None, rows_list
        t2 = time.perf_counter()
        split = _event_split(events, _DEVICE_STAGES) if events else {}
        t3 = time.perf_counter()
        self.last_counts = {
            "rows": len(ids), "hits": int(stage.hits.sum()),
            "staged_rows": stage.rows.host.shape[0],
            "h2d_bytes": stage.rows.h2d_bytes,
            "needed_bytes": stage.rows.rows_bytes}
        if split:
            wait_ms = (stage.t_staging - stage.t_verdict + t3 - t2) * 1e3
            self.last_split_ms = {
                "future_counts": (t1 - t0) * 1e3,
                "stage_host": (stage.t_staged - stage.t_staging) * 1e3} \
                | split | {"probe_wait": wait_ms}
        tr = self.tracer
        if tr.enabled:
            tr.record("future_counts", t0, t1, ids=n_sorted)
            tr.record("probe_wait", stage.t_verdict, stage.t_staging)
            tr.record("stage_host", stage.t_staging, stage.t_staged,
                      rows=len(ids), staged=stage.rows.host.shape[0],
                      bytes=stage.rows.rows_bytes)
            tr.record("probe_wait", t2, t3)
        return stage.hits

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

    def device_rows(self) -> torch.Tensor:
        """The resident row store on the loader's device."""
        return self.store.rows

    def reset(self) -> None:
        self._stager.reset()
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


class ShardedStorageTier(StorageTier):
    """The storage backstop partitioned across `n_shards` independent SSD
    queues by a `PlacementPolicy` (core/sharding.py).

    The *bytes* are unchanged — one logical feature namespace, every probe
    hits — but each storage-bound request now carries the shard whose queue
    it drains through (`shard_of`, threaded into `GatherPlan.shard` by
    `build_plan`).  Pricing then completes the batch at the MAX over shards
    (`storage_sim.price_sharded_burst`), which is what makes multi-SSD
    scaling and placement skew measurable.

    `specs` may be one `SSDSpec` (homogeneous array), a sequence of
    `n_shards` specs (heterogeneous — e.g. one Optane + three 980Pros, the
    straggler story), or None (every shard inherits the loader's device
    spec).
    """

    def __init__(self, features: np.ndarray, placement,
                 specs=None, name: str = "sharded-storage"):
        super().__init__(features, name=name)
        self.placement = placement
        if specs is not None and not isinstance(specs, (list, tuple)):
            specs = (specs,) * placement.n_shards
        if specs is not None:
            specs = tuple(specs)
            if len(specs) != placement.n_shards:
                raise ValueError(
                    f"{len(specs)} shard specs for {placement.n_shards} "
                    "shards — pass one spec per shard (or a single spec "
                    "to replicate)")
        self.specs = specs
        # fault plane: a FailoverRouter (core/faults.py) rewrites the
        # placement decision at plan time — reads off dead/degraded shards
        # go to a live replica.  None (the default) keeps shard_of the
        # bare placement, bit-identical to the unrouted plane.
        self.router = None

    @property
    def n_shards(self) -> int:
        return self.placement.n_shards

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray:
        """Per-request shard id (the placement decision), (B,) int16.
        With a router wired, the decision is failover-adjusted — same
        bytes, healthier queue."""
        primary = np.asarray(self.placement.shard_of(node_ids), np.int16)
        if self.router is None:
            return primary
        return np.asarray(self.router.route(node_ids, primary), np.int16)

    def resolve_shard_specs(self, default_spec) -> tuple:
        """Per-shard `SSDSpec`s, falling back to `default_spec` (the
        loader's device) when the tier was built spec-less."""
        if self.specs is not None:
            return self.specs
        return (default_spec,) * self.n_shards

    # -- checkpoint -----------------------------------------------------------
    def state_dict(self) -> dict:
        """Shard-assignment state for checkpoint round-trip.  Built-in
        policies are deterministic, but the table-based ones (`degree`) are
        exactly what an online rebalancer would mutate — resume restores the
        assignment rather than trusting reconstruction."""
        return {"n_shards": self.n_shards,
                "placement": self.placement.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if state.get("n_shards", self.n_shards) != self.n_shards:
            raise ValueError(
                f"checkpoint has {state.get('n_shards')} shards, tier has "
                f"{self.n_shards} — shard count is namespace layout, not "
                "runtime state")
        self.placement.load_state_dict(state["placement"])


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
    """Per-request tier assignment for one batch: `assignment[i]` indexes the
    tier stack entry that serves request i.  Folding guarantees a partition
    (`is_partition`); `kernel_slots` renders the device-tier portion as the
    slot array the `tiered_gather` kernel consumes.

    `shard[i]` is the storage shard serving request i: the placement
    decision of a `ShardedStorageTier`, 0 for a single-queue storage tier,
    and -1 iff the serving tier is not storage-class (`shard_consistent`
    pins that invariant).  Shard ids drive shard-local 4 KB-line coalescing
    and the max-over-shards burst pricing.

    `remote[i]` (host planes only — core/hosts.py) marks requests whose
    serving host differs from the host that REQUESTED them; those rows'
    lines additionally transit the serving host's link in
    `StorageTimeline.price_host_burst`.  None on single-host planes —
    remote-ness is a pricing/telemetry annotation, never a routing one, so
    gathered bytes cannot depend on it."""

    node_ids: np.ndarray
    assignment: np.ndarray          # (B,) int8 index into `tiers`
    tiers: tuple
    shard: np.ndarray | None = None  # (B,) int16; -1 = not storage-bound
    remote: np.ndarray | None = None  # (B,) bool; True = crosses a host link

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
        """Shard count of the stack's storage namespace (1 when unsharded)."""
        return max((getattr(t, "n_shards", 1) for t in self.tiers), default=1)

    def shard_consistent(self) -> bool:
        """Shard ids are defined exactly where the serving tier is
        storage-class, and always index a real shard."""
        if self.shard is None:
            return not self.storage_mask().any()
        sm = self.storage_mask()
        s = self.shard
        return bool(((s[sm] >= 0) & (s[sm] < self.n_shards)).all()
                    and (s[~sm] == -1).all())

    def shard_counts(self) -> np.ndarray:
        """Storage-bound requests per shard, (n_shards,)."""
        if self.shard is None:
            return np.zeros(self.n_shards, np.int64)
        sm = self.shard >= 0
        return np.bincount(self.shard[sm], minlength=self.n_shards)

    def remote_counts(self) -> np.ndarray:
        """Cross-host storage requests per SERVING shard, (n_shards,) —
        the rows each host ships over its link (zeros off host planes)."""
        if self.shard is None or self.remote is None:
            return np.zeros(self.n_shards, np.int64)
        rm = self.remote & (self.shard >= 0)
        return np.bincount(self.shard[rm], minlength=self.n_shards)

    def kernel_slots(self, tier_index: int = 0) -> np.ndarray:
        """Slot array for `ops.tiered_gather`: requests served by the device
        tier carry their cache line, everything else -1 (staged row i).

        Slots are resolved against the tier's *post-probe* metadata — the
        same state `TieredFeatureStore.device_rows` materializes — so the
        (slots, rows) pair is always coherent.  A hit whose line was evicted
        later in the same batch (a colliding fill in its set) resolves to -1
        and is demoted to the staged path: the gathered bytes stay correct,
        at worst the pricing report counted one extra HBM hit."""
        tier = self.tiers[tier_index]
        slots = np.full(len(self.node_ids), -1, np.int32)
        m = self.mask(tier_index)
        if m.any():
            slots[m] = tier.lookup_slots(self.node_ids[m])
        return slots


def build_plan(tiers: Sequence[Tier], node_ids: np.ndarray,
               multiplicity: np.ndarray | None = None,
               inverses: list[np.ndarray] | None = None,
               tracer=NULL_TRACER) -> GatherPlan:
    """Fold the ordered tier stack over one batch: each tier is offered the
    requests every faster tier declined; its hits are claimed.  The last
    tier must be a backstop (probe everything True).  An enabled `tracer`
    gets one wall span `probe` per tier offered requests, with the tier's
    name, the rows offered and the hits.

    With `multiplicity` the fold is a merged-window one over a window's
    UNIQUE request set: a tier with `probe_merged` (a device tier) consumes
    each node's full multiplicity in one pass; on top of the stack it also
    takes the per-batch `inverses` into `node_ids` that expand its rows.
    Other tiers see a plain probe."""
    node_ids = np.asarray(node_ids)
    n = len(node_ids)
    assignment = np.full(n, -1, np.int8)
    unclaimed = np.ones(n, dtype=bool)
    for ti, tier in enumerate(tiers):
        idx = np.nonzero(unclaimed)[0]
        if len(idx) == 0:
            break
        with tracer.stage("probe", cat=HOT_PATH, tier=tier.name,
                          rows=len(idx)) as sp:
            if multiplicity is not None and hasattr(tier, "probe_merged"):
                # only the top tier sees the whole unique set the inverses
                # index
                hits = tier.probe_merged(node_ids[idx], multiplicity[idx],
                                         inverses if ti == 0 else None)
            else:
                hits = tier.probe(node_ids[idx])
            hits = np.asarray(hits, dtype=bool)
        if tracer.enabled:
            sp.annotate(hits=int(hits.sum()))
        took = idx[hits]
        assignment[took] = ti
        unclaimed[took] = False
    if unclaimed.any():
        raise RuntimeError(
            f"tier stack {[t.name for t in tiers]} left "
            f"{int(unclaimed.sum())} of {n} requests unserved — the stack "
            "must end in a storage backstop")
    # storage-bound requests carry the serving tier's shard decision; a
    # single-queue storage tier is shard 0, redirected requests stay -1
    shard = np.full(n, -1, np.int16)
    remote = None
    for ti, tier in enumerate(tiers):
        if tier.latency_class != "storage":
            continue
        m = assignment == ti
        if not m.any():
            continue
        if hasattr(tier, "shard_of"):
            shard[m] = tier.shard_of(node_ids[m])
            if hasattr(tier, "remote_mask"):
                # host-level backstop: stamp which requests the serving
                # host ships over its link (requester != server)
                if remote is None:
                    remote = np.zeros(n, bool)
                remote[m] = tier.remote_mask(node_ids[m], shard[m])
        else:
            shard[m] = 0
    return GatherPlan(node_ids=node_ids, assignment=assignment,
                      tiers=tuple(tiers), shard=shard, remote=remote)


def build_plan_merged(tiers: Sequence[Tier], unique_nodes: np.ndarray,
                      multiplicity: np.ndarray,
                      inverses: list[np.ndarray],
                      tracer=NULL_TRACER) -> GatherPlan:
    """Dedup-aware fold for a merged window: `build_plan` over the unique
    set with the window multiplicity and the per-batch inverses.  Same
    partition guarantee."""
    return build_plan(tiers, unique_nodes, multiplicity=multiplicity,
                      inverses=inverses, tracer=tracer)


def record_tier_metrics(tiers: Sequence[Tier], registry) -> None:
    """Fold the tier stack's cumulative cache telemetry into a
    MetricsRegistry (repro_torch.obs): one ``tier.<name>.hit_ratio`` gauge
    per cache-bearing tier, per-tenant gauges for a partitioned tier.
    Observation only, nothing here feeds back into probe or admission."""
    for tier in tiers:
        name = getattr(tier, "name", type(tier).__name__)
        stats = getattr(getattr(tier, "cache", None), "stats", None)
        if stats is not None and stats.accesses:
            registry.gauge(f"tier.{name}.hit_ratio").set(stats.hit_ratio)
            registry.gauge(f"tier.{name}.accesses").set(stats.accesses)
            registry.gauge(f"tier.{name}.evictions").set(stats.evictions)
        ratios = getattr(tier, "hit_ratios", None)
        if callable(ratios):
            for tenant, ratio in enumerate(ratios()):
                registry.gauge(
                    f"tier.{name}.tenant{tenant}.hit_ratio").set(ratio)
