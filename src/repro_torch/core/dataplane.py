"""Declarative data-plane composition, the port's subset of
`repro.core.dataplane`: `DataPlaneSpec`, the tier-kind registry with the
`window_cache`, `device_store`, `constant_buffer`, `storage`,
`sharded_storage`, `host_storage`, `tenant_cache` and `kv_slots` kinds,
the paper's host planes (`gids`, `bam`, `mmap`, `gids-async`,
`pinned-host`) with their merged (`gids-merged*`), topology (`gids-topo*`),
sharded (`gids-sharded`, `gids-merged-sharded`) and cluster (`gids-hosts`,
`gids-hosts-merged`) presets, the device-resident `gids-device` preset,
the GNN serve engine's `serve-gnn` and `serve-gnn-shared` presets, and
the LM serve engine's `serve-kv` preset.

    plane = DataPlaneSpec.preset("gids").build(graph, features,
                                               device="cuda")
    rows, report = plane.store.gather(node_ids)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np

from .constant_buffer import ConstantBuffer
from .feature_store import TieredFeatureStore
from .hosts import HostShardTier
from .sharding import ReplicatedPlacement, make_placement
from .software_cache import WindowBufferedCache
from .storage_sim import StorageTimeline
from .tiers import (ConstantBufferTier, DeviceCacheTier, DeviceStoreTier,
                    KVSlotTier, ShardedStorageTier, StorageTier,
                    TenantCacheTier, Tier)


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One tier in a declarative stack: a registered kind plus overrides.
    Params left unset fall back to the BuildContext knobs."""

    kind: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def tier(kind: str, **params) -> TierSpec:
    """Sugar: `tier("window_cache", window_depth=0)`."""
    return TierSpec(kind, params)


@dataclasses.dataclass
class BuildContext:
    """Everything a tier factory may need.  Field names mirror
    `LoaderConfig` so `build(config=cfg)` maps knobs across by name."""

    graph: Any = None
    features: Any = None
    cache_lines: int = 1 << 15
    cache_ways: int = 8
    window_depth: int = 8
    cbuf_fraction: float = 0.1
    cbuf_selection: str = "pagerank"
    seed: int = 0
    device: Any = "cuda"
    # sharded-storage knobs (multi-SSD namespace)
    n_shards: int = 1
    placement: str = "hash"
    # fault plane: k-way replication (ReplicatedPlacement wrapped around
    # the placement policy) so failover and hedged reads have somewhere to
    # go; 1 = unreplicated, bit-identical to the bare policy
    replication_factor: int = 1
    # multi-host plane (core/hosts.py): shards become hosts with the
    # default 100GbE link each; co_partition drives features AND edge pages
    # off one placement decision
    n_hosts: int = 1
    co_partition: bool = True
    # serve engine KV slot pool
    slots: int = 0
    bytes_per_slot: int = 0
    # multi-tenant serving (per-tenant cache partitions)
    tenants: int = 1
    tenant_quotas: Any = None         # per-tenant capacity shares, None=equal

    _KNOBS = ("cache_lines", "cache_ways", "window_depth", "cbuf_fraction",
              "cbuf_selection", "seed", "n_shards", "placement",
              "replication_factor", "n_hosts", "co_partition", "tenants",
              "tenant_quotas")

    def absorb(self, config: Any) -> "BuildContext":
        for k in self._KNOBS:
            if config is not None and hasattr(config, k):
                setattr(self, k, getattr(config, k))
        return self


TierFactory = Callable[..., "Tier | None"]
_TIER_KINDS: dict[str, TierFactory] = {}


def register_tier_kind(kind: str) -> Callable[[TierFactory], TierFactory]:
    """Register a factory `(ctx: BuildContext, **params) -> Tier | None`.
    Returning None omits the tier (e.g. a constant buffer at fraction 0)."""
    def deco(fn: TierFactory) -> TierFactory:
        _TIER_KINDS[kind] = fn
        return fn
    return deco


@register_tier_kind("window_cache")
def _make_window_cache(ctx: BuildContext, num_lines=None, ways=None,
                       window_depth=None, evict="random") -> Tier:
    num_lines = ctx.cache_lines if num_lines is None else num_lines
    ways = ctx.cache_ways if ways is None else ways
    window_depth = ctx.window_depth if window_depth is None else window_depth
    return DeviceCacheTier(WindowBufferedCache(
        num_lines, ways, window_depth=window_depth, seed=ctx.seed,
        evict=evict), ctx.features, device=ctx.device)


@register_tier_kind("constant_buffer")
def _make_constant_buffer(ctx: BuildContext, fraction=None,
                          selection=None) -> Tier | None:
    fraction = ctx.cbuf_fraction if fraction is None else fraction
    selection = ctx.cbuf_selection if selection is None else selection
    if fraction <= 0:
        return None
    if ctx.graph is None:
        raise ValueError(
            "constant_buffer tier needs a graph in the BuildContext to rank "
            "hot nodes; pass build(graph, ...) or set fraction=0 to omit it")
    cbuf = ConstantBuffer.from_graph(ctx.graph, fraction,
                                     selection=selection, seed=ctx.seed)
    row_bytes = None
    if ctx.features is not None:
        row_bytes = ctx.features.shape[1] * ctx.features.dtype.itemsize
    return ConstantBufferTier(cbuf, row_bytes=row_bytes)


@register_tier_kind("device_store")
def _make_device_store(ctx: BuildContext, num_lines=None, ways=None,
                       window_depth=None) -> Tier:
    num_lines = ctx.cache_lines if num_lines is None else num_lines
    ways = ctx.cache_ways if ways is None else ways
    window_depth = ctx.window_depth if window_depth is None else window_depth
    return DeviceStoreTier(ctx.features, num_lines, ways=ways,
                           window_depth=window_depth, device=ctx.device)


@register_tier_kind("storage")
def _make_storage(ctx: BuildContext) -> Tier:
    if ctx.features is None:
        raise ValueError("storage tier needs features in the BuildContext")
    return StorageTier(ctx.features)


@register_tier_kind("sharded_storage")
def _make_sharded_storage(ctx: BuildContext) -> Tier:
    """The storage backstop partitioned across `ctx.n_shards` SSD queues by
    a registered placement policy (core/sharding.py: hash / range / degree
    / skewed, plus user registrations); every shard inherits the loader's
    device spec."""
    if ctx.features is None:
        raise ValueError("sharded_storage tier needs features in the "
                         "BuildContext")
    degrees = None
    if ctx.graph is not None and hasattr(ctx.graph, "degrees"):
        degrees = ctx.graph.degrees()
    policy = make_placement(ctx.placement, ctx.n_shards,
                            num_nodes=len(ctx.features), degrees=degrees,
                            graph=ctx.graph, seed=ctx.seed)
    if ctx.replication_factor > 1:
        # k-way replication for the fault plane; validates loudly (k vs
        # n_shards) at build time rather than at first failover
        policy = ReplicatedPlacement(policy, ctx.replication_factor)
    return ShardedStorageTier(ctx.features, policy)


@register_tier_kind("host_storage")
def _make_host_storage(ctx: BuildContext) -> Tier:
    """The storage backstop partitioned across a CLUSTER (core/hosts.py):
    each shard is a host — interconnect + local SSD — and the placement
    decision, co-partitioned by default, drives both the feature rows and
    the CSR edge pages of every node.  Replication (if any) spreads copies
    across hosts as failure domains."""
    if ctx.features is None:
        raise ValueError("host_storage tier needs features in the "
                         "BuildContext")
    degrees = None
    if ctx.graph is not None and hasattr(ctx.graph, "degrees"):
        degrees = ctx.graph.degrees()
    policy = make_placement(ctx.placement, ctx.n_hosts,
                            num_nodes=len(ctx.features), degrees=degrees,
                            graph=ctx.graph, seed=ctx.seed)
    if ctx.replication_factor > 1:
        # hosts are failure domains: replica j of a row must land on a
        # DIFFERENT host, so a whole-host outage cannot lose data
        policy = ReplicatedPlacement(policy, ctx.replication_factor,
                                     failure_domains=np.arange(ctx.n_hosts))
    return HostShardTier(ctx.features, policy, graph=ctx.graph,
                         co_partition=ctx.co_partition, seed=ctx.seed)


@register_tier_kind("tenant_cache")
def _make_tenant_cache(ctx: BuildContext) -> Tier:
    """Per-tenant partitioned device software cache for the serve plane
    (`TenantCacheTier`): the line budget is split by tenant quota and a
    tenant only fills and evicts inside its own partition."""
    return TenantCacheTier(ctx.cache_lines, ctx.cache_ways,
                           tenants=ctx.tenants, quotas=ctx.tenant_quotas,
                           seed=ctx.seed, features=ctx.features,
                           device=ctx.device)


@register_tier_kind("kv_slots")
def _make_kv_slots(ctx: BuildContext, slots=None, bytes_per_slot=None) -> Tier:
    slots = ctx.slots if slots is None else slots
    bytes_per_slot = (ctx.bytes_per_slot if bytes_per_slot is None
                      else bytes_per_slot)
    return KVSlotTier(slots, bytes_per_slot)


_PRESETS: dict[str, "DataPlaneSpec"] = {}


@dataclasses.dataclass(frozen=True)
class DataPlaneSpec:
    """Declarative description of a data plane.

    pricing:   "overlapped" — storage requests overlap under the
                              accumulator's outstanding count (GIDS/BaM)
               "page_fault" — serial fault handling (the mmap baseline)
    lookahead: sampling runs ahead of training under accumulator control;
               False degenerates to synchronous depth-1 sampling.
    prefetch:  batches the `PrefetchEngine` (core/prefetch.py) stages ahead
               of consumption; 0 = synchronous execute-on-demand.  A
               prefetching plane prices *exposed* prep time: the part of
               the modelled prep that the previous batch's compute did not
               hide.
    merge_execute: execute whole merged windows instead of single batches
               (`GIDSDataLoader.execute_window`): the window's requests are
               deduplicated, the tier stack folds once over the unique set,
               storage rows sharing a 4 KB line coalesce, and the window is
               priced as one burst amortized per batch.  Requires
               "overlapped" pricing.
    topology:  sampling runs against a `TieredTopologyStore`: every hop's
               edge-page reads are priced and `Batch.prep_time_s` includes
               the modelled sampling time.  Blocks and features stay
               bit-identical.
    """

    name: str
    tiers: tuple[TierSpec, ...]
    pricing: str = "overlapped"
    lookahead: bool = True
    prefetch: int = 0
    merge_execute: bool = False
    topology: bool = False
    description: str = ""

    def __post_init__(self) -> None:
        if self.merge_execute and self.pricing != "overlapped":
            raise ValueError(
                f"spec {self.name!r}: merge_execute requires 'overlapped' "
                f"pricing (got {self.pricing!r}) — a serially-faulting "
                "plane has no merged burst to price")

    def with_(self, **overrides) -> "DataPlaneSpec":
        return dataclasses.replace(self, **overrides)

    def build_stack(self, ctx: BuildContext | None = None,
                    **ctx_kwargs) -> list[Tier]:
        """Resolve the TierSpecs into live tiers (None results omitted)."""
        ctx = ctx or BuildContext(**ctx_kwargs)
        out = []
        for ts in self.tiers:
            try:
                factory = _TIER_KINDS[ts.kind]
            except KeyError:
                raise KeyError(
                    f"unknown tier kind {ts.kind!r}; registered: "
                    f"{sorted(_TIER_KINDS)}") from None
            t = factory(ctx, **dict(ts.params))
            if t is not None:
                out.append(t)
        return out

    def build(self, graph=None, features=None, config=None,
              **overrides) -> "DataPlane":
        ctx = BuildContext(graph=graph, features=features).absorb(config)
        valid = {f.name for f in dataclasses.fields(BuildContext)}
        for k, v in overrides.items():
            if k not in valid:
                raise TypeError(f"unknown build override {k!r}; "
                                f"valid knobs: {sorted(valid)}")
            setattr(ctx, k, v)
        return DataPlane(spec=self,
                         store=TieredFeatureStore(self.build_stack(ctx),
                                                  device=ctx.device))

    @staticmethod
    def preset(name: str, **overrides) -> "DataPlaneSpec":
        try:
            spec = _PRESETS[name]
        except KeyError:
            raise KeyError(f"unknown data-plane preset {name!r}; "
                           f"available: {DataPlaneSpec.names()}") from None
        return spec.with_(**overrides) if overrides else spec

    @staticmethod
    def register(spec: "DataPlaneSpec",
                 overwrite: bool = False) -> "DataPlaneSpec":
        if spec.name in _PRESETS and not overwrite:
            raise ValueError(f"preset {spec.name!r} already registered")
        _PRESETS[spec.name] = spec
        return spec

    @staticmethod
    def names() -> tuple[str, ...]:
        return tuple(sorted(_PRESETS))

    @staticmethod
    def resolve(obj: "DataPlaneSpec | str") -> "DataPlaneSpec":
        if isinstance(obj, DataPlaneSpec):
            return obj
        if isinstance(obj, str):
            return DataPlaneSpec.preset(obj)
        raise TypeError(f"expected DataPlaneSpec or preset name, got {obj!r}")


@dataclasses.dataclass
class DataPlane:
    """A built data plane: the tier stack plus the policies the loader
    reads."""

    spec: DataPlaneSpec
    store: TieredFeatureStore

    @property
    def pricing(self) -> str:
        return self.spec.pricing

    @property
    def lookahead(self) -> bool:
        return self.spec.lookahead

    @property
    def min_lookahead(self) -> int:
        """Lookahead floor: a windowed tier needs its window kept full."""
        wt = self.store.windowed_tier
        return max(1, wt.window_depth if wt is not None else 1)

    @property
    def prefetch_depth(self) -> int:
        return self.spec.prefetch

    @property
    def merge_execute(self) -> bool:
        return self.spec.merge_execute

    @property
    def topology(self) -> bool:
        return self.spec.topology

    def price(self, timeline: StorageTimeline, report,
              outstanding: int) -> float:
        return timeline.price_batch(report, outstanding=outstanding,
                                    policy=self.spec.pricing)

    def exposed_prep(self, timeline: StorageTimeline, prep_s: float,
                     compute_s: float) -> float:
        """Critical-path prep time the consumer waits for.  Only a
        prefetching plane overlaps prep with the previous batch's compute;
        a synchronous plane exposes the full modelled prep."""
        if self.prefetch_depth > 0:
            return timeline.price_batch_overlapped(prep_s, compute_s)
        return prep_s

    def reset(self) -> None:
        self.store.reset()


DataPlaneSpec.register(DataPlaneSpec(
    name="gids",
    tiers=(tier("window_cache"), tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True,
    description="Paper §3: window-buffered cache + constant pinned-host "
                "buffer + GPU-initiated direct storage, accumulator-merged; "
                "the cache's metadata on the host, its rows on the GPU."))

DataPlaneSpec.register(DataPlaneSpec(
    name="bam",
    tiers=(tier("window_cache", window_depth=0), tier("storage")),
    pricing="overlapped", lookahead=True,
    description="BaM baseline: random-eviction GPU cache over direct "
                "storage; no window buffering, no host buffer."))

DataPlaneSpec.register(DataPlaneSpec(
    name="mmap",
    tiers=(tier("storage"),),
    pricing="page_fault", lookahead=False,
    description="DGL-mmap baseline: synchronous sampling, page-fault-priced "
                "storage, no redirection tiers."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-async",
    tiers=(tier("window_cache"), tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True, prefetch=2,
    description="GIDS with the two-stage prefetch engine: batch k+1's "
                "gather/staging executes while batch k trains, so only "
                "prep time in excess of the compute time is exposed "
                "(§3.2 decoupling, Fig. 13 overlap)."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-merged",
    tiers=(tier("window_cache"), tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True, merge_execute=True,
    description="GIDS with the accumulator's merge executed: the staged "
                "lookahead window is deduplicated across batches, each "
                "unique row gathered once, 4 KB-line-sharing storage rows "
                "coalesced into single IOs, and the window priced as one "
                "burst amortized per batch (§3.2)."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-merged-async",
    tiers=(tier("window_cache"), tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True, prefetch=2, merge_execute=True,
    description="Merged-window execution combined with the prefetch "
                "engine: whole deduplicated windows are staged ahead of "
                "consumption and each batch's amortized burst share is "
                "discounted by the compute it overlapped."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-sharded",
    tiers=(tier("window_cache"), tier("constant_buffer"),
           tier("sharded_storage")),
    pricing="overlapped", lookahead=True,
    description="GIDS over a storage namespace partitioned across n_shards "
                "SSD queues (BuildContext.n_shards / LoaderConfig.n_shards; "
                "placement policy from core/sharding.py): each shard drains "
                "its own queue at its own spec and the batch completes at "
                "the slowest shard (§4.2 multi-SSD scaling, per-queue)."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-merged-sharded",
    tiers=(tier("window_cache"), tier("constant_buffer"),
           tier("sharded_storage")),
    pricing="overlapped", lookahead=True, merge_execute=True,
    description="Merged-window execution over the sharded namespace: the "
                "deduplicated window's storage rows split per shard, 4 KB-"
                "line coalescing is shard-local ((shard, line) keys), and "
                "the window prices as per-shard bursts completing at the "
                "max over shards (straggler telemetry included)."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-hosts",
    tiers=(tier("window_cache"), tier("constant_buffer"),
           tier("host_storage")),
    pricing="overlapped", lookahead=True,
    description="GIDS over a multi-host cluster (BuildContext.n_hosts; "
                "core/hosts.py): each shard is a host with its own link + "
                "local SSD, one co-partitioned placement decision drives "
                "features and CSR edge pages, and rows requested across "
                "hosts pay the serving host's link transit on top of its "
                "local drain (max-over-hosts completion)."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-hosts-merged",
    tiers=(tier("window_cache"), tier("constant_buffer"),
           tier("host_storage")),
    pricing="overlapped", lookahead=True, merge_execute=True,
    description="Merged-window execution over the host cluster: two-level "
                "coalescing — the window dedups per host ((shard, line) "
                "keys), then each host's remote lines ship 4 KB-granular "
                "over its link — priced as per-host bursts completing at "
                "the max over hosts.  n_hosts=1 is bit-identical to "
                "gids-merged."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-topo",
    tiers=(tier("window_cache"), tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True, topology=True,
    description="GIDS with the topology plane: sampling reads a tiered "
                "adjacency store (GPU hot pages + pinned host + storage-"
                "backed CSR pages, degree-aware admission) and is priced: "
                "exposed prep covers sampling and gather (Fig. 7)."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-topo-merged",
    tiers=(tier("window_cache"), tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True, merge_execute=True, topology=True,
    description="Topology-tiered sampling composed with merged-window "
                "execution: each batch's priced sampling time rides on top "
                "of its amortized share of the window's coalesced feature "
                "burst."))

DataPlaneSpec.register(DataPlaneSpec(
    name="pinned-host",
    tiers=(tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True,
    description="PyTorch-Direct-style zero-copy plane: pinned-host hot set "
                "over direct storage, no device cache."))

DataPlaneSpec.register(DataPlaneSpec(
    name="gids-device",
    tiers=(tier("device_store"), tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True,
    description="GIDS with the device-resident cache: metadata and row "
                "store on the GPU, the cache access and tiered gather as "
                "CUDA kernels, in front of the constant pinned-host buffer "
                "and direct storage."))

DataPlaneSpec.register(DataPlaneSpec(
    name="serve-gnn",
    tiers=(tier("tenant_cache"), tier("constant_buffer", fraction=0.05),
           tier("storage")),
    pricing="overlapped", lookahead=False,
    description="Online GNN inference plane: per-tenant partitioned device "
                "cache (quota-bounded eviction: a noisy tenant cannot "
                "evict another tenant's hot set) over a small pinned-host "
                "hot set and direct storage.  No epoch lookahead; request "
                "windows are deadline-bounded by the serve engine."))

DataPlaneSpec.register(DataPlaneSpec(
    name="serve-gnn-shared",
    tiers=(tier("window_cache", window_depth=0),
           tier("constant_buffer", fraction=0.05), tier("storage")),
    pricing="overlapped", lookahead=False,
    description="The serve plane without tenant isolation: one shared "
                "random-eviction cache all tenants contend for, the "
                "noisy-neighbour baseline."))

DataPlaneSpec.register(DataPlaneSpec(
    name="serve-kv",
    tiers=(tier("kv_slots"),),
    pricing="overlapped", lookahead=False,
    description="Serve engine's KV-cache slot pool as a single-tier plane "
                "(no storage backstop — requests queue when it is full)."))
