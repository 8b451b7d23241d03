"""Declarative data-plane composition, the port's subset of
`repro.core.dataplane`: `DataPlaneSpec`, the tier-kind registry with the
`device_store`, `constant_buffer`, `storage` and `kv_slots` kinds, the
`gids-device` preset with its `merge_execute` and `topology` options, and
the serve engine's `serve-kv` preset.  The other presets wait for their
slices (ROADMAP.md Queue 1); `gids-merged*` and `gids-topo*` need the numpy
`window_cache` tier of the host planes.

    spec = DataPlaneSpec.preset("gids-device", merge_execute=True,
                                topology=True)
    plane = spec.build(graph, features, device="cuda")
    rows, report = plane.store.gather(node_ids)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

from .constant_buffer import ConstantBuffer
from .feature_store import TieredFeatureStore
from .storage_sim import StorageTimeline
from .tiers import (ConstantBufferTier, DeviceStoreTier, KVSlotTier,
                    StorageTier, Tier)


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One tier in a declarative stack: a registered kind plus overrides.
    Params left unset fall back to the BuildContext knobs."""

    kind: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def tier(kind: str, **params) -> TierSpec:
    """Sugar: `tier("device_store", window_depth=0)`."""
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
    # serve engine KV slot pool
    slots: int = 0
    bytes_per_slot: int = 0

    _KNOBS = ("cache_lines", "cache_ways", "window_depth", "cbuf_fraction",
              "cbuf_selection", "seed")

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


@register_tier_kind("kv_slots")
def _make_kv_slots(ctx: BuildContext, slots=None, bytes_per_slot=None) -> Tier:
    slots = ctx.slots if slots is None else slots
    bytes_per_slot = (ctx.bytes_per_slot if bytes_per_slot is None
                      else bytes_per_slot)
    return KVSlotTier(slots, bytes_per_slot)


_PRESETS: dict[str, "DataPlaneSpec"] = {}

#: The reference's other presets, by the ROADMAP.md Queue 1 item that
#: ports them.
_UNPORTED_PRESETS = {
    **dict.fromkeys(("gids", "gids-async", "bam", "mmap", "pinned-host"),
                    "host planes"),
    **dict.fromkeys(("gids-merged", "gids-merged-async", "gids-topo",
                     "gids-topo-merged"),
                    "host planes (their window_cache tier)"),
    **dict.fromkeys(("gids-sharded", "gids-merged-sharded", "gids-hosts",
                     "gids-hosts-merged"),
                    "sharded, host, fault and adaptive planes"),
    **dict.fromkeys(("serve-gnn", "serve-gnn-shared"), "serve"),
}


@dataclasses.dataclass(frozen=True)
class DataPlaneSpec:
    """Declarative description of a data plane.

    pricing:   "overlapped" — storage requests overlap under the
                              accumulator's outstanding count (GIDS/BaM)
               "page_fault" — serial fault handling (the mmap baseline)
    lookahead: sampling runs ahead of training under accumulator control;
               False degenerates to synchronous depth-1 sampling.
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
                         store=TieredFeatureStore(self.build_stack(ctx)))

    @staticmethod
    def preset(name: str, **overrides) -> "DataPlaneSpec":
        if name in _UNPORTED_PRESETS:
            raise NotImplementedError(
                f"data-plane preset {name!r} is not ported yet (ROADMAP.md "
                f"Queue 1: {_UNPORTED_PRESETS[name]}); ported: "
                f"{DataPlaneSpec.names()}")
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
    def merge_execute(self) -> bool:
        return self.spec.merge_execute

    @property
    def topology(self) -> bool:
        return self.spec.topology

    @property
    def min_lookahead(self) -> int:
        """Lookahead floor: a windowed tier needs its window kept full."""
        wt = self.store.windowed_tier
        return max(1, wt.window_depth if wt is not None else 1)

    def price(self, timeline: StorageTimeline, report,
              outstanding: int) -> float:
        return timeline.price_batch(report, outstanding=outstanding,
                                    policy=self.spec.pricing)

    def reset(self) -> None:
        self.store.reset()


DataPlaneSpec.register(DataPlaneSpec(
    name="gids-device",
    tiers=(tier("device_store"), tier("constant_buffer"), tier("storage")),
    pricing="overlapped", lookahead=True,
    description="GIDS with the device-resident cache: metadata and row "
                "store on the GPU, the cache access and tiered gather as "
                "CUDA kernels, in front of the constant pinned-host buffer "
                "and direct storage."))

DataPlaneSpec.register(DataPlaneSpec(
    name="serve-kv",
    tiers=(tier("kv_slots"),),
    pricing="overlapped", lookahead=False,
    description="Serve engine's KV-cache slot pool as a single-tier plane "
                "(no storage backstop — requests queue when it is full)."))
