"""GIDSDataLoader, the port's subset of `repro.core.pipeline`: the
two-stage pipeline for the neighbor sampler.

  stage 1, `plan_next()` — sampling runs ahead under the accumulator's
    merge depth, future node lists are pushed into the windowed tier
    (`admit()`), the next batch's blocks are popped, and the sampler RNG
    state before them is kept as the batch's resume snapshot.
  stage 2, `execute(plan)` — the tier stack folds over the batch's nodes,
    the feature rows are gathered, and the batch is priced from its tier
    split.

`next_batch()` composes the stages.  On a prefetching plane (`prefetch >
0`, e.g. `gids-async`) a `PrefetchEngine` has already staged the next
batches, and `next_batch(compute_s=...)` prices the batch's exposed prep
against the model compute it overlapped (`max(0, prep - compute)`); every
other `Batch` field equals the synchronous plane's bit for bit.

On a merged plane (`DataPlaneSpec.merge_execute`) stage 2 runs over a whole
window of plans (`plan_window()` / `execute_window()`): the window's
request lists are deduplicated into a `MergedWindow`, the tier stack folds
once over the unique set, each unique row is staged once and expanded per
batch on the device, and the window is priced as one line-coalesced burst
amortized across its batches.  On a topology plane
(`DataPlaneSpec.topology`) sampling runs against a `TieredTopologyStore`
and each batch's priced sampling time rides on its `prep_time_s`.

The sampler is the neighbour sampler, LADIES or, over a `HeteroGraph`,
the relational sampler (`LoaderConfig.sampler`): typed nodes, per-relation
draws, deduplicated blocks (`sampling/relational.py`).  A typed graph's
`union()` is what the data plane reads; everything after sampling runs on
the blocks' `all_nodes` over one feature table, as for the other samplers.
`state_dict()` / `load_state_dict()` capture and restore the resume point
(the sampler state before the oldest batch not yet consumed), so a
checkpointed run resumes with the same batches; the state is the
reference's, key for key, and loads into either package's loader.

On a sharded plane (`gids-sharded`, `gids-merged-sharded`) the storage
backstop is a `ShardedStorageTier`: the feature namespace is partitioned
across `LoaderConfig.n_shards` queues by a registered placement policy,
every storage-bound request carries its shard id through the `GatherPlan`,
and pricing completes each burst at the max over per-shard drains.  On a
cluster plane (`gids-hosts`, `gids-hosts-merged`) each shard is a host
with a link, one co-partitioned placement decision drives the feature rows
and the CSR edge pages, and rows requested across hosts pay the serving
host's link.  An adaptive placement or topology admission gets its
feedback controller (core/feedback.py), a `FaultSchedule` its injectors
(core/faults.py), and replication a failover router.  Shards, hosts,
faults and feedback change pricing, routing and telemetry, never bytes.

The features of a `Batch` are a tensor on the loader's device; reports and
priced floats stay host-side Python and numpy, bit-identical to the
reference.  A `tracer` (repro_torch.obs) observes the loader: it
wall-clocks the `plan_next`, `execute` and `execute_window` stages, builds
one priced span tree per batch and window (with per-shard and fault
overlays), and receives burst, hop, tier and controller telemetry in its
metrics registry.  Inside those stages it gets the port's own wall spans
of the hot path, category `HOT_PATH`, each under the parent
`HOT_PATH_SPANS` names: the loader hands the tracer to its store and to
every tier that takes one.  Tracing never feeds back: every priced float,
block and feature row is the same with the default no-op tracer.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.hetero import HeteroGraph
from repro_torch.obs import HOT_PATH, NULL_TRACER, attach_burst_spans
from repro_torch.sampling.ladies import ladies_sample_blocks
from repro_torch.sampling.neighbor import SampledBlocks, host_sample_blocks
from repro_torch.sampling.relational import relational_sample_blocks
from repro_torch.sampling.tiered import tiered_sample_blocks
from .accumulator import AccumulatorConfig, DynamicAccessAccumulator
from .dataplane import DataPlane, DataPlaneSpec
from .faults import FailoverRouter, FaultInjector
from .feature_store import GatherReport
from .feedback import ShardHealthMonitor, ShardRebalancer, TopologyRefresher
from .prefetch import PrefetchEngine
from .storage_sim import INTEL_OPTANE, SSDSpec, StorageTimeline
from .tiers import record_tier_metrics
from .topology import TieredTopologyStore

#: Sampler names the loader knows how to drive.  `LoaderConfig` validates
#: at construction: an unknown sampler fails when the config is built, not
#: on the first batch.
SAMPLERS = ("neighbor", "ladies", "relational")

#: The port's hot-path wall spans (category `HOT_PATH`) and the stages they
#: open under.  Host and LADIES sampling (`sample_blocks`; a topology plane
#: records the reference's `sample` stage instead), the relational sampler's
#: draws (`sample_relations`) and its deduplication into blocks
#: (`build_blocks`), a few of each per batch, the window admits, the
#: merge of a window's request lists, the gather (one `probe` per tier the
#: fold offers requests: a device tier's host stages under it) and the
#: reports built from its plan, the pricing with the accumulator's update,
#: and the feedback step.
HOT_PATH_SPANS: dict[str, tuple[str, ...]] = {
    "sample_blocks": ("plan_next",),
    "sample_relations": ("plan_next",),
    "build_blocks": ("plan_next",),
    "admit": ("plan_next", "execute_window"),
    "merge": ("execute_window",),
    "gather": ("execute", "execute_window"),
    "probe": ("gather",),
    "future_counts": ("probe",),      # DeviceStoreTier
    "access": ("probe",),             # the host planes' row-store tiers
    "stage_host": ("probe",),
    "probe_wait": ("probe",),         # DeviceStoreTier
    "report": ("execute", "execute_window"),
    "price": ("execute", "execute_window"),
    "feedback": ("execute", "execute_window"),
}


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 4096
    fanouts: Sequence[int] = (10, 5, 5)       # 3 sampling layers (paper §4.1)
    sampler: str = "neighbor"                  # "ladies"; "relational"
                                               # over a HeteroGraph
    ladies_layer_sizes: Sequence[int] = (512, 512, 512)
    data_plane: DataPlaneSpec | str | None = None  # preset name or spec;
                                                   # None resolves to "gids"
    window_depth: int = 8                      # paper default
    cache_lines: int = 1 << 15
    cache_ways: int = 8
    cbuf_fraction: float = 0.1                 # 10% of dataset (paper default)
    cbuf_selection: str = "pagerank"
    target_efficiency: float = 0.95
    n_ssd: int = 1
    # sharded-storage planes (gids-sharded / gids-merged-sharded): how many
    # SSD shards partition the feature namespace, and which registered
    # placement policy (core/sharding.py) decides node -> shard
    n_shards: int = 1
    placement: str = "hash"
    # multi-host planes (gids-hosts / gids-hosts-merged; core/hosts.py):
    # the storage backstop partitions across n_hosts hosts, each with its
    # own link and local SSD.  co_partition=True drives a node's feature
    # rows AND its CSR edge pages off one placement decision; False
    # stripes the adjacency independently.  Every host has the default
    # 100GbE link
    n_hosts: int = 1
    co_partition: bool = True
    # topology plane: fraction of the CSR edge pages resident in device
    # memory / pinned host memory (the rest is storage-backed), and the
    # admission policy ranking pages into the budgets (core/topology.py)
    topo_admission: str = "degree"
    topo_gpu_fraction: float = 0.25
    topo_host_fraction: float = 0.5
    # adaptive data plane (core/feedback.py; placement="adaptive" and/or
    # topo_admission="adaptive"): every `rebalance_interval` priced bursts
    # the controllers fold measured touches and consider a re-placement,
    # committing only when the modelled saving over `migration_horizon`
    # future bursts beats the move's own priced IO cost, which is then
    # amortized into later batches' prep
    rebalance_interval: int = 8
    imbalance_threshold: float = 1.25
    migration_horizon: int = 64
    # fault plane (core/faults.py): a seeded FaultSchedule injected into
    # every priced storage burst; None prices bit-identically to the
    # fault-free plane.  replication_factor wraps the placement in k-way
    # ReplicatedPlacement so failover and hedges have replica queues
    fault_schedule: "object | None" = None
    replication_factor: int = 1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.sampler not in SAMPLERS:
            raise ValueError(
                f"unknown sampler {self.sampler!r}; known samplers: "
                f"{SAMPLERS}")
        if self.data_plane is None:
            self.data_plane = "gids"


@dataclasses.dataclass
class BatchPlan:
    """Stage-1 output: the blocks to gather, the merge depth, and the
    resume point: `snapshot` is the sampler state before this batch was
    sampled."""

    blocks: SampledBlocks
    merge_depth: int
    snapshot: dict


@dataclasses.dataclass
class Batch:
    blocks: SampledBlocks
    features: torch.Tensor        # rows for blocks.all_nodes, on the device
    report: GatherReport
    prep_time_s: float            # modelled data-preparation time; on a
                                  # topology plane it includes sampling
    merge_depth: int
    # modelled sampling time folded into prep_time_s (0 without topology)
    sample_time_s: float = 0.0
    # critical-path prep; a synchronous plane exposes everything
    exposed_prep_s: float | None = None

    def __post_init__(self) -> None:
        if self.exposed_prep_s is None:
            self.exposed_prep_s = self.prep_time_s


class GIDSDataLoader:
    def __init__(self, graph: CSRGraph | HeteroGraph, features: np.ndarray,
                 config: LoaderConfig | None = None,
                 ssd: SSDSpec = INTEL_OPTANE,
                 train_ids: np.ndarray | None = None,
                 device: str | torch.device = "cuda", tracer=None):
        self.config = cfg = config or LoaderConfig()
        # the relational sampler draws from the typed graph; the data plane
        # and every other stage read its union
        self.hgraph: HeteroGraph | None = None
        if isinstance(graph, HeteroGraph):
            self.hgraph, graph = graph, graph.union()
        if (cfg.sampler == "relational") != (self.hgraph is not None):
            raise ValueError(
                f"sampler {cfg.sampler!r} with a "
                f"{type(self.hgraph or graph).__name__}: the 'relational' "
                "sampler takes a HeteroGraph, and a HeteroGraph only it")
        self.graph = graph
        self.rng = np.random.default_rng(cfg.seed)
        self.train_ids = (train_ids if train_ids is not None
                          else np.arange(graph.num_nodes))
        self.spec = DataPlaneSpec.resolve(cfg.data_plane)
        self.plane: DataPlane = self.spec.build(graph, features, config=cfg,
                                                device=device)
        self.store = self.plane.store
        self.accumulator = DynamicAccessAccumulator(
            ssd, AccumulatorConfig(target_efficiency=cfg.target_efficiency,
                                   n_ssd=cfg.n_ssd,
                                   max_merge_iters=max(cfg.window_depth, 8)))
        self.timeline = StorageTimeline(ssd, cfg.n_ssd)
        # a sharded backstop prices per shard queue: hand the timeline the
        # per-shard device specs (a spec-less tier inherits this loader's
        # device on every shard)
        backstop = self.store.tiers[-1]
        if hasattr(backstop, "resolve_shard_specs"):
            if getattr(backstop, "n_shards", 1) > 1 and cfg.n_ssd > 1:
                raise ValueError(
                    f"n_ssd={cfg.n_ssd} with a {backstop.n_shards}-shard "
                    "storage tier: the legacy pooled-queue multiplier and "
                    "per-shard queues model the same devices twice — on a "
                    "sharded plane set n_shards (one queue per SSD) and "
                    "leave n_ssd=1")
            self.timeline.shard_specs = backstop.resolve_shard_specs(ssd)
        # a cluster backstop (core/hosts.py) also needs each host's link:
        # sharded bursts then price through price_host_burst
        if hasattr(backstop, "resolve_hosts"):
            self.timeline.host_specs = backstop.resolve_hosts(ssd)
        # topology plane: sampling reads a tiered adjacency store and is
        # priced per hop; the store owns its own StorageTimeline (the
        # edge-page namespace drains separate queues)
        self.topo: TieredTopologyStore | None = None
        if self.plane.topology:
            if cfg.sampler != "neighbor":
                raise ValueError(
                    f"topology plane {self.spec.name!r} requires the "
                    f"'neighbor' sampler (got {cfg.sampler!r}): LADIES "
                    "scores whole frontier columns, not page-local "
                    "adjacency reads, so its storage traffic is not "
                    "page-priceable")
            if hasattr(backstop, "topology_page_shard") \
                    and backstop.n_shards > 1:
                # co-partitioned cluster: the feature backstop's own host
                # table places the CSR edge pages, one placement decision
                # for both namespaces
                topo_kwargs = dict(
                    n_shards=backstop.n_shards,
                    page_shard=backstop.topology_page_shard(),
                    shard_specs=backstop.resolve_shard_specs(ssd))
            else:
                topo_kwargs = dict(n_shards=cfg.n_shards,
                                   placement=cfg.placement)
            self.topo = TieredTopologyStore.from_graph(
                graph, admission=cfg.topo_admission,
                gpu_fraction=cfg.topo_gpu_fraction,
                host_fraction=cfg.topo_host_fraction,
                ssd=ssd, n_ssd=cfg.n_ssd, seed=cfg.seed, device=device,
                **topo_kwargs)
        # adaptive data plane: an adaptive placement or admission gets its
        # feedback controller; both tick once per priced burst in
        # _feedback_step, and a static plane carries None
        self.rebalancer: ShardRebalancer | None = None
        if hasattr(getattr(backstop, "placement", None), "plan_rebalance"):
            self.rebalancer = ShardRebalancer(
                backstop, self.timeline,
                bytes_per_row=features.shape[1] * features.dtype.itemsize,
                interval=cfg.rebalance_interval,
                threshold=cfg.imbalance_threshold,
                horizon=cfg.migration_horizon)
        self.topo_refresher: TopologyRefresher | None = None
        if self.topo is not None and self.topo.touches is not None:
            self.topo_refresher = TopologyRefresher(
                self.topo, interval=cfg.rebalance_interval,
                horizon=cfg.migration_horizon)
        # fault plane: schedule-driven burst re-pricing, per-shard health
        # telemetry and replica failover routing; all None on a fault-free,
        # unreplicated plane, which keeps every other preset bit-identical
        self.fault_injector: FaultInjector | None = None
        self.health: ShardHealthMonitor | None = None
        n_queue_shards = getattr(backstop, "n_shards", 1)
        if cfg.replication_factor > 1 \
                and not hasattr(backstop, "placement"):
            raise ValueError(
                f"replication_factor={cfg.replication_factor} needs a "
                "sharded storage backstop (a *-sharded data plane with "
                "n_shards >= 2) — the unsharded plane has no replica "
                "queues to fail over to")
        if cfg.fault_schedule is not None:
            self.fault_injector = FaultInjector(
                cfg.fault_schedule, n_queue_shards,
                replication=cfg.replication_factor)
            self.timeline.injector = self.fault_injector
            if self.topo is not None:
                # the topology namespace drains its own queues, so it gets
                # its own injector (an independent burst counter) over the
                # same schedule
                self.topo.timeline.injector = FaultInjector(
                    cfg.fault_schedule, self.topo.n_shards)
        if n_queue_shards > 1 and (cfg.fault_schedule is not None
                                   or cfg.replication_factor > 1):
            self.health = ShardHealthMonitor(n_queue_shards)
            if self.rebalancer is not None:
                self.rebalancer.monitor = self.health
        if cfg.replication_factor > 1:
            backstop.router = FailoverRouter(
                backstop.placement, monitor=self.health,
                injector=self.fault_injector)
        self._lookahead: deque[tuple[dict, SampledBlocks]] = deque()
        self._win_idx = 0   # lookahead entries already pushed to the window
        # a merged plane stages a whole executed window here, each batch
        # with its resume snapshot
        self._merged_ready: deque[tuple[dict, Batch]] = deque()
        self._requests_per_iter = 0
        self.prefetch = (PrefetchEngine(self, self.plane.prefetch_depth)
                         if self.plane.prefetch_depth > 0 else None)
        # observability plane: off by default through the shared no-op
        # tracer.  An enabled tracer observes stage timings, builds per-batch
        # span trees and receives burst and controller telemetry in its
        # registry, but never feeds back into sampling or pricing
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._batch_index = 0
        self._window_index = 0
        if self.tracer.enabled:
            self.store.use_tracer(self.tracer)
            self.timeline.metrics = self.tracer.metrics
            if self.topo is not None:
                self.topo.timeline.metrics = self.tracer.metrics
            if self.rebalancer is not None:
                self.rebalancer.tracer = self.tracer
            if self.topo_refresher is not None:
                self.topo_refresher.tracer = self.tracer
            if hasattr(backstop, "record_metrics"):
                # static cluster telemetry, computed once: it changes only
                # with a commit
                backstop.record_metrics(self.tracer.metrics)

    def _sample_one(self) -> SampledBlocks:
        cfg = self.config
        seeds = self.rng.choice(self.train_ids, size=cfg.batch_size,
                                replace=len(self.train_ids) < cfg.batch_size)
        if cfg.sampler == "relational":
            # its own stages, `sample_relations` and `build_blocks`
            blocks = relational_sample_blocks(self.hgraph, seeds,
                                              cfg.fanouts, self.rng,
                                              tracer=self.tracer)
            m = self.tracer.metrics
            m.counter("relational.slots").inc(blocks.num_slots)
            m.counter("relational.masked_slots").inc(blocks.num_masked)
            for k, level in enumerate(blocks.levels):
                m.counter(f"relational.level_rows.{k}").inc(len(level))
            return blocks
        if cfg.sampler == "neighbor" and self.topo is not None:
            # same math, same RNG stream: blocks bit-identical to the host
            # sampler, plus per-hop priced TopologyGatherReports
            return tiered_sample_blocks(self.graph, self.topo, seeds,
                                        cfg.fanouts, self.rng,
                                        tracer=self.tracer)
        with self.tracer.stage("sample_blocks", cat=HOT_PATH,
                               seeds=len(seeds)):
            if cfg.sampler == "neighbor":
                return host_sample_blocks(self.graph, seeds, cfg.fanouts,
                                          self.rng)
            if cfg.sampler == "ladies":
                # LADIES reads the host CSR (a topology plane refuses it at
                # construction, as the reference does)
                return ladies_sample_blocks(self.graph, seeds,
                                            cfg.ladies_layer_sizes, self.rng)
        raise ValueError(cfg.sampler)

    def _refill_lookahead(self) -> int:
        """Run sampling ahead until the accumulator's merge depth is
        covered; a windowed tier floors the depth at its window size.  A
        merged plane samples one cache-window PAST the merge window, so
        the merged access can pin its fills by the next window's reuse."""
        if not self.plane.lookahead:
            depth = 1
        else:
            depth = self.accumulator.merge_depth(
                max(self._requests_per_iter, 1))
            depth = max(depth, self.plane.min_lookahead)
        sample_ahead = depth
        if self.plane.merge_execute:
            sample_ahead = depth + self.plane.min_lookahead
        while len(self._lookahead) < sample_ahead:
            # the sampler state before the batch: its resume point
            snap = {"rng": self.rng.bit_generator.state,
                    "requests_per_iter": self._requests_per_iter}
            self._lookahead.append((snap, self._sample_one()))
        self._sync_window()
        return depth

    def _sync_window(self) -> None:
        """Keep the windowed tier's look-ahead = first `window_depth`
        lookahead entries."""
        wt = self.store.windowed_tier
        if wt is None or wt.window_depth == 0:
            return
        while (len(wt.window) < wt.window_depth
               and self._win_idx < len(self._lookahead)):
            nodes = self._lookahead[self._win_idx][1].all_nodes
            with self.tracer.stage("admit", cat=HOT_PATH, rows=len(nodes)):
                self.store.push_window(nodes)
            self._win_idx += 1

    def plan_next(self) -> BatchPlan:
        """Stage 1: sampling + admit-side staging."""
        with self.tracer.stage("plan_next") as sp:
            depth = self._refill_lookahead()
            snap, blocks = self._lookahead.popleft()
            self._win_idx = max(0, self._win_idx - 1)
            self._requests_per_iter = blocks.num_requests
            sp.modelled(float(getattr(blocks, "sample_time_s", 0.0)))
        return BatchPlan(blocks=blocks, merge_depth=depth, snapshot=snap)

    def execute(self, plan: BatchPlan) -> Batch:
        """Stage 2: data movement + pricing."""
        blocks = plan.blocks
        tr = self.tracer
        with tr.stage("execute") as sp:
            rows, report = self.store.gather(blocks.all_nodes)
            with tr.stage("price", cat=HOT_PATH):
                self.accumulator.update(report.n_requests, report.redirected)
                outstanding = self.accumulator.outstanding(
                    blocks.num_requests)
                prev_burst = self.timeline.shard_burst
                gather_s = self.plane.price(self.timeline, report,
                                            outstanding)
            with tr.stage("feedback", cat=HOT_PATH):
                charge = self._feedback_step(blocks.all_nodes, None)
            t = gather_s + charge
            # a topology plane priced the sampling stage when the blocks
            # were drawn (plan_next); prep covers both
            sample_s = float(getattr(blocks, "sample_time_s", 0.0))
            sp.modelled(t + sample_s)
            if self.tracer.enabled:
                self._trace_batch(blocks, report, gather_s, charge,
                                  t + sample_s, prev_burst)
        return Batch(blocks=blocks, features=rows, report=report,
                     prep_time_s=t + sample_s,
                     merge_depth=plan.merge_depth, sample_time_s=sample_s)

    def _feedback_step(self, node_ids: np.ndarray,
                       counts: np.ndarray | None) -> float:
        """One adaptive-plane tick per priced burst: record the burst's
        measured node touches, let each controller consider a (priced)
        re-placement, and return the burst's amortized share of any
        committed migration cost, folded into prep.  A static plane returns
        0.0 without touching a thing."""
        charge = 0.0
        if self.health is not None \
                and self.timeline.shard_burst is not None:
            # the monitor sees every priced burst's per-shard drains
            self.health.observe(self.timeline.shard_burst)
        if self.rebalancer is not None:
            self.rebalancer.observe(node_ids, counts)
            charge += self.rebalancer.step()
        if self.topo_refresher is not None:
            charge += self.topo_refresher.step()
        return charge

    # -- span trees (enabled tracer only) ---------------------------------------
    def _trace_hops(self, root, blocks) -> None:
        for r in getattr(blocks, "hop_reports", ()):
            hbm, host, sto = r.pages_by_tier
            root.child(f"sample/hop{r.hop}", float(r.time_s), cat="sample",
                       edge_reads=r.n_edge_reads, frontier=r.n_frontier,
                       pages_hbm=hbm, pages_host=host, pages_storage=sto)

    def _trace_batch(self, blocks, report, gather_s: float, charge: float,
                     prep_s: float, prev_burst) -> None:
        """One per-batch span tree: the root's duration is exactly
        `Batch.prep_time_s`, and its sequential children partition it into
        the per-hop sampling, the priced gather and any feedback charge;
        per-shard and per-host drains (and fault recovery sub-events)
        overlay the gather span on their own tracks."""
        tr = self.tracer
        root = tr.batch("batch", track="pipeline", index=self._batch_index,
                        requests=report.n_requests)
        self._trace_hops(root, blocks)
        g = root.child("gather", float(gather_s), cat="gather",
                       n_storage=report.n_storage,
                       n_host=report.n_host_hits, n_hbm=report.n_hbm_hits)
        burst = self.timeline.shard_burst
        if burst is not None and burst is not prev_burst:
            attach_burst_spans(g, burst)
        if charge:
            root.child("feedback", float(charge), cat="feedback")
        root.close(float(prep_s))
        self._record_batch_metrics(blocks, gather_s, charge, prep_s)
        self._batch_index += 1

    def _trace_window(self, plans, window_report, gather_s: float,
                      charge: float, burst_s: float, prev_burst) -> None:
        """A merged window's spans: one window span (merged gather and
        feedback, on its own track) whose duration is the window's priced
        burst, and one batch tree per plan whose gather child is the
        batch's amortized share of that burst."""
        tr = self.tracer
        win = tr.batch("window", track="window", cat="window",
                       index=self._window_index, batches=len(plans),
                       requests=window_report.window_requests,
                       unique=window_report.n_unique)
        g = win.child("merged_gather", float(gather_s), cat="gather",
                      n_storage=window_report.n_storage,
                      n_lines=window_report.n_storage_lines,
                      n_host=window_report.n_host_hits,
                      n_hbm=window_report.n_hbm_hits)
        burst = self.timeline.shard_burst
        if burst is not None and burst is not prev_burst:
            attach_burst_spans(g, burst)
        if charge:
            win.child("feedback", float(charge), cat="feedback")
        win.close(float(burst_s))
        m = tr.metrics
        if window_report.n_unique:
            m.histogram("merged.dedup_factor").observe(
                window_report.window_requests / window_report.n_unique)
        if window_report.n_storage_lines:
            m.histogram("merged.coalesce_factor").observe(
                window_report.n_storage_unique
                / window_report.n_storage_lines)
        prep = burst_s / len(plans)
        for p in plans:
            sample_s = float(getattr(p.blocks, "sample_time_s", 0.0))
            root = tr.batch("batch", track="pipeline",
                            index=self._batch_index,
                            window=self._window_index)
            self._trace_hops(root, p.blocks)
            root.child("gather_share", float(prep), cat="gather",
                       window=self._window_index)
            root.close(float(prep + sample_s))
            self._record_batch_metrics(p.blocks, prep, 0.0, prep + sample_s)
            self._batch_index += 1
        self._window_index += 1

    def _record_batch_metrics(self, blocks, gather_s: float, charge: float,
                              prep_s: float) -> None:
        """Fold one batch's per-stage priced seconds and the tier stack's
        cumulative hit telemetry into the registry."""
        m = self.tracer.metrics
        m.counter("pipeline.batches").inc()
        m.counter("stage_s.sample").inc(
            float(getattr(blocks, "sample_time_s", 0.0)))
        m.counter("stage_s.gather").inc(float(gather_s))
        m.counter("stage_s.feedback").inc(float(charge))
        m.counter("stage_s.prep").inc(float(prep_s))
        record_tier_metrics(self.store.tiers, m)

    def plan_window(self) -> list[BatchPlan]:
        """Stage 1 for a whole merged window: plan `merge_depth`
        consecutive batches (the depth the first plan reports)."""
        plans = [self.plan_next()]
        if self.plane.merge_execute:
            while len(plans) < plans[0].merge_depth:
                plans.append(self.plan_next())
        return plans

    def execute_window(self, plans: Sequence[BatchPlan]) -> list[Batch]:
        """Stage 2 for a merged window: dedupe the plans' request lists into
        one `MergedWindow`, fold the tier stack once over the unique set,
        stage each unique row once and expand it per batch on the device,
        and price the window as one line-coalesced storage burst amortized
        equally across its batches."""
        tr = self.tracer
        with tr.stage("execute_window", n_plans=len(plans)) as sp:
            with tr.stage("merge", cat=HOT_PATH, batches=len(plans)):
                merged = self.accumulator.merge(
                    [p.blocks.all_nodes for p in plans])
            # retire the consumed window entries and stage the NEXT
            # window's: the one merged access pins its fills by the
            # upcoming reuse
            self.store.retire_window(len(plans))
            self._sync_window()
            rows_list, reports, window_report = \
                self.store.gather_merged(merged)
            with tr.stage("price", cat=HOT_PATH):
                # one telemetry update per window: the unique split
                self.accumulator.update(window_report.n_requests,
                                        window_report.redirected)
                prev_burst = self.timeline.shard_burst
                gather_s = self.timeline.price_merged_burst(window_report)
            # the window is one priced burst, so it is one feedback tick
            # over the unique request set with its window multiplicity; a
            # migration charge amortizes across the window's batches like
            # the burst
            with tr.stage("feedback", cat=HOT_PATH):
                charge = self._feedback_step(merged.unique_nodes,
                                             merged.batch_multiplicity())
            burst_s = gather_s + charge
            sp.modelled(burst_s)
            if self.tracer.enabled:
                self._trace_window(plans, window_report, gather_s, charge,
                                   burst_s, prev_burst)
            prep = burst_s / len(plans)
            out = []
            for p, rows, rep in zip(plans, rows_list, reports, strict=True):
                # each batch's own priced sampling time rides on its share
                sample_s = float(getattr(p.blocks, "sample_time_s", 0.0))
                out.append(Batch(blocks=p.blocks, features=rows, report=rep,
                                 prep_time_s=prep + sample_s,
                                 merge_depth=len(plans),
                                 sample_time_s=sample_s))
        return out

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next_batch()

    def next_batch(self, compute_s: float = 0.0) -> Batch:
        """Deliver the next batch.  `compute_s` is the model-compute time
        of the iteration this batch's preparation overlapped with; a
        prefetching plane discounts the exposed prep by it, a synchronous
        plane exposes the full prep and ignores it."""
        if self.prefetch is not None:
            return self.prefetch.next(compute_s)
        if self.plane.merge_execute:
            if not self._merged_ready:
                plans = self.plan_window()
                for p, b in zip(plans, self.execute_window(plans),
                                strict=True):
                    self._merged_ready.append((p.snapshot, b))
            return self._merged_ready.popleft()[1]
        return self.execute(self.plan_next())

    # -- state for checkpoint and restart -------------------------------------
    def state_dict(self) -> dict:
        """The resume point: the sampler state before the oldest batch not
        yet consumed (a prefetched batch, then a batch of an executed merged
        window, then a sampled-ahead batch, else the live RNG), with the
        durable tier state (`tier_state`: the sharded backstop's placement)
        and the fault plane's state (`fault_state`: the injectors' burst
        counters and the health monitor).  Equal to the reference's; it is
        JSON-serialisable when it carries neither, whose tables and EMAs are
        numpy arrays."""
        if self.prefetch is not None:
            snap = self.prefetch.oldest_snapshot()
            if snap is not None:
                return self._with_tier_state(dict(snap))
        if self._merged_ready:
            # mid-window: the oldest executed-but-unconsumed batch's snapshot
            return self._with_tier_state(dict(self._merged_ready[0][0]))
        if self._lookahead:
            return self._with_tier_state(dict(self._lookahead[0][0]))
        return self._with_tier_state(
            {"rng": self.rng.bit_generator.state,
             "requests_per_iter": self._requests_per_iter})

    def _with_tier_state(self, state: dict) -> dict:
        """Attach the durable tier state and the fault state to a sampler
        snapshot.  Cache contents rebuild deterministically on resume and
        are deliberately absent.  Both are captured at checkpoint time, not
        when the snapshot's batch was staged, as the reference does."""
        tier_state = self.store.state_dict()
        if tier_state:
            state["tier_state"] = tier_state
        # the injector's burst counter (what retry and hedge decisions are
        # a function of) and the health EMAs must resume, so that a
        # mid-brownout checkpoint replays the same recovery choices
        fault_state = {}
        if self.fault_injector is not None:
            fault_state["injector"] = self.fault_injector.state_dict()
        if self.topo is not None and self.topo.timeline.injector is not None:
            fault_state["topo_injector"] = \
                self.topo.timeline.injector.state_dict()
        if self.health is not None:
            fault_state["monitor"] = self.health.state_dict()
        if fault_state:
            state["fault_state"] = fault_state
        return state

    def load_state_dict(self, state: dict) -> None:
        """Resume from `state_dict()` (of either package): afterwards the
        loader delivers the batches a freshly built loader fed the same
        state would, bit for bit."""
        # reset the tiers first: that waits for the copies still in flight
        # out of the pinned staging buffers, and returns every cache, its
        # row store and its metadata to the built state
        self.plane.reset()
        self.rng.bit_generator.state = state["rng"]
        self._requests_per_iter = state["requests_per_iter"]
        self._lookahead.clear()
        self._win_idx = 0
        # drop the batches staged past the resume point; each owns its rows
        if self.prefetch is not None:
            self.prefetch.reset()
        self._merged_ready.clear()
        if "tier_state" in state:
            self.store.load_state_dict(state["tier_state"])
        fault_state = state.get("fault_state", {})
        if "injector" in fault_state:
            if self.fault_injector is None:
                raise ValueError(
                    "checkpoint carries fault-injector state but this "
                    "plane has no fault_schedule — resume with the same "
                    "LoaderConfig.fault_schedule or recovery decisions "
                    "diverge from the checkpointed run")
            self.fault_injector.load_state_dict(fault_state["injector"])
        elif self.fault_injector is not None:
            self.fault_injector.reset()
        topo_injector = None if self.topo is None \
            else self.topo.timeline.injector
        if "topo_injector" in fault_state:
            if topo_injector is None:
                raise ValueError(
                    "checkpoint carries a topology-plane fault-injector "
                    "state but this plane has none — resume with the same "
                    "fault_schedule on the same topology preset")
            topo_injector.load_state_dict(fault_state["topo_injector"])
        elif topo_injector is not None:
            topo_injector.reset()
        if "monitor" in fault_state:
            if self.health is None:
                raise ValueError(
                    "checkpoint carries shard-health state but this plane "
                    "has no monitor (no fault_schedule / replication)")
            self.health.load_state_dict(fault_state["monitor"])
        elif self.health is not None:
            self.health.reset()
        # and the merge-depth EMA, so the resumed loader makes the fresh
        # loader's decisions, and the timelines' cross-burst telemetry and
        # the tracer's spans and registry, so it never reports the
        # pre-restore run's last burst as its own
        self.accumulator.reset_telemetry()
        self.timeline.reset_telemetry()
        if self.topo is not None:
            self.topo.timeline.reset_telemetry()
        self.tracer.reset()
