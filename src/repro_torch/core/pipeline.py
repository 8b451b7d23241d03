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

The sampler is the neighbour sampler or LADIES (`LoaderConfig.sampler`).
`state_dict()` / `load_state_dict()` capture and restore the resume point
(the sampler state before the oldest batch not yet consumed), so a
checkpointed run resumes with the same batches; the state is the
reference's, key for key, and loads into either package's loader.

The features of a `Batch` are a tensor on the loader's device; reports and
priced floats stay host-side Python and numpy, bit-identical to the
reference.  Sharding, hosts, faults, feedback and tracing wait for later
slices (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.sampling.ladies import ladies_sample_blocks
from repro_torch.sampling.neighbor import SampledBlocks, host_sample_blocks
from repro_torch.sampling.tiered import tiered_sample_blocks
from .accumulator import AccumulatorConfig, DynamicAccessAccumulator
from .dataplane import DataPlane, DataPlaneSpec
from .feature_store import GatherReport
from .prefetch import PrefetchEngine
from .storage_sim import INTEL_OPTANE, SSDSpec, StorageTimeline
from .topology import TieredTopologyStore

#: Sampler names the loader knows how to drive.  `LoaderConfig` validates
#: at construction: an unknown sampler fails when the config is built, not
#: on the first batch.
SAMPLERS = ("neighbor", "ladies")


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 4096
    fanouts: Sequence[int] = (10, 5, 5)       # 3 sampling layers (paper §4.1)
    sampler: str = "neighbor"                  # or "ladies"
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
    # topology plane: fraction of the CSR edge pages resident in device
    # memory / pinned host memory (the rest is storage-backed), and the
    # admission policy ranking pages into the budgets (core/topology.py)
    topo_admission: str = "degree"
    topo_gpu_fraction: float = 0.25
    topo_host_fraction: float = 0.5
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
    def __init__(self, graph: CSRGraph, features: np.ndarray,
                 config: LoaderConfig | None = None,
                 ssd: SSDSpec = INTEL_OPTANE,
                 train_ids: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        self.graph = graph
        self.config = cfg = config or LoaderConfig()
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
            self.topo = TieredTopologyStore.from_graph(
                graph, admission=cfg.topo_admission,
                gpu_fraction=cfg.topo_gpu_fraction,
                host_fraction=cfg.topo_host_fraction,
                ssd=ssd, n_ssd=cfg.n_ssd, seed=cfg.seed, device=device)
        self._lookahead: deque[tuple[dict, SampledBlocks]] = deque()
        self._win_idx = 0   # lookahead entries already pushed to the window
        # a merged plane stages a whole executed window here, each batch
        # with its resume snapshot
        self._merged_ready: deque[tuple[dict, Batch]] = deque()
        self._requests_per_iter = 0
        self.prefetch = (PrefetchEngine(self, self.plane.prefetch_depth)
                         if self.plane.prefetch_depth > 0 else None)

    def _sample_one(self) -> SampledBlocks:
        cfg = self.config
        seeds = self.rng.choice(self.train_ids, size=cfg.batch_size,
                                replace=len(self.train_ids) < cfg.batch_size)
        if cfg.sampler == "neighbor":
            if self.topo is not None:
                # same math, same RNG stream: blocks bit-identical to the
                # host sampler, plus per-hop priced TopologyGatherReports
                return tiered_sample_blocks(self.graph, self.topo, seeds,
                                            cfg.fanouts, self.rng)
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
            self.store.push_window(
                self._lookahead[self._win_idx][1].all_nodes)
            self._win_idx += 1

    def plan_next(self) -> BatchPlan:
        """Stage 1: sampling + admit-side staging."""
        depth = self._refill_lookahead()
        snap, blocks = self._lookahead.popleft()
        self._win_idx = max(0, self._win_idx - 1)
        self._requests_per_iter = blocks.num_requests
        return BatchPlan(blocks=blocks, merge_depth=depth, snapshot=snap)

    def execute(self, plan: BatchPlan) -> Batch:
        """Stage 2: data movement + pricing."""
        blocks = plan.blocks
        rows, report = self.store.gather(blocks.all_nodes)
        self.accumulator.update(report.n_requests, report.redirected)
        outstanding = self.accumulator.outstanding(blocks.num_requests)
        gather_s = self.plane.price(self.timeline, report, outstanding)
        # a topology plane priced the sampling stage when the blocks were
        # drawn (plan_next); prep covers both
        sample_s = float(getattr(blocks, "sample_time_s", 0.0))
        return Batch(blocks=blocks, features=rows, report=report,
                     prep_time_s=gather_s + sample_s,
                     merge_depth=plan.merge_depth, sample_time_s=sample_s)

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
        merged = self.accumulator.merge([p.blocks.all_nodes for p in plans])
        # retire the consumed window entries and stage the NEXT window's:
        # the one merged access pins its fills by the upcoming reuse
        self.store.retire_window(len(plans))
        self._sync_window()
        rows_list, reports, window_report = self.store.gather_merged(merged)
        # one telemetry update per window: the unique split
        self.accumulator.update(window_report.n_requests,
                                window_report.redirected)
        burst_s = self.timeline.price_merged_burst(window_report)
        prep = burst_s / len(plans)
        out = []
        for p, rows, rep in zip(plans, rows_list, reports, strict=True):
            # each batch's own priced sampling time rides on its share
            sample_s = float(getattr(p.blocks, "sample_time_s", 0.0))
            out.append(Batch(blocks=p.blocks, features=rows, report=rep,
                             prep_time_s=prep + sample_s,
                             merge_depth=len(plans), sample_time_s=sample_s))
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
        window, then a sampled-ahead batch, else the live RNG).
        JSON-serialisable, equal to the reference's.  No ported tier has
        durable state, so no `tier_state` is attached (the sharded
        placement brings one with ROADMAP.md Queue 1 item 7)."""
        if self.prefetch is not None:
            snap = self.prefetch.oldest_snapshot()
            if snap is not None:
                return dict(snap)
        if self._merged_ready:
            # mid-window: the oldest executed-but-unconsumed batch's snapshot
            return dict(self._merged_ready[0][0])
        if self._lookahead:
            return dict(self._lookahead[0][0])
        return {"rng": self.rng.bit_generator.state,
                "requests_per_iter": self._requests_per_iter}

    def load_state_dict(self, state: dict) -> None:
        """Resume from `state_dict()` (of either package): afterwards the
        loader delivers the batches a freshly built loader fed the same
        state would, bit for bit."""
        if "fault_state" in state:
            raise NotImplementedError(
                "the checkpoint carries fault-plane state, and the port has "
                "no fault plane yet (ROADMAP.md Queue 1 item 7)")
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
        # and the merge-depth EMA, so the resumed loader makes the fresh
        # loader's decisions.  The timelines keep no cross-burst telemetry
        # until the sharded bursts (ROADMAP.md Queue 1 item 7), and the
        # tracer's reset comes with the obs slice (item 8)
        self.accumulator.reset_telemetry()
