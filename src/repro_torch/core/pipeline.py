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

The features of a `Batch` are a tensor on the loader's device; reports and
priced floats stay host-side Python and numpy, bit-identical to the
reference.  Sharding, hosts, faults, feedback, tracing and checkpoint
state wait for later slices (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.sampling.neighbor import SampledBlocks, host_sample_blocks
from repro_torch.sampling.tiered import tiered_sample_blocks
from .accumulator import AccumulatorConfig, DynamicAccessAccumulator
from .dataplane import DataPlane, DataPlaneSpec
from .feature_store import GatherReport
from .prefetch import PrefetchEngine
from .storage_sim import INTEL_OPTANE, SSDSpec, StorageTimeline
from .topology import TieredTopologyStore

SAMPLERS = ("neighbor",)


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 4096
    fanouts: Sequence[int] = (10, 5, 5)       # 3 sampling layers (paper §4.1)
    sampler: str = "neighbor"
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
            raise NotImplementedError(
                f"sampler {self.sampler!r} is not ported yet (ROADMAP.md "
                f"Queue 1: LADIES); ported samplers: {SAMPLERS}")
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
        if self.topo is not None:
            # same math, same RNG stream: blocks bit-identical to the host
            # sampler, plus per-hop priced TopologyGatherReports
            return tiered_sample_blocks(self.graph, self.topo, seeds,
                                        cfg.fanouts, self.rng)
        return host_sample_blocks(self.graph, seeds, cfg.fanouts, self.rng)

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
