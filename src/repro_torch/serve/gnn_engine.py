"""Online multi-tenant GNN inference over the shared tiered data plane:
the port of `repro.serve.gnn_engine`.

`GNNServeEngine` runs sample -> gather -> GNN-forward per request against
the SAME data plane the training loader uses — a `TieredFeatureStore` built
from a `DataPlaneSpec` preset (default "serve-gnn": per-tenant partitioned
HBM cache + pinned-host hot set + direct storage) and, for priced
GPU-initiated sampling, a `TieredTopologyStore`.  The engine is a
virtual-time discrete-event simulation: arrivals come time-stamped from
`serve/workload.py`, every stage is priced by the storage-timeline models,
and no wall clock is involved, so runs are bit-reproducible.

Two execution modes share one code path:

  * merged (`config.merged=True`) — the tentpole: the `SLOBatcher`
    (serve/admission.py) forms deadline-bounded windows under the
    `DeadlineWindowPolicy`, compatible in-flight requests merge through the
    training plane's `merge_window`/`gather_merged` path (cross-REQUEST
    dedup is cross-batch dedup), and the window's storage rows coalesce
    into one priced burst; compatibility includes the tenant — windows are
    tenant-pure (see `run`);
  * per-request (`config.merged=False`) — the baseline: FIFO service, one
    tier fold and one `price_batch` burst per request, no dedup, no line
    coalescing across requests.

Sampling runs at ADMISSION (GPU-initiated, against the topology store) and
overlaps window formation — a window cannot start service before its last
staged sample lands, but slack usually hides sampling entirely; the
per-request baseline gets the same rule (sampling overlaps its queue wait).
Identical request streams produce bit-identical sampled blocks and feature
rows in both modes — merging changes latency, never results.

Every request retires with a priced latency breakdown: queue wait (window
formation + accelerator backlog), its own sampling hops, its share of the
window's gather burst (proportional to its row count), and forward compute
(modelled per-row cost; pass `model`, a `repro_torch.models.gnn.GNN`, to
also run the real GNN forward on the gathered rows).

On the port the data plane lives on the engine's `device`: the sampled
hops read their adjacency words through `frontier_read`, a tenant cache's
hits come from its row store on the device (`tiered_gather`, or one
`tiered_gather_unique` per request of a merged window, then `store_fill`),
and every record's rows and logits are tensors on that device.  A request
served stale takes its rows from the host features through the store's
staging buffer, never from a copy of the whole table on the device.  The
priced floats, the records and the span trees are the reference's, bit for
bit.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.accumulator import (DeadlineWindowConfig,
                                          DeadlineWindowPolicy, merge_window)
from repro_torch.core.dataplane import DataPlane, DataPlaneSpec
from repro_torch.core.faults import FaultInjector
from repro_torch.core.feedback import QuotaController
from repro_torch.core.storage_sim import (SAMSUNG_980PRO, SSDSpec,
                                          StorageTimeline)
from repro_torch.core.tiers import TenantCacheTier, record_tier_metrics
from repro_torch.core.topology import TieredTopologyStore
from repro_torch.models.gnn import hop_indices
from repro_torch.obs import NULL_TRACER, attach_burst_spans
from repro_torch.sampling.neighbor import host_sample_blocks
from repro_torch.sampling.tiered import tiered_sample_blocks

from .admission import SLOBatcher
from .workload import ServeRequest


@dataclasses.dataclass
class GNNServeConfig:
    fanouts: Sequence[int] = (10, 5)
    merged: bool = True             # deadline-bounded windows vs per-request
    data_plane: str = "serve-gnn"   # preset name or DataPlaneSpec
    cache_lines: int = 8192
    cache_ways: int = 8
    tenants: int = 1
    tenant_quotas: Sequence[float] | None = None
    # adaptive quotas (core/feedback.QuotaController): every
    # `quota_interval` served windows, re-split the tenant cache's line
    # budget by EMA-smoothed per-tenant miss traffic (each tenant floored
    # at `quota_floor` of the lines), via TenantCacheTier.repartition
    adaptive_quotas: bool = False
    quota_interval: int = 8
    quota_floor: float = 0.05
    cbuf_fraction: float = 0.05
    # deadline-bounded admission (core/accumulator.DeadlineWindowPolicy)
    max_window: int = 16
    slack_safety: float = 2.5       # heavy-tail fanouts make window service
                                    # variance large; the extra margin eats
                                    # slack, not the SLO
    shed_expired: bool = True
    # priced GPU-initiated sampling (core/topology.TieredTopologyStore)
    use_topology: bool = True
    topo_admission: str = "degree"
    topo_gpu_fraction: float = 0.25
    topo_host_fraction: float = 0.5
    # modelled forward compute: one launch per WINDOW (batching amortizes
    # the launch constant), base + per_row * total window rows
    forward_base_s: float = 3e-5
    forward_per_row_s: float = 2e-8
    keep_features: bool = False     # retain gathered rows on each record
    # fault plane (core/faults.py): a seeded FaultSchedule injected into
    # every priced gather burst (burst index == served-window index on the
    # merged path); None prices bit-identically to the fault-free engine
    fault_schedule: object | None = None
    # brownout degradation ladder (BrownoutController): under measured
    # gather-latency pressure (per-row burst EMA over its own running-min
    # baseline) the engine degrades in priced steps instead of letting
    # every request's p99 ride the straggling queue —
    #   level 1 (pressure >= degrade_at): shrink sampling fanout
    #   level 2 (>= stale_at): + serve requests whose whole neighborhood
    #           was gathered within `stale_window_s` from those rows
    #           (same immutable bytes, staleness accounted, no burst)
    #   level 3 (>= shed_at): + shed every `shed_every`-th staged request
    # one level step per window, de-escalating below recover * threshold
    brownout: bool = False
    brownout_degrade_at: float = 2.0
    brownout_stale_at: float = 3.5
    brownout_shed_at: float = 6.0
    brownout_recover: float = 0.7
    brownout_alpha: float = 0.5
    brownout_fanout_scale: float = 0.5
    brownout_stale_window_s: float = 0.25
    brownout_shed_every: int = 3
    seed: int = 0


@dataclasses.dataclass
class RequestRecord:
    """One retired request with its priced latency breakdown."""

    rid: int
    tenant: int
    arrival_s: float
    deadline_s: float
    rejected: bool = False          # shed at admission (goodput, not p99)
    shed_reason: str | None = None  # why rejected: "expired" (deadline
                                    # already spent at admission) or
                                    # "brownout" (load shed at level 3)
    start_s: float = 0.0            # window service start
    completion_s: float = 0.0
    queue_wait_s: float = 0.0       # arrival -> service start
    sample_s: float = 0.0           # own sampling hops (priced)
    gather_s: float = 0.0           # share of the window burst
    forward_s: float = 0.0          # modelled forward compute
    window_size: int = 0            # requests in the serving window
    n_rows: int = 0                 # unique feature rows of this request
    degraded_level: int = 0         # brownout ladder level when served
    stale: bool = False             # served from recently-gathered rows
    staleness_s: float = 0.0        # age of the oldest reused row
    all_nodes: np.ndarray | None = None
    # rows and logits are tensors on the engine's device
    features: torch.Tensor | None = None  # kept iff config.keep_features
    logits: torch.Tensor | None = None    # set iff a model was supplied

    @property
    def latency_s(self) -> float:
        return self.completion_s - self.arrival_s

    @property
    def deadline_met(self) -> bool:
        return (not self.rejected
                and self.latency_s <= self.deadline_s + 1e-12)


@dataclasses.dataclass
class WindowTrace:
    start_s: float
    n_requests: int
    burst_s: float
    service_s: float
    dedup_factor: float
    hit_cap: bool


@dataclasses.dataclass
class ServeResult:
    records: list[RequestRecord]
    windows: list[WindowTrace]
    # per-tenant cumulative cache hit ratio from the serving tier — the
    # quota controller's input surfaced in served telemetry (empty when the
    # plane has no tenant tier)
    tenant_hit_ratios: dict[int, float] = dataclasses.field(
        default_factory=dict)
    # committed quota re-splits: (window index, new quota shares) per
    # QuotaController event; empty on static-quota runs
    quota_trace: list[tuple[int, tuple[float, ...]]] = dataclasses.field(
        default_factory=list)

    @property
    def served(self) -> list[RequestRecord]:
        return [r for r in self.records if not r.rejected]

    @property
    def n_rejected(self) -> int:
        """All shed requests — see `n_shed_expired` / `n_shed_brownout`
        for the breakdown; deadline misses of SERVED requests are counted
        separately in `n_deadline_missed`, never here."""
        return sum(r.rejected for r in self.records)

    @property
    def n_shed_expired(self) -> int:
        """Shed at admission because the deadline was already spent."""
        return sum(r.rejected and r.shed_reason == "expired"
                   for r in self.records)

    @property
    def n_shed_brownout(self) -> int:
        """Shed by the brownout controller at degradation level 3."""
        return sum(r.rejected and r.shed_reason == "brownout"
                   for r in self.records)

    @property
    def n_deadline_missed(self) -> int:
        """Served to completion but past the deadline — distinct from any
        kind of shed (those never started service)."""
        return sum((not r.rejected) and not r.deadline_met
                   for r in self.records)

    @property
    def n_degraded(self) -> int:
        """Served under a non-zero brownout level (shrunk fanout and/or
        stale rows) — degraded service, not lost service."""
        return sum((not r.rejected) and (r.degraded_level > 0 or r.stale)
                   for r in self.records)

    @property
    def n_stale_served(self) -> int:
        return sum((not r.rejected) and r.stale for r in self.records)

    @property
    def shed_fraction(self) -> float:
        return self.n_rejected / max(len(self.records), 1)

    def attainment(self, tenant: int | None = None) -> float:
        """Fraction of OFFERED load (shed included) that met its deadline
        — the SLO view that shedding cannot flatter, unlike a p99 taken
        over survivors only."""
        recs = [r for r in self.records
                if tenant is None or r.tenant == tenant]
        if not recs:
            return 0.0
        return sum(r.deadline_met for r in recs) / len(recs)

    def latencies_s(self, tenant: int | None = None) -> np.ndarray:
        return np.array([r.latency_s for r in self.served
                         if tenant is None or r.tenant == tenant])

    def _pct(self, q: float, tenant: int | None) -> float:
        lat = self.latencies_s(tenant)
        return float(np.percentile(lat, q)) if len(lat) else float("nan")

    def p50_s(self, tenant: int | None = None) -> float:
        return self._pct(50, tenant)

    def p99_s(self, tenant: int | None = None) -> float:
        return self._pct(99, tenant)

    @property
    def makespan_s(self) -> float:
        served = self.served
        if not served:
            return 0.0
        return (max(r.completion_s for r in served)
                - min(r.arrival_s for r in self.records))

    def goodput_qps(self, tenant: int | None = None) -> float:
        """Completions within deadline per second of makespan — rejected
        and late requests produce no goodput."""
        span = self.makespan_s
        if span <= 0:
            return 0.0
        met = sum(r.deadline_met for r in self.records
                  if tenant is None or r.tenant == tenant)
        return met / span

    def offered_qps(self) -> float:
        if len(self.records) < 2:
            return 0.0
        arrivals = sorted(r.arrival_s for r in self.records)
        return (len(arrivals) - 1) / max(arrivals[-1] - arrivals[0], 1e-12)

    def mean_breakdown_s(self) -> dict:
        served = self.served
        if not served:
            return {k: 0.0 for k in
                    ("queue_wait_s", "sample_s", "gather_s", "forward_s")}
        n = len(served)
        return {
            "queue_wait_s": sum(r.queue_wait_s for r in served) / n,
            "sample_s": sum(r.sample_s for r in served) / n,
            "gather_s": sum(r.gather_s for r in served) / n,
            "forward_s": sum(r.forward_s for r in served) / n,
        }

    @property
    def mean_window(self) -> float:
        if not self.windows:
            return 0.0
        return sum(w.n_requests for w in self.windows) / len(self.windows)


class BrownoutController:
    """Gather-latency pressure ladder for graceful serve-plane degradation.

    Pressure is the EMA of per-row window burst latency over its own
    running-minimum baseline — a storage brownout inflates every line read
    so the per-ROW cost rises with it, while window size and dedup cancel
    out of the normalization.  The ladder moves at most one level per
    observed window (no thrash on a single slow burst) and de-escalates
    with hysteresis once pressure falls below `recover` times the
    threshold it climbed past.  Levels only reshape WHAT is served —
    fanout, staleness, admission — never the bytes of any row that is
    served, so the fault-plane data invariant holds through a brownout.
    """

    def __init__(self, config: GNNServeConfig):
        self.config = config
        self.reset()

    def reset(self) -> None:
        self.level = 0
        self.ema = 0.0
        self.baseline = float("inf")
        self.n_windows = 0
        # (window index, new level) — one entry per ladder move
        self.level_trace: list[tuple[int, int]] = []

    @property
    def thresholds(self) -> tuple[float, float, float]:
        cfg = self.config
        return (cfg.brownout_degrade_at, cfg.brownout_stale_at,
                cfg.brownout_shed_at)

    @property
    def pressure(self) -> float:
        if not np.isfinite(self.baseline) or self.baseline <= 0 \
                or self.ema <= 0:
            return 1.0
        return self.ema / self.baseline

    def observe(self, burst_s: float, n_rows: int) -> int:
        """Feed one served window's burst; returns the (new) level.
        Stale-only windows gather nothing and carry no signal — the EMA
        holds until a fresh burst confirms or denies the pressure."""
        self.n_windows += 1
        if n_rows <= 0:
            return self.level
        per_row = burst_s / n_rows
        a = self.config.brownout_alpha
        self.ema = per_row if self.ema <= 0 else \
            (1.0 - a) * self.ema + a * per_row
        self.baseline = min(self.baseline, self.ema)
        th = self.thresholds
        p = self.pressure
        target = sum(p >= x for x in th)
        if target > self.level:
            self.level += 1
        elif self.level > 0 \
                and p < th[self.level - 1] * self.config.brownout_recover:
            self.level -= 1
        last = self.level_trace[-1][1] if self.level_trace else 0
        if self.level != last:
            self.level_trace.append((self.n_windows, self.level))
        return self.level


class GNNServeEngine:
    """Virtual-time online inference engine over the shared data plane.

    `plane` / `topo` may be passed in to SHARE an existing data plane (e.g.
    the training loader's) — by default the engine builds its own from
    `config.data_plane` on `device`.  `model` (a
    `repro_torch.models.gnn.GNN`, holding its own parameters) optionally
    runs the real forward per request on the rows' device; timing always
    uses the modelled forward cost.
    """

    def __init__(self, graph, features, config: GNNServeConfig | None = None,
                 ssd: SSDSpec = SAMSUNG_980PRO,
                 plane: DataPlane | None = None,
                 topo: TieredTopologyStore | None = None,
                 model=None, tracer=None,
                 device: str | torch.device = "cuda"):
        self.graph = graph
        self.features = np.asarray(features)
        self.config = cfg = config or GNNServeConfig()
        self.ssd = ssd
        self.device = resolve_device(device)
        # observation only — an enabled tracer records spans/metrics but the
        # priced results are bit-identical to a NULL_TRACER run
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if plane is None:
            plane = DataPlaneSpec.resolve(cfg.data_plane).build(
                graph, self.features,
                cache_lines=cfg.cache_lines, cache_ways=cfg.cache_ways,
                cbuf_fraction=cfg.cbuf_fraction, tenants=cfg.tenants,
                tenant_quotas=cfg.tenant_quotas, seed=cfg.seed,
                device=self.device)
        self.plane = plane
        self.store = plane.store
        backstop = self.store.tiers[-1]
        shard_specs = None
        if hasattr(backstop, "resolve_shard_specs"):
            shard_specs = backstop.resolve_shard_specs(ssd)
        self.timeline = StorageTimeline(ssd, 1, shard_specs=shard_specs)
        self.fault_injector = None
        if cfg.fault_schedule is not None:
            n_queues = len(shard_specs) if shard_specs else 1
            self.fault_injector = FaultInjector(cfg.fault_schedule, n_queues)
            self.timeline.injector = self.fault_injector
        self.brownout = BrownoutController(cfg) if cfg.brownout else None
        # node -> virtual time its row was last gathered (stale serving)
        self._recent: dict[int, float] = {}
        self._shed_tick = 0
        if topo is None and cfg.use_topology:
            topo = TieredTopologyStore.from_graph(
                graph, admission=cfg.topo_admission,
                gpu_fraction=cfg.topo_gpu_fraction,
                host_fraction=cfg.topo_host_fraction,
                ssd=ssd, seed=cfg.seed, device=self.device)
        self.topo = topo
        self.model = model
        self.policy = DeadlineWindowPolicy(DeadlineWindowConfig(
            max_window=cfg.max_window if cfg.merged else 1,
            safety=cfg.slack_safety))
        self.batcher = SLOBatcher(self.policy,
                                  shed_expired=cfg.shed_expired)
        self._tenant_tier = next(
            (t for t in self.store.tiers if isinstance(t, TenantCacheTier)),
            None)
        self.quota_controller = self._make_quota_controller()
        self._sample_cache: dict = {}
        if self.tracer.enabled:
            self.timeline.metrics = self.tracer.metrics
            if self.topo is not None:
                self.topo.timeline.metrics = self.tracer.metrics

    def _make_quota_controller(self):
        if not (self.config.adaptive_quotas and self._tenant_tier is not None
                and self._tenant_tier.tenants > 1):
            return None
        qc = QuotaController(self._tenant_tier,
                             interval=self.config.quota_interval,
                             floor=self.config.quota_floor)
        qc.tracer = self.tracer
        return qc

    # -- stages ----------------------------------------------------------------
    def _sample(self, req: ServeRequest):
        """GPU-initiated sampling at admission, memoized per request.  The
        RNG stream is keyed by (engine seed, rid) — NOT by service order —
        so a request samples the same blocks whether it is served merged,
        per-request, or after a demotion; with a topology store the
        hop-page reads are priced and the modelled time returned."""
        fanouts = self._fanouts()
        hit = self._sample_cache.get((req.rid, fanouts))
        if hit is not None:
            return hit
        rng = np.random.default_rng([self.config.seed, req.rid])
        if self.topo is not None:
            blocks = tiered_sample_blocks(self.graph, self.topo, req.seeds,
                                          fanouts, rng)
            out = (blocks, float(blocks.sample_time_s))
        else:
            out = (host_sample_blocks(self.graph, req.seeds,
                                      fanouts, rng), 0.0)
        self._sample_cache[(req.rid, fanouts)] = out
        return out

    def _fanouts(self) -> tuple[int, ...]:
        """Brownout level >= 1 shrinks the sampling fanout by
        `fanout_scale ** level` — fewer neighbors per hop means fewer
        unique rows per window, the cheapest pressure release (accuracy
        degrades before latency does).  The sample memo is keyed by the
        fanout it was drawn with, so a backlogged request re-samples
        smaller when the ladder climbs while it queues — mitigation
        reaches the very requests the brownout stranded — and the
        fault-free path (level pinned at 0) never re-samples anything."""
        if self.brownout is None or self.brownout.level < 1:
            return tuple(self.config.fanouts)
        scale = self.config.brownout_fanout_scale ** self.brownout.level
        return tuple(max(1, int(round(f * scale)))
                     for f in self.config.fanouts)

    def _forward_s(self, n_rows: int) -> float:
        """One batched forward launch over `n_rows` gathered rows — the
        window pays the launch constant once, which is the other half of
        what merging buys (the per-request baseline pays it per request)."""
        return (self.config.forward_base_s
                + self.config.forward_per_row_s * n_rows)

    def _run_model(self, blocks, rows: torch.Tensor) -> torch.Tensor:
        """The GNN forward over one request's rows, on their device."""
        hi = [torch.from_numpy(h).to(rows.device) for h in hop_indices(blocks)]
        with torch.no_grad():
            return self.model.forward(rows, hi)

    def _stage_tenants(self, merged, staged: list[ServeRequest]) -> None:
        """Announce the serving tenant of each unique node to the tenant
        tier: the first requester (admission order) owns the fill for this
        window; later requesters share the deduplicated row."""
        if self._tenant_tier is None:
            return
        tenant_of = np.full(merged.n_unique, -1, np.int64)
        for i, req in enumerate(staged):
            inv = merged.batch_inverse(i)
            fresh = tenant_of[inv] < 0
            tenant_of[inv[fresh]] = req.tenant
        self._tenant_tier.stage_tenants(tenant_of)

    # -- main loop -------------------------------------------------------------
    def run(self, requests: Sequence[ServeRequest]) -> ServeResult:
        """Serve an arrival-time-stamped stream to completion — see `_run`
        for the scheduling rules.  With an enabled tracer the run is
        wall-clocked as one ``serve_run`` stage (modelled time = the priced
        makespan), every retired request gets a virtual span on its
        tenant's track, and the serve counters land in the registry."""
        with self.tracer.stage("serve_run", cat="serve",
                               n_requests=len(requests)) as sp:
            result = self._run(requests)
            sp.modelled(result.makespan_s)
        if self.tracer.enabled:
            self._trace_requests(result)
            self._record_serve_metrics(result)
        return result

    def _run(self, requests: Sequence[ServeRequest]) -> ServeResult:
        """Serve an arrival-time-stamped stream to completion.

        Windows are TENANT-PURE: each tenant has its own pending queue and
        a window only merges requests of one tenant.  Isolation extends to
        the batch dimension — a noisy tenant's burst can inflate its own
        windows but never another tenant's, and a victim request's latency
        reflects its own tenant's cache partition, not whoever happened to
        share the window.  Tenants still share the one engine: service is
        FCFS across tenants by oldest waiting request.
        """
        queues: dict[int, deque] = {}
        for r in sorted(requests, key=lambda r: (r.arrival_s, r.rid)):
            queues.setdefault(r.tenant, deque()).append(r)
        records: list[RequestRecord] = []
        windows: list[WindowTrace] = []
        self._sample_cache.clear()
        busy = 0.0
        while any(queues.values()):
            tenant = min((t for t, q in queues.items() if q),
                         key=lambda t: queues[t][0].arrival_s)
            pending = queues[tenant]
            decision = self.batcher.next_window(pending, busy)
            if decision is None:
                continue
            for req in decision.shed:
                records.append(RequestRecord(
                    rid=req.rid, tenant=req.tenant, arrival_s=req.arrival_s,
                    deadline_s=req.deadline_s, rejected=True,
                    shed_reason="expired"))
            if not decision.staged:
                continue
            # a staged request whose sampling would land after the oldest
            # request's slack bound would push the whole window — and that
            # deadline — out by its own sampling tail.  It doesn't hold the
            # window hostage: demote it to the next window (its sample is
            # memoized, nothing re-runs).  The oldest always stays — the
            # window exists for its deadline — and the bound is its slack,
            # not the intended open time, so a backlogged cap-closed window
            # may slip a little to keep its depth (amortization is worth
            # more than an early start while slack remains).
            oldest = decision.staged[0]
            bound = max(decision.start_s, self.policy.close_by(
                oldest.arrival_s, oldest.deadline_s, len(decision.staged)))
            staged, demoted = [oldest], []
            for req in decision.staged[1:]:
                _, sample_s = self._sample(req)
                if req.arrival_s + sample_s <= bound:
                    staged.append(req)
                else:
                    demoted.append(req)
            for req in reversed(demoted):    # arrival order preserved
                pending.appendleft(req)
            # level 3: counter-based load shedding — every shed_every'th
            # staged request (deterministic, not sampled) is dropped before
            # service so the survivors' window stays small enough to hold
            # the victim p99.  The oldest request never sheds: its deadline
            # is why the window opened.
            if self.brownout is not None and self.brownout.level >= 3 \
                    and len(staged) > 1:
                keep = [staged[0]]
                for req in staged[1:]:
                    self._shed_tick += 1
                    if self._shed_tick % self.config.brownout_shed_every == 0:
                        records.append(RequestRecord(
                            rid=req.rid, tenant=req.tenant,
                            arrival_s=req.arrival_s,
                            deadline_s=req.deadline_s, rejected=True,
                            shed_reason="brownout"))
                    else:
                        keep.append(req)
                staged = keep
            decision.staged = staged
            busy = self._execute(decision, records, windows)
            # close the quota loop once per served window: the controller
            # watches the tenant tier's cumulative counters and repartitions
            # when smoothed miss traffic drifts past its dead band
            if self.quota_controller is not None:
                self.quota_controller.step()
        records.sort(key=lambda r: r.rid)
        result = ServeResult(records=records, windows=windows)
        if self._tenant_tier is not None:
            result.tenant_hit_ratios = {
                t: self._tenant_tier.hit_ratio(t)
                for t in range(self._tenant_tier.tenants)}
        if self.quota_controller is not None:
            result.quota_trace = list(self.quota_controller.events)
        return result

    def _execute(self, decision, records, windows) -> float:
        staged = decision.staged
        level = self.brownout.level if self.brownout is not None else 0
        prev_burst = (self.timeline.shard_burst if self.tracer.enabled
                      else None)
        samples = [self._sample(r) for r in staged]
        # service cannot start before the last staged sample lands —
        # sampling is admission-time GPU work overlapping window formation
        start = max([decision.start_s]
                    + [r.arrival_s + s for r, (_, s) in zip(staged, samples)])
        blocks = [b for b, _ in samples]

        # level >= 2: a request whose WHOLE neighborhood was gathered
        # within the stale window is served from those rows directly —
        # identical bytes (features are immutable), zero storage burst,
        # staleness recorded on the record instead of latency on the tail
        stale_age: list[float | None] = [None] * len(staged)
        if self.config.merged and level >= 2 and self._recent:
            win = self.config.brownout_stale_window_s
            for i, blk in enumerate(blocks):
                last = [self._recent.get(int(n)) for n in blk.all_nodes]
                if last and all(ls is not None and start - ls <= win
                                for ls in last):
                    stale_age[i] = start - min(last)
        fresh = [i for i, a in enumerate(stale_age) if a is None]

        rows_by_idx: dict[int, torch.Tensor] = {}
        gathered_unique = None
        if len(staged) == 1 and not self.config.merged:
            # per-request baseline: one fold, one un-coalesced burst whose
            # overlap efficiency comes from this request's own storage
            # concurrency alone (no accumulator ramping across requests)
            merged = merge_window([blocks[0].all_nodes])
            self._stage_tenants(merged, staged)
            rows, report = self.store.gather(blocks[0].all_nodes)
            rows_by_idx[0] = rows
            burst_s = self.timeline.price_batch(
                report, outstanding=max(report.n_storage, 1))
            dedup = 1.0
        elif fresh:
            merged = merge_window([blocks[i].all_nodes for i in fresh])
            self._stage_tenants(merged, [staged[i] for i in fresh])
            fresh_rows_list, _, wrep = self.store.gather_merged(merged)
            burst_s = self.timeline.price_merged_burst(wrep)
            dedup = wrep.dedup_factor
            rows_by_idx = dict(zip(fresh, fresh_rows_list))
            gathered_unique = merged.unique_nodes
        else:
            # every staged request is served stale — no burst at all
            burst_s, dedup = 0.0, 1.0

        total_rows = sum(len(b.all_nodes) for b in blocks)
        fresh_rows = sum(len(blocks[i].all_nodes) for i in fresh)
        forward_total_s = self._forward_s(total_rows)
        t = start + burst_s + forward_total_s
        for i, (req, (blk, sample_s)) in enumerate(zip(staged, samples)):
            n_rows = len(blk.all_nodes)
            stale = stale_age[i] is not None
            rows = rows_by_idx.get(i)
            if rows is None:
                # served stale: the same immutable rows, staged from the
                # host features through the store's pinned buffer
                rows = self.store.host_rows(blk.all_nodes)
            rec = RequestRecord(
                rid=req.rid, tenant=req.tenant, arrival_s=req.arrival_s,
                deadline_s=req.deadline_s, start_s=start, completion_s=t,
                queue_wait_s=start - req.arrival_s, sample_s=sample_s,
                gather_s=(0.0 if stale
                          else burst_s * n_rows / max(fresh_rows, 1)),
                forward_s=forward_total_s * n_rows / max(total_rows, 1),
                window_size=len(staged),
                n_rows=n_rows, degraded_level=level, stale=stale,
                staleness_s=stale_age[i] or 0.0, all_nodes=blk.all_nodes)
            if self.config.keep_features:
                rec.features = rows
            if self.model is not None:
                rec.logits = self._run_model(blk, rows)
            records.append(rec)
        if self.brownout is not None:
            if gathered_unique is not None:
                for n in gathered_unique:
                    self._recent[int(n)] = start
            new_level = self.brownout.observe(
                burst_s,
                len(gathered_unique) if gathered_unique is not None else 0)
            if new_level != level:
                self.tracer.instant(
                    "brownout", track="controller", cat="controller", t0=t,
                    level=new_level, pressure=float(self.brownout.pressure))
        service_s = t - start
        # the policy's estimate absorbs the sampling-completion push-out of
        # `start` past the batcher's intended open time, so close_by leaves
        # room for it on the next window
        self.policy.observe(t - decision.start_s, len(staged))
        windows.append(WindowTrace(
            start_s=start, n_requests=len(staged), burst_s=burst_s,
            service_s=service_s, dedup_factor=dedup,
            hit_cap=decision.hit_cap))
        if self.tracer.enabled:
            self._trace_window(windows[-1], len(windows) - 1, level,
                               forward_total_s, dedup, prev_burst)
        return t

    # -- observability ---------------------------------------------------------
    def _trace_window(self, w: WindowTrace, index: int, level: int,
                      forward_total_s: float, dedup: float,
                      prev_burst) -> None:
        """Virtual span for one served window on the ``windows`` track:
        gather burst (with per-shard / fault overlays when the serve
        timeline produced a fresh sharded burst) then the batched forward.
        Window starts are monotone in service order, so the track lays out
        without any cursor fixups."""
        root = self.tracer.batch(
            "serve_window", track="windows", cat="window", t0=w.start_s,
            index=index, n_requests=w.n_requests, level=level,
            hit_cap=w.hit_cap)
        g = root.child("gather", w.burst_s, cat="gather",
                       dedup_factor=float(dedup))
        burst = self.timeline.shard_burst
        if burst is not None and burst is not prev_burst:
            attach_burst_spans(g, burst)
        root.child("forward", forward_total_s, cat="forward")
        root.close(w.service_s)
        m = self.tracer.metrics
        m.histogram("serve.window_size").observe(w.n_requests)
        m.histogram("serve.dedup_factor").observe(float(dedup))
        m.counter("serve.burst_s").inc(w.burst_s)
        m.counter("serve.forward_s").inc(forward_total_s)

    def _trace_requests(self, result: ServeResult) -> None:
        """One virtual span per retired request on its tenant's track,
        emitted AFTER the run in arrival order (demotion can serve requests
        out of arrival order, and track starts must be monotone).  The
        sequential children — queue wait, the window's gather burst, the
        window's batched forward — partition the end-to-end latency; the
        request's own shares ride along as annotations and its sampling
        overlays the queue wait as a parallel child."""
        window_of = {}
        for w in result.windows:
            window_of.setdefault(w.start_s, w)
        for rec in sorted(result.records,
                          key=lambda r: (r.arrival_s, r.rid)):
            track = f"tenant{rec.tenant}"
            if rec.rejected:
                self.tracer.instant("shed", track=track, cat="serve",
                                    t0=rec.arrival_s, rid=rec.rid,
                                    reason=rec.shed_reason)
                continue
            w = window_of.get(rec.start_s)
            burst_s = w.burst_s if w is not None else 0.0
            forward_s = (w.service_s - w.burst_s if w is not None
                         else rec.forward_s)
            root = self.tracer.batch(
                "request", track=track, cat="request", t0=rec.arrival_s,
                rid=rec.rid, tenant=rec.tenant, window_size=rec.window_size,
                n_rows=rec.n_rows, level=rec.degraded_level, stale=rec.stale,
                deadline_met=rec.deadline_met)
            root.child("queue_wait", rec.queue_wait_s, cat="serve")
            root.child("gather", burst_s, cat="gather",
                       share_s=rec.gather_s)
            root.child("forward", forward_s, cat="forward",
                       share_s=rec.forward_s)
            if rec.sample_s > 0.0:
                root.child("sample", rec.sample_s, cat="sample",
                           parallel=True)
            root.close(rec.latency_s)

    def _record_serve_metrics(self, result: ServeResult) -> None:
        m = self.tracer.metrics
        m.counter("serve.requests").inc(len(result.records))
        m.counter("serve.windows").inc(len(result.windows))
        m.counter("serve.shed_expired").inc(result.n_shed_expired)
        m.counter("serve.shed_brownout").inc(result.n_shed_brownout)
        m.counter("serve.deadline_missed").inc(result.n_deadline_missed)
        m.counter("serve.stale_served").inc(result.n_stale_served)
        m.gauge("serve.attainment").set(result.attainment())
        for rec in result.served:
            m.histogram("serve.latency_s").observe(rec.latency_s)
        for t, ratio in result.tenant_hit_ratios.items():
            m.gauge(f"serve.tenant{t}.hit_ratio").set(ratio)
        record_tier_metrics(self.store.tiers, m)

    def reset(self) -> None:
        """Fresh caches, fresh RNG, fresh service estimate — a reset engine
        replays a stream bit-identically."""
        self.plane.reset()
        # the topology store is stateless (fixed page assignment) — nothing
        # to reset there
        self.policy.reset()
        # plane.reset restored the construction-time quotas; the controller
        # restarts from the same initial demand estimate
        self.quota_controller = self._make_quota_controller()
        self._sample_cache.clear()
        if self.fault_injector is not None:
            self.fault_injector.reset()
        if self.brownout is not None:
            self.brownout.reset()
        self._recent.clear()
        self._shed_tick = 0
        # telemetry restarts with the replay: stale spans/metrics from the
        # previous stream would otherwise leak into the next export
        self.tracer.reset()
        self.timeline.reset_telemetry()
