"""Feedback-driven data-plane control, the port's copy of
`repro.core.feedback`: the telemetry loop, closed.

A mutable, checkpointed `TouchTable` accumulates measured touches online,
and two controllers spend that signal:

  ShardRebalancer   — feature-shard migration.  When the measured queue
                      imbalance crosses a threshold (or the
                      `ShardHealthMonitor` flags a browning-out shard),
                      re-stripe the measured-hot nodes across shards
                      (`AdaptivePlacement.plan_rebalance` / `plan_drain`,
                      core/sharding.py).  Moving rows costs real IOs
                      (`StorageTimeline.price_migration`), so the
                      controller commits only when the modelled saving
                      over its amortization horizon exceeds the
                      migration's own cost, and the committed cost is
                      charged back into later batches (`AmortizedCost`).
  TopologyRefresher — the same loop one namespace over: measured-hot edge
                      pages are promoted into the GPU/host budgets between
                      folds (`TieredTopologyStore.plan_refresh`).

Both are virtual-time controllers: decisions are functions of priced
telemetry, never the wall clock, so adaptive runs stay bit-reproducible
and bit-identical to the reference.  The serve plane's `QuotaController`
closes the same loop over a `TenantCacheTier`'s per-tenant quotas from
measured miss traffic.  Every committed action is also an instant event
and a counter on the controller's `tracer` (the no-op tracer by default).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import NULL_TRACER


class TouchTable:
    """Mutable, checkpointed EMA of measured per-entry touches.

    One slot per namespace entry (feature node, edge page, ...).  `observe`
    accumulates raw touch counts into a pending bucket; `fold` closes the
    measurement interval by folding the bucket into the exponential moving
    average — `ema = (1 - alpha) * ema + alpha * pending` — so `scores()`
    tracks the recent touch *rate per interval* and old hot sets decay
    instead of pinning their placement forever.  `state_dict` round-trips
    both the folded average and the open bucket, so a checkpoint taken
    mid-interval resumes the same learned state (the adaptive placements
    carry this through the tier checkpoint path, exactly like
    `DegreePlacement.table`).
    """

    def __init__(self, size: int, alpha: float = 0.5):
        if size < 1:
            raise ValueError(f"TouchTable needs a namespace, got size {size}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.size = int(size)
        self.alpha = float(alpha)
        self.ema = np.zeros(self.size, np.float64)
        self.pending = np.zeros(self.size, np.float64)
        self.folds = 0

    def observe(self, ids: np.ndarray, counts: np.ndarray | None = None
                ) -> None:
        """Record measured touches: +1 per id, or `counts[i]` touches of
        `ids[i]` (the merged executor passes the window multiplicity, the
        topology store its per-page read counts)."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        if counts is None:
            np.add.at(self.pending, ids, 1.0)
        else:
            np.add.at(self.pending, ids,
                      np.asarray(counts, np.float64))

    def fold(self) -> None:
        """Close the measurement interval: fold the pending bucket into the
        EMA and start the next interval empty."""
        self.ema *= 1.0 - self.alpha
        self.ema += self.alpha * self.pending
        self.pending[:] = 0.0
        self.folds += 1

    def scores(self) -> np.ndarray:
        """The learned per-entry touch rate (per fold interval)."""
        return self.ema

    # -- checkpoint ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"size": self.size, "alpha": self.alpha, "folds": self.folds,
                "ema": self.ema.copy(), "pending": self.pending.copy()}

    def load_state_dict(self, state: dict) -> None:
        if int(state.get("size", self.size)) != self.size:
            raise ValueError(
                f"touch table checkpointed over {state.get('size')} entries, "
                f"namespace has {self.size}")
        self.alpha = float(state.get("alpha", self.alpha))
        self.folds = int(state.get("folds", 0))
        self.ema = np.asarray(state["ema"], np.float64).copy()
        self.pending = np.asarray(state["pending"], np.float64).copy()


class AmortizedCost:
    """A priced one-off cost paid back over subsequent bursts.

    `add(cost_s)` books a committed migration's modelled seconds;
    `charge()` returns the next burst's share — outstanding / horizon,
    recomputed at each booking so overlapping migrations blend — until the
    debt drains.  The loader folds each charge into that batch's
    `prep_time_s`, which is what makes adaptive-vs-static comparisons net
    of migration IOs rather than pretending the rows teleported."""

    def __init__(self, horizon: int):
        if horizon < 1:
            raise ValueError(f"amortization horizon must be >= 1, "
                             f"got {horizon}")
        self.horizon = int(horizon)
        self.outstanding_s = 0.0
        self._per_charge = 0.0

    def add(self, cost_s: float) -> None:
        if cost_s < 0:
            raise ValueError(f"cost must be >= 0, got {cost_s}")
        self.outstanding_s += float(cost_s)
        self._per_charge = self.outstanding_s / self.horizon

    def charge(self) -> float:
        c = min(self.outstanding_s, self._per_charge)
        self.outstanding_s -= c
        return c


@dataclasses.dataclass(frozen=True)
class MigrationEvent:
    """One committed shard migration, for telemetry and the convergence
    benchmark: when it happened (burst index), how many rows moved, what
    moving them cost, and what the model predicted the move would buy."""

    burst: int
    n_moved: int
    cost_s: float
    imbalance_before: float
    predicted_saving_s: float       # per burst, over the horizon
    reason: str = "imbalance"       # "imbalance" | "drain" (health-driven)


class ShardHealthMonitor:
    """EMA of per-shard burst latencies — the fault plane's detector.

    `observe` feeds every priced `ShardedBurstResult` into a per-shard EMA
    of PER-ROW drain time (``per_shard_s / per_shard_rows``): normalizing by
    rows makes natural placement skew invisible — a shard that is slow
    because it holds more of the batch looks healthy per row — while device
    slowness (brownout, flaky retries) shows up directly.  A shard is
    `degraded` when its per-row EMA exceeds ``degraded_factor`` times the
    median across tracked shards, after at least `min_bursts` observations
    (cold starts don't flap).  The flag set is what the `FailoverRouter`
    routes around and what the `ShardRebalancer` drains
    (`AdaptivePlacement.plan_drain`); `healthiest` picks the replica with
    the lowest EMA for hedges and failover.

    Pure virtual-time telemetry: state is a function of the priced bursts
    observed, so adaptive fault handling stays bit-reproducible."""

    def __init__(self, n_shards: int, alpha: float = 0.3,
                 degraded_factor: float = 2.5, min_bursts: int = 4):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if degraded_factor <= 1.0:
            raise ValueError(f"degraded_factor must be > 1, "
                             f"got {degraded_factor}")
        self.n_shards = int(n_shards)
        self.alpha = float(alpha)
        self.degraded_factor = float(degraded_factor)
        self.min_bursts = int(min_bursts)
        self.reset()

    def reset(self) -> None:
        self.ema = np.zeros(self.n_shards, np.float64)
        self.seen = np.zeros(self.n_shards, np.int64)
        self._degraded = np.empty(0, np.int64)
        self._bursts = 0
        self.first_flag_burst = -1

    def observe(self, burst) -> None:
        """Fold one priced burst's per-shard drains into the EMAs and
        recompute the degraded set."""
        t = np.asarray(burst.per_shard_s, np.float64)
        rows = np.asarray(burst.per_shard_rows, np.float64)
        if len(t) != self.n_shards:
            raise ValueError(
                f"burst spans {len(t)} shards, monitor tracks "
                f"{self.n_shards}")
        self._bursts += 1
        m = rows > 0
        per_row = np.zeros_like(t)
        per_row[m] = t[m] / rows[m]
        fresh = m & (self.seen == 0)
        self.ema[fresh] = per_row[fresh]
        seasoned = m & (self.seen > 0)
        self.ema[seasoned] = (1.0 - self.alpha) * self.ema[seasoned] \
            + self.alpha * per_row[seasoned]
        self.seen[m] += 1
        tracked = (self.seen >= self.min_bursts) & (self.ema > 0)
        if int(tracked.sum()) < 2:
            self._degraded = np.empty(0, np.int64)
            return
        median = float(np.median(self.ema[tracked]))
        self._degraded = np.nonzero(
            tracked & (self.ema > self.degraded_factor * median))[0]
        if len(self._degraded) and self.first_flag_burst < 0:
            self.first_flag_burst = self._bursts

    def degraded(self) -> np.ndarray:
        """Shards currently flagged as browning out (may be empty)."""
        return self._degraded

    def worst(self) -> int:
        """The degraded shard with the highest per-row EMA, or -1."""
        bad = self._degraded
        if len(bad) == 0:
            return -1
        return int(bad[np.argmax(self.ema[bad])])

    def healthiest(self, candidates) -> int:
        """The candidate shard with the lowest per-row EMA (ties: first)."""
        cand = np.asarray(candidates, np.int64)
        if len(cand) == 0:
            raise ValueError("healthiest() of no candidate shards")
        return int(cand[np.argmin(self.ema[cand])])

    # -- checkpoint ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"n_shards": self.n_shards, "alpha": self.alpha,
                "degraded_factor": self.degraded_factor,
                "min_bursts": self.min_bursts, "bursts": self._bursts,
                "ema": self.ema.copy(), "seen": self.seen.copy(),
                "degraded": self._degraded.copy(),
                "first_flag_burst": self.first_flag_burst}

    def load_state_dict(self, state: dict) -> None:
        if int(state.get("n_shards", self.n_shards)) != self.n_shards:
            raise ValueError(
                f"shard health monitor checkpointed over "
                f"{state.get('n_shards')} shards, plane has {self.n_shards}")
        self.alpha = float(state.get("alpha", self.alpha))
        self.degraded_factor = float(state.get("degraded_factor",
                                               self.degraded_factor))
        self.min_bursts = int(state.get("min_bursts", self.min_bursts))
        self._bursts = int(state.get("bursts", 0))
        self.ema = np.asarray(state["ema"], np.float64).copy()
        self.seen = np.asarray(state["seen"], np.int64).copy()
        self._degraded = np.asarray(state.get("degraded", ()),
                                    np.int64).copy()
        self.first_flag_burst = int(state.get("first_flag_burst", -1))


class ShardRebalancer:
    """Online feature-shard migration from measured touches.

    Drives an `AdaptivePlacement` (core/sharding.py) sitting under a
    `ShardedStorageTier`: every priced burst the loader records the batch's
    touched nodes (`observe`) and ticks `step()`; every `interval` bursts
    the touch table folds and, if the most recent burst's measured queue
    imbalance (`StorageTimeline.shard_burst`) exceeds `threshold`, the
    policy proposes re-striping the measured-hot nodes round-robin.  The
    proposal commits ONLY when

        (elapsed - mean per-shard drain) * horizon  >  migration cost

    i.e. the modelled time the imbalance is costing per burst, over the
    amortization horizon, must beat the priced IO cost of actually moving
    the rows (`StorageTimeline.price_migration`).  Committed costs are
    charged back into subsequent bursts via `AmortizedCost` — `step()`
    returns each burst's share and the loader folds it into prep time."""

    def __init__(self, tier, timeline, bytes_per_row: int, *,
                 interval: int = 8, threshold: float = 1.25,
                 horizon: int = 64, cooldown: int = 2):
        placement = getattr(tier, "placement", None)
        if placement is None or not hasattr(placement, "plan_rebalance"):
            raise ValueError(
                "ShardRebalancer needs a sharded backstop with an adaptive "
                f"placement (got {getattr(placement, 'name', None)!r}) — "
                "build the plane with placement='adaptive'")
        if interval < 1:
            raise ValueError(f"feedback interval must be >= 1, "
                             f"got {interval}")
        self.tier = tier
        self.placement = placement
        self.timeline = timeline
        self.bytes_per_row = int(bytes_per_row)
        self.interval = int(interval)
        self.threshold = float(threshold)
        self.horizon = int(horizon)
        self.cooldown = int(cooldown)
        self.debt = AmortizedCost(horizon)
        self.events: list[MigrationEvent] = []
        self._bursts = 0
        self._cooldown = 0
        # fault plane: when a ShardHealthMonitor is wired (the loader does
        # it for fault-enabled planes), a degraded shard triggers a DRAIN —
        # evacuate its measured-hot rows — ahead of the imbalance trigger
        self.monitor = None
        # observability plane: commits emit instant events + commit-cost
        # counters; the shared no-op tracer records nothing
        self.tracer = NULL_TRACER

    def observe(self, node_ids: np.ndarray,
                counts: np.ndarray | None = None) -> None:
        self.placement.touches.observe(node_ids, counts)

    def step(self) -> float:
        """One tick per priced burst: consider a migration at the interval
        boundary, and return this burst's amortized migration charge."""
        self._bursts += 1
        if self._bursts % self.interval == 0:
            self._consider()
        return self.debt.charge()

    def _consider(self) -> None:
        self.placement.touches.fold()
        # post-commit cooldown: the imbalance telemetry needs a few folds to
        # reflect the NEW table (EMA lag would otherwise trigger a chain of
        # low-value follow-up migrations right after a big one)
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        burst = self.timeline.shard_burst
        if burst is None:
            return
        # health-driven drain first: a browning-out queue is a stronger
        # signal than imbalance (the max-over-shards pricing rides it
        # every burst), and evacuating its hot rows is the one move that
        # helps even when the namespace is perfectly level
        drain_shard = self.monitor.worst() if self.monitor is not None \
            and hasattr(self.placement, "plan_drain") else -1
        if drain_shard >= 0:
            new_table, moved = self.placement.plan_drain(drain_shard)
            reason = "drain"
        else:
            if burst.imbalance < self.threshold:
                return
            new_table, moved = self.placement.plan_rebalance()
            reason = "imbalance"
        if len(moved) == 0:
            return
        cost = self.timeline.price_migration(
            self.placement.table[moved], new_table[moved],
            self.bytes_per_row, n_shards=self.placement.n_shards)
        # the imbalance is costing (elapsed - mean drain) per burst; a
        # perfectly rebalanced namespace drains in ~the mean
        saving = burst.elapsed_s - float(np.mean(burst.per_shard_s))
        if saving * self.horizon <= cost:
            return                              # the model says: not a win
        self.placement.commit(new_table)
        self.debt.add(cost)
        self._cooldown = self.cooldown
        self.events.append(MigrationEvent(
            burst=self._bursts, n_moved=int(len(moved)), cost_s=float(cost),
            imbalance_before=float(burst.imbalance),
            predicted_saving_s=float(saving), reason=reason))
        self.tracer.instant(
            "migration", track="controller", cat="controller",
            burst=self._bursts, n_moved=int(len(moved)),
            cost_s=float(cost), imbalance_before=float(burst.imbalance),
            reason=reason)
        self.tracer.metrics.counter("controller.migrations").inc()
        self.tracer.metrics.counter("controller.migration_cost_s").inc(
            float(cost))

    @property
    def n_migrations(self) -> int:
        return len(self.events)

    @property
    def total_migration_cost_s(self) -> float:
        return sum(e.cost_s for e in self.events)


@dataclasses.dataclass(frozen=True)
class RefreshEvent:
    """One committed topology re-admission."""

    burst: int
    n_moved: int
    cost_s: float
    predicted_saving_s: float       # per fold interval


class TopologyRefresher:
    """Online topology re-admission from measured page touches.

    The topology twin of `ShardRebalancer`: a `TieredTopologyStore` built
    with `admission="adaptive"` records every hop's touched edge pages into
    its own `TouchTable`; every `interval` priced bursts this controller
    folds the table and asks the store for a refreshed placement
    (`plan_refresh`) — measured-hot pages promoted into the GPU/host
    budgets, cold residents demoted to keep the budgets exact.  Promotion
    reads are priced through the same hop model the sampler pays, and the
    plan commits only when the modelled per-interval read-time saving over
    the horizon exceeds that cost.  Committed costs amortize into
    subsequent bursts like shard migrations."""

    def __init__(self, topo, *, interval: int = 8, horizon: int = 32,
                 cooldown: int = 2):
        if getattr(topo, "touches", None) is None:
            raise ValueError(
                "TopologyRefresher needs a feedback-enabled store — build "
                "it with admission='adaptive'")
        if interval < 1:
            raise ValueError(f"feedback interval must be >= 1, "
                             f"got {interval}")
        self.topo = topo
        self.interval = int(interval)
        self.horizon = int(horizon)
        self.cooldown = int(cooldown)
        self.debt = AmortizedCost(horizon)
        self.events: list[RefreshEvent] = []
        self.tracer = NULL_TRACER
        self._bursts = 0
        self._cooldown = 0

    def step(self) -> float:
        self._bursts += 1
        if self._bursts % self.interval == 0:
            self._consider()
        return self.debt.charge()

    def _consider(self) -> None:
        if self._cooldown > 0:
            self._cooldown -= 1
            self.topo.touches.fold()
            return
        plan = self.topo.plan_refresh()
        if plan is None:
            return
        assignment, n_moved, cost, saving = plan
        if saving * self.horizon <= cost:
            return
        self.topo.commit_refresh(assignment)
        self.debt.add(cost)
        self._cooldown = self.cooldown
        self.events.append(RefreshEvent(
            burst=self._bursts, n_moved=int(n_moved), cost_s=float(cost),
            predicted_saving_s=float(saving)))
        self.tracer.instant(
            "topo_refresh", track="controller", cat="controller",
            burst=self._bursts, n_moved=int(n_moved), cost_s=float(cost),
            predicted_saving_s=float(saving))
        self.tracer.metrics.counter("controller.refreshes").inc()
        self.tracer.metrics.counter("controller.refresh_cost_s").inc(
            float(cost))

    @property
    def n_refreshes(self) -> int:
        return len(self.events)


class QuotaController:
    """Online re-partitioning of per-tenant cache quotas from measured miss
    traffic.

    Watches a `TenantCacheTier`'s cumulative per-tenant hit/access counters;
    every `interval` served windows it computes each tenant's share of the
    interval's MISSES (the demand signal), EMA-smooths it, floors every
    tenant at `floor` so a quiet tenant is never squeezed to zero, and
    calls `TenantCacheTier.repartition` when the smoothed target moves any
    quota by more than `deadband`.  Repartitioning rebuilds partitions
    cold, a real cost paid in subsequent misses."""

    def __init__(self, tier, *, interval: int = 8, floor: float = 0.05,
                 alpha: float = 0.5, deadband: float = 0.05):
        if getattr(tier, "tenants", 1) < 2:
            raise ValueError("quota control needs at least two tenants")
        if not 0.0 < floor < 1.0 / tier.tenants:
            raise ValueError(
                f"floor {floor} must be in (0, 1/{tier.tenants}) so every "
                "tenant keeps a positive share with room to differentiate")
        self.tier = tier
        self.interval = int(interval)
        self.floor = float(floor)
        self.alpha = float(alpha)
        self.deadband = float(deadband)
        total = sum(tier.quotas)
        self.demand = np.array([q / total for q in tier.quotas], np.float64)
        self.events: list[tuple[int, tuple[float, ...]]] = []
        self._windows = 0
        self._snap = self._counters()
        self.tracer = NULL_TRACER

    def _counters(self) -> list[tuple[int, int]]:
        return [(c.stats.hits, c.stats.accesses)
                for c in self.tier.partitions]

    def step(self) -> bool:
        """One tick per served window; True iff a repartition committed."""
        self._windows += 1
        if self._windows % self.interval:
            return False
        now = self._counters()
        misses = np.array([(a1 - a0) - (h1 - h0)
                           for (h0, a0), (h1, a1)
                           in zip(self._snap, now)], np.float64)
        self._snap = now
        total = misses.sum()
        if total <= 0:
            return False
        self.demand = (1.0 - self.alpha) * self.demand \
            + self.alpha * (misses / total)
        share = self.demand / self.demand.sum()
        t = self.tier.tenants
        target = self.floor + (1.0 - t * self.floor) * share
        cur_total = sum(self.tier.quotas)
        current = np.array([q / cur_total for q in self.tier.quotas])
        if np.abs(target - current).max() < self.deadband:
            return False
        quotas = tuple(float(q) for q in target)
        self.tier.repartition(quotas)
        self.events.append((self._windows, quotas))
        self.tracer.instant(
            "quota_repartition", track="controller", cat="controller",
            window=self._windows, quotas=list(quotas))
        self.tracer.metrics.counter("controller.repartitions").inc()
        return True

    @property
    def n_repartitions(self) -> int:
        return len(self.events)
