"""Fault axis for the storage data plane, the port's copy of
`repro.core.faults`: seeded chaos, priced recovery.

The paper's premise is that thousands of in-flight GPU-initiated storage
accesses tolerate *latency* (Eq. 2-3), but every queue in the modelled plane
is healthy forever.  At terabyte scale shard stalls, tail blowups, and
device outages are the common case, and the max-over-shards burst pricing
means ONE degraded queue silently sets every batch's critical path.  This
module makes that failure mode explicit and priced:

  FaultSchedule  — a declarative, seeded schedule of fault events over
                   priced-burst intervals: per-shard brownouts (latency
                   multipliers), hard shard outages, and transient per-line
                   read failures, plus the retry/hedge policies that govern
                   recovery.
  FaultInjector  — plugs into `StorageTimeline`: every priced storage burst
                   ticks the schedule, and bursts with an active fault are
                   re-priced with capped exponential-backoff retries,
                   per-shard read deadlines, replica failover for dead
                   shards, and HEDGED READS — the straggling shard's
                   residual IOs duplicated to a replica once its drain
                   passes a latency quantile, completion at whichever copy
                   lands first.
  FailoverRouter — the plan-time half: reads whose primary shard is dead
                   (injector outage) or degraded (`ShardHealthMonitor` EMA,
                   core/feedback.py) are routed to the healthiest live
                   replica of a `ReplicatedPlacement` (core/sharding.py)
                   before the burst is even formed.

The invariant throughout: faults perturb *timing and routing only, never
data*.  Gathered features and sampled blocks are bit-identical to the
fault-free run (the injector only ever re-prices bursts and re-routes
queue assignments — bytes always come from the same feature rows), and a
burst with no active fault returns the clean price bit-for-bit, so a
fault-free schedule is indistinguishable from no schedule at all.

Determinism: transient-failure draws come from `default_rng([seed, burst,
shard])` — a pure function of the schedule seed and the burst index, never
of call order — so checkpoint/resume replays the exact retry and hedge
decisions (the injector's burst counter rides `state_dict`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .storage_sim import IO_BYTES, ShardedBurstResult, model_burst


# -- the schedule --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BrownoutEvent:
    """Shard `shard` drains `multiplier`x slower during bursts
    ``[start, end)`` — the browning-out device: thermal throttle, background
    GC, a neighbour saturating the channel."""

    shard: int
    start: int
    end: int
    multiplier: float

    def __post_init__(self) -> None:
        _check_interval(self, self.start, self.end)
        if self.multiplier < 1.0:
            raise ValueError(
                f"brownout multiplier must be >= 1 (got {self.multiplier}); "
                "a fault never speeds a queue up")


@dataclasses.dataclass(frozen=True)
class OutageEvent:
    """Shard `shard` serves NOTHING during bursts ``[start, end)`` — a dead
    device.  With replicas its reads fail over wholesale; without, they
    ladder through deadline-long retries until the device recovers."""

    shard: int
    start: int
    end: int

    def __post_init__(self) -> None:
        _check_interval(self, self.start, self.end)


@dataclasses.dataclass(frozen=True)
class FlakyReadsEvent:
    """During bursts ``[start, end)`` each of shard `shard`'s line reads
    fails independently with probability `fail_prob` per attempt (CRC
    errors, link resets) and is retried with capped exponential backoff."""

    shard: int
    start: int
    end: int
    fail_prob: float

    def __post_init__(self) -> None:
        _check_interval(self, self.start, self.end)
        if not 0.0 <= self.fail_prob < 1.0:
            raise ValueError(
                f"fail_prob must be in [0, 1) (got {self.fail_prob}); a "
                "read that always fails is an outage — use OutageEvent")


def _check_interval(event, start: int, end: int) -> None:
    if event.shard < 0:
        raise ValueError(f"{type(event).__name__} shard must be >= 0 "
                         f"(got {event.shard})")
    if start < 0 or end <= start:
        raise ValueError(
            f"{type(event).__name__} interval [{start}, {end}) is empty or "
            "negative — intervals are half-open in priced-burst indices")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Recovery pricing for failed reads: attempt k waits
    ``min(backoff_base * 2^(k-1), backoff_cap)`` then re-drains the failed
    lines; after `max_retries` the final attempt always succeeds (faults
    cost time, never data).  `read_deadline_s` caps how long any shard's
    reads are waited on before recovery engages — it bounds when a hedge
    fires and prices each attempt against a dead shard."""

    max_retries: int = 3
    backoff_base_s: float = 20e-6
    backoff_cap_s: float = 500e-6
    read_deadline_s: float = 2e-3

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.backoff_base_s < 0 or self.backoff_cap_s < self.backoff_base_s:
            raise ValueError(
                f"backoff cap {self.backoff_cap_s} must be >= base "
                f"{self.backoff_base_s} >= 0")


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """Hedged reads: once the straggling shard's drain passes
    ``factor * quantile(per-shard drains, quantile)`` (capped by the read
    deadline), its residual IOs are duplicated to its least-loaded live
    replica and the shard completes at whichever copy lands first.  Hedging
    needs replicas (`ReplicatedPlacement`) and engages only on bursts with
    an active fault — a healthy plane never pays duplicate IOs."""

    quantile: float = 0.5
    factor: float = 2.0

    def __post_init__(self) -> None:
        if not 0.0 <= self.quantile <= 1.0:
            raise ValueError(f"hedge quantile must be in [0, 1], "
                             f"got {self.quantile}")
        if self.factor < 1.0:
            raise ValueError(f"hedge factor must be >= 1, got {self.factor}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A seeded, declarative fault schedule: WHAT goes wrong WHEN (event
    intervals in priced-burst indices) and how recovery is priced (retry /
    hedge policies).  Immutable and cheap to share across planes; the
    mutable run state (burst counter, telemetry) lives on `FaultInjector`."""

    events: tuple = ()
    retry: RetryPolicy = RetryPolicy()
    hedge: HedgePolicy | None = HedgePolicy()
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if not isinstance(ev, (BrownoutEvent, OutageEvent,
                                   FlakyReadsEvent)):
                raise TypeError(
                    f"unknown fault event {type(ev).__name__}; schedule "
                    "events are BrownoutEvent / OutageEvent / "
                    "FlakyReadsEvent")

    @property
    def max_shard(self) -> int:
        return max((ev.shard for ev in self.events), default=-1)

    def any_active(self, burst: int) -> bool:
        return any(ev.start <= burst < ev.end for ev in self.events)


@dataclasses.dataclass(frozen=True)
class FaultedBurstResult(ShardedBurstResult):
    """A `ShardedBurstResult` re-priced under active faults.  Inherited
    `per_shard_s` are the EFFECTIVE drains (after brownout, retries,
    failover, hedging); `clean_per_shard_s` keeps the fault-free drains so
    telemetry can show what the fault cost and what recovery bought back."""

    burst_index: int = -1
    clean_per_shard_s: tuple = ()
    retried_lines: tuple = ()       # per-shard lines re-read by the ladder
    failed_over_lines: tuple = ()   # per-shard lines served by a replica
    hedged_shard: int = -1          # straggler whose residual was duplicated
    hedge_replica: int = -1         # replica that absorbed the hedge
    hedged_lines: int = 0
    hedge_saving_s: float = 0.0

    def recovery_events(self) -> list[tuple[str, int, dict]]:
        """The burst's recovery actions as ``(kind, shard, args)`` rows —
        the tracer renders them as fault sub-events on the shard's track,
        and the metrics registry counts them.  ``recovery_s`` in the args
        is each shard's effective-minus-clean drain: the time the fault
        actually added on that queue after recovery."""
        events: list[tuple[str, int, dict]] = []

        def extra_s(shard: int) -> float:
            if shard < len(self.clean_per_shard_s):
                return max(0.0, self.per_shard_s[shard]
                           - self.clean_per_shard_s[shard])
            return 0.0

        for shard, lines in enumerate(self.retried_lines):
            if lines:
                events.append(("retry", shard, {
                    "lines": int(lines), "recovery_s": extra_s(shard)}))
        for shard, lines in enumerate(self.failed_over_lines):
            if lines:
                events.append(("failover", shard, {
                    "lines": int(lines), "recovery_s": extra_s(shard)}))
        if self.hedged_shard >= 0:
            events.append(("hedge", int(self.hedged_shard), {
                "lines": int(self.hedged_lines),
                "replica": int(self.hedge_replica),
                "saving_s": float(self.hedge_saving_s)}))
        return events


class FaultInjector:
    """Mutable fault-plane run state: ticks the schedule once per priced
    storage burst and re-prices faulted bursts (see `price_burst`).  The
    burst counter is the only state recovery decisions depend on, and it
    rides `state_dict` — resume replays the same retries and hedges."""

    def __init__(self, schedule: FaultSchedule, n_shards: int,
                 replication: int = 1):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if schedule.max_shard >= n_shards:
            raise ValueError(
                f"fault schedule targets shard {schedule.max_shard} but the "
                f"plane has {n_shards} shard(s) — the event would never "
                "fire; fix the schedule or the plane")
        if replication > n_shards:
            raise ValueError(
                f"replication {replication} exceeds n_shards {n_shards}")
        self.schedule = schedule
        self.n_shards = int(n_shards)
        self.replication = max(int(replication), 1)
        self.reset()

    def reset(self) -> None:
        self._burst = 0
        self.n_faulted_bursts = 0
        self.n_retries = 0
        self.n_retried_lines = 0
        self.n_hedged_bursts = 0
        self.n_hedged_lines = 0
        self.n_failed_over_lines = 0
        self.hedge_saving_s = 0.0
        self.first_hedge_burst = -1
        self.first_failover_burst = -1

    @property
    def burst(self) -> int:
        """Index of the NEXT burst to be priced — what plan-time routing
        (`FailoverRouter`) peeks at before pricing ticks it."""
        return self._burst

    def replica_shards(self, shard: int) -> tuple[int, ...]:
        """The replica queues holding shard `shard`'s rows: replica j of a
        row lives on ``(primary + j) % n_shards`` — the same rule
        `ReplicatedPlacement.replicas_of` applies per node, so burst-level
        recovery and plan-level routing agree."""
        return tuple((int(shard) + j) % self.n_shards
                     for j in range(1, self.replication))

    def _active(self, burst: int):
        mult = np.ones(self.n_shards, np.float64)
        outage = np.zeros(self.n_shards, bool)
        pfail = np.zeros(self.n_shards, np.float64)
        for ev in self.schedule.events:
            if not ev.start <= burst < ev.end:
                continue
            if isinstance(ev, BrownoutEvent):
                mult[ev.shard] *= ev.multiplier
            elif isinstance(ev, OutageEvent):
                outage[ev.shard] = True
            else:
                pfail[ev.shard] = 1.0 - (1.0 - pfail[ev.shard]) \
                    * (1.0 - ev.fail_prob)
        return mult, outage, pfail

    def outage_shards(self, burst: int | None = None) -> tuple[int, ...]:
        b = self._burst if burst is None else burst
        return tuple(ev.shard for ev in self.schedule.events
                     if isinstance(ev, OutageEvent) and ev.start <= b < ev.end)

    def price_burst(self, specs, clean: ShardedBurstResult,
                    bytes_per_row: int,
                    io_bytes: int = IO_BYTES) -> ShardedBurstResult:
        """Re-price one storage burst under the schedule, ticking it.

        A quiet burst (no active event) returns `clean` — the same object,
        the same floats — which is what keeps a fault-free schedule
        bit-identical to no schedule.  A faulted burst is re-priced shard
        by shard: brownout multipliers first, then outage failover (a dead
        shard's lines drain on its least-loaded live replica; with no
        replicas the reads ladder through deadline-long attempts), then the
        transient-failure retry ladder (seeded binomial failure counts,
        capped exponential backoff, the failed lines re-drained at the
        shard's own Eq. 2-3 efficiency), and finally a hedged read for the
        straggler.  Only times and routing change — rows and lines are the
        clean burst's."""
        b = self._burst
        self._burst += 1
        mult, outage, pfail = self._active(b)
        if not (outage.any() or (mult != 1.0).any() or (pfail > 0.0).any()):
            return clean
        self.n_faulted_bursts += 1
        retry = self.schedule.retry
        rows = np.asarray(clean.per_shard_rows, np.int64)
        lines = np.asarray(clean.per_shard_lines, np.int64)
        t = np.asarray(clean.per_shard_s, np.float64) * mult
        n = len(t)
        extra_bytes = 0
        retried = np.zeros(n, np.int64)
        failed_over = np.zeros(n, np.int64)

        clean_t = np.asarray(clean.per_shard_s, np.float64)
        shard_bytes = np.minimum(rows * int(bytes_per_row),
                                 lines * int(io_bytes)).astype(np.float64)
        # recovery IOs (retries, failover, hedges) are GPU-initiated like
        # every other access: they join the burst's in-flight pool, so an
        # idle queue serves them at the Eq. 2-3 efficiency of the whole
        # burst's concurrency — never at the tiny recovery sub-burst's own
        concurrency = max(int(rows.sum()), 1)

        def drain_s(src: int, dst: int, n_lines: int) -> float:
            """Price `n_lines` of shard `src`'s IOs re-issued on queue
            `dst`: the bytes are the source's clean byte share of those
            lines (the same row-vs-line min() the clean burst paid), served
            at the destination queue's effective bandwidth — measured from
            its own clean drain when it is busy this burst, modelled at the
            burst's concurrency when idle — under the destination's
            brownout multiplier."""
            if n_lines <= 0 or lines[src] <= 0:
                return 0.0
            bytes_moved = shard_bytes[src] * (n_lines / float(lines[src]))
            if clean_t[dst] > 0 and shard_bytes[dst] > 0:
                bw = shard_bytes[dst] / clean_t[dst]
            else:
                spec = specs[dst]
                bw = spec.peak_bw * model_burst(spec,
                                                concurrency).efficiency
            return bytes_moved / bw * float(mult[dst])

        for s in np.nonzero(outage & (rows > 0))[0]:
            s = int(s)
            live = [r for r in self.replica_shards(s)
                    if not outage[r] and r != s]
            if live:
                r = min(live, key=lambda q: t[q])
                t[r] += drain_s(s, r, int(lines[s]))
                t[s] = 0.0
                failed_over[s] = lines[s]
                extra_bytes += int(lines[s]) * io_bytes
                self.n_failed_over_lines += int(lines[s])
                if self.first_failover_burst < 0:
                    self.first_failover_burst = b
            else:
                # nowhere to go: every read ladders through deadline-capped
                # attempts and completes when the device recovers
                t[s] += retry.read_deadline_s * (retry.max_retries + 1)

        for s in np.nonzero((pfail > 0.0) & ~outage & (lines > 0))[0]:
            s = int(s)
            rng = np.random.default_rng([self.schedule.seed, b, s])
            fail = int(rng.binomial(int(lines[s]), pfail[s]))
            k = 0
            while fail > 0 and k < retry.max_retries:
                k += 1
                backoff = min(retry.backoff_base_s * 2.0 ** (k - 1),
                              retry.backoff_cap_s)
                t[s] += backoff + drain_s(s, s, fail)
                retried[s] += fail
                self.n_retries += 1
                fail = int(rng.binomial(fail, pfail[s]))
            self.n_retried_lines += int(retried[s])

        hedged_shard = hedge_replica = -1
        hedged_lines = 0
        hedge_saving = 0.0
        hedge = self.schedule.hedge
        if hedge is not None and self.replication > 1:
            busy = t[(rows > 0) & (t > 0.0)]
            if len(busy) >= 2:
                thr = hedge.factor * float(np.quantile(busy, hedge.quantile))
                if retry.read_deadline_s > 0:
                    thr = min(thr, retry.read_deadline_s)
                s = int(np.argmax(t))
                if t[s] > thr and not outage[s] and lines[s] > 0:
                    live = [r for r in self.replica_shards(s)
                            if not outage[r] and r != s]
                    if live:
                        r = min(live, key=lambda q: t[q])
                        resid = int(np.ceil(lines[s] * (t[s] - thr) / t[s]))
                        # duplicated IOs queue behind the replica's own burst
                        done = max(thr, float(t[r])) + drain_s(s, r, resid)
                        if done < t[s]:
                            hedge_saving = float(t[s]) - done
                            t[s] = done
                            hedged_shard, hedge_replica = s, r
                            hedged_lines = resid
                            extra_bytes += resid * io_bytes
                            self.n_hedged_bursts += 1
                            self.n_hedged_lines += resid
                            self.hedge_saving_s += hedge_saving
                            if self.first_hedge_burst < 0:
                                self.first_hedge_burst = b

        return FaultedBurstResult(
            per_shard_s=tuple(float(x) for x in t),
            per_shard_rows=clean.per_shard_rows,
            per_shard_lines=clean.per_shard_lines,
            spec_names=clean.spec_names,
            ssd_bytes=int(clean.ssd_bytes) + extra_bytes,
            burst_index=b,
            clean_per_shard_s=clean.per_shard_s,
            retried_lines=tuple(int(x) for x in retried),
            failed_over_lines=tuple(int(x) for x in failed_over),
            hedged_shard=hedged_shard, hedge_replica=hedge_replica,
            hedged_lines=hedged_lines, hedge_saving_s=float(hedge_saving))

    # -- checkpoint ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"n_shards": self.n_shards, "seed": self.schedule.seed,
                "replication": self.replication, "burst": self._burst,
                "n_faulted_bursts": self.n_faulted_bursts,
                "n_retries": self.n_retries,
                "n_retried_lines": self.n_retried_lines,
                "n_hedged_bursts": self.n_hedged_bursts,
                "n_hedged_lines": self.n_hedged_lines,
                "n_failed_over_lines": self.n_failed_over_lines,
                "hedge_saving_s": self.hedge_saving_s,
                "first_hedge_burst": self.first_hedge_burst,
                "first_failover_burst": self.first_failover_burst}

    def load_state_dict(self, state: dict) -> None:
        if int(state.get("n_shards", self.n_shards)) != self.n_shards \
                or int(state.get("seed", self.schedule.seed)) \
                != self.schedule.seed \
                or int(state.get("replication", self.replication)) \
                != self.replication:
            raise ValueError(
                f"fault-injector checkpoint ({state.get('n_shards')} shards, "
                f"seed {state.get('seed')}, x{state.get('replication')}) "
                f"does not match this plane ({self.n_shards} shards, seed "
                f"{self.schedule.seed}, x{self.replication}) — resumed "
                "retry/hedge decisions would diverge")
        self._burst = int(state["burst"])
        self.n_faulted_bursts = int(state.get("n_faulted_bursts", 0))
        self.n_retries = int(state.get("n_retries", 0))
        self.n_retried_lines = int(state.get("n_retried_lines", 0))
        self.n_hedged_bursts = int(state.get("n_hedged_bursts", 0))
        self.n_hedged_lines = int(state.get("n_hedged_lines", 0))
        self.n_failed_over_lines = int(state.get("n_failed_over_lines", 0))
        self.hedge_saving_s = float(state.get("hedge_saving_s", 0.0))
        self.first_hedge_burst = int(state.get("first_hedge_burst", -1))
        self.first_failover_burst = int(state.get("first_failover_burst", -1))


class FailoverRouter:
    """Plan-time read rerouting over a `ReplicatedPlacement`.

    `route` rewrites the per-node shard assignment BEFORE the burst forms:
    nodes whose primary shard is dead (an injector outage active at the
    burst about to be priced) or degraded (flagged by the
    `ShardHealthMonitor`) are sent to their healthiest live replica —
    lowest monitor EMA among the node's replica shards, nearest replica
    when no monitor is wired.  Nodes with no live replica keep their
    primary (the burst pricing then charges the outage ladder).

    Routing only moves reads between queues that hold the same bytes, so
    gathered features are untouched; with no bad shards the primary
    assignment is returned as-is — a healthy plane routes bit-identically
    to an unrouted one."""

    def __init__(self, placement, monitor=None, injector=None):
        if not hasattr(placement, "replicas_of"):
            raise ValueError(
                "FailoverRouter needs a replicated placement "
                f"(got {getattr(placement, 'name', None)!r}) — wrap the "
                "policy in ReplicatedPlacement (replication_factor >= 2)")
        self.placement = placement
        self.monitor = monitor
        self.injector = injector
        self.n_rerouted = 0
        self.first_reroute_burst = -1

    def bad_shards(self) -> frozenset[int]:
        bad = set()
        if self.injector is not None:
            bad.update(self.injector.outage_shards())
        if self.monitor is not None:
            bad.update(int(s) for s in self.monitor.degraded())
        return frozenset(bad)

    def route(self, node_ids: np.ndarray,
              primary: np.ndarray) -> np.ndarray:
        bad = self.bad_shards()
        if not bad:
            return primary
        primary = np.asarray(primary, np.int16)
        bad_arr = np.fromiter(bad, np.int16, len(bad))
        mask = np.isin(primary, bad_arr)
        if not mask.any():
            return primary
        reps = self.placement.replicas_of(np.asarray(node_ids)[mask])
        choice = reps[:, 0].astype(np.int16)        # no live replica: stay
        best = np.full(len(choice), np.inf)
        ema = self.monitor.ema if self.monitor is not None else None
        for j in range(1, reps.shape[1]):
            cand = reps[:, j]
            ok = ~np.isin(cand.astype(np.int16), bad_arr)
            score = ema[cand] if ema is not None \
                else np.full(len(cand), float(j))
            take = ok & (score < best)
            choice[take] = cand[take].astype(np.int16)
            best[take] = score[take]
        routed = primary.copy()
        routed[mask] = choice
        moved = int(np.count_nonzero(routed != primary))
        if moved:
            self.n_rerouted += moved
            if self.first_reroute_burst < 0:
                self.first_reroute_burst = (self.injector.burst
                                            if self.injector is not None
                                            else 0)
        return routed
