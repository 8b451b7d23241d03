"""Storage device models (paper §4.2, Table 1 constants): the port's copy
of `repro.core.storage_sim`.

The constants are the reference's, verbatim, so every priced time is
bit-identical to it.  They are the paper's A100 and SSD figures: the prices
are a model of that system, not a measurement of the card the port runs on.
Besides the single-queue pricing this holds the sharded namespace's
per-shard bursts (`coalesce_lines_by_shard`, `price_sharded_burst`), the
cluster's host bursts (`StorageTimeline.price_host_burst`), migration
pricing, the fault injector's seam (`StorageTimeline.injector`) and the
metrics registry every priced burst folds its telemetry into
(`StorageTimeline.metrics`, wired by an enabled tracer).

Units: seconds, bytes.  IO granularity is the paper's 4 KB cache line.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    name: str
    peak_iops: float          # 4KB reads / s / SSD
    latency_s: float          # device read latency
    latency_cv: float = 0.15  # coefficient of variation for the event sim

    @property
    def peak_bw(self) -> float:
        return self.peak_iops * IO_BYTES


IO_BYTES = 4096
# Paper §4.2: Optane 1.5M IOPs / 11us; 980Pro 700K IOPs / 324us.
# +25us kernel-launch/init overhead (T_i add-on), 5us termination.
INTEL_OPTANE = SSDSpec("intel-optane", peak_iops=1.5e6, latency_s=11e-6)
SAMSUNG_980PRO = SSDSpec("samsung-980pro", peak_iops=0.7e6, latency_s=324e-6)
T_INIT_SW = 25e-6
T_TERM = 5e-6

PCIE_GEN4_BW = 32e9          # GPU ingress (paper: ~32 GB/s)
HOST_DRAM_BW = 100e9         # constant-buffer service bandwidth
HBM_BW = 1555e9              # A100 HBM2 (Table 1)
# OS page-fault cost dominating the mmap baseline (~few us of kernel time per
# fault plus readahead pollution); calibrated so the mmap baseline reproduces
# the paper's Fig. 5 stage breakdown shape.
MMAP_FAULT_OVERHEAD_S = 4e-6
# -- topology (sampling-stage) constants ---------------------------------------
# CPU-sampling baseline (paper Fig. 3/7: the "CPU sampling" path): adjacency
# reads are dependent pointer chases — one random DRAM access each — spread
# across a thread pool, and every hop ends in a host->device handoff.
HOST_RANDOM_READ_S = 100e-9  # random DRAM access (row miss + pointer chase)
CPU_SAMPLE_THREADS = 16
HOP_SYNC_S = 10e-6           # per-hop CPU->GPU handoff (copy launch + sync)
# GPU-initiated sampling pays one kernel launch per hop; device reads inside
# the hop are covered by the tier terms of `price_topology_hop`.
TOPO_HOP_LAUNCH_S = 5e-6


@dataclasses.dataclass
class BurstResult:
    n_requests: int
    elapsed_s: float
    achieved_iops_per_ssd: float
    efficiency: float  # achieved / peak


def model_burst(spec: SSDSpec, n_requests: int, n_ssd: int = 1) -> BurstResult:
    """Paper Eq. 2-3 analytic model: a burst of `n_requests` concurrent
    accesses spends T_i (latency+sw init) + T_s (steady drain at peak IOPs)
    + T_t; efficiency = T_s / total."""
    t_i = spec.latency_s + T_INIT_SW
    t_s = n_requests / (spec.peak_iops * n_ssd)
    total = t_i + t_s + T_TERM
    achieved = n_requests / (total * n_ssd)
    return BurstResult(n_requests, total, achieved, achieved / spec.peak_iops)


def required_accesses(spec: SSDSpec, target_efficiency: float,
                      n_ssd: int = 1) -> int:
    """Invert Eq. 2-3: N = rho * peak * (T_i + T_t) * n_ssd / (1 - rho)."""
    rho = min(target_efficiency, 0.999)
    t_fixed = spec.latency_s + T_INIT_SW + T_TERM
    return int(np.ceil(rho * spec.peak_iops * n_ssd * t_fixed / (1.0 - rho)))


def simulate_burst(spec: SSDSpec, n_requests: int, n_ssd: int = 1,
                   queue_depth: int | None = None, seed: int = 0
                   ) -> BurstResult:
    """Discrete-event validation of the analytic model ("measured" curve of
    Fig. 8): per-request latency ~ N(lat, cv*lat); each SSD drains its queue
    at peak_iops once requests arrive; queue_depth limits in-flight requests
    (defaults to all — BaM-style massive concurrency)."""
    rng = np.random.default_rng(seed)
    qd = queue_depth or n_requests
    per_ssd = np.array_split(np.arange(n_requests), n_ssd)
    worst = 0.0
    for reqs in per_ssd:
        n = len(reqs)
        if n == 0:
            continue
        service = 1.0 / spec.peak_iops
        lat = np.maximum(rng.normal(spec.latency_s,
                                    spec.latency_cv * spec.latency_s, n), 0)
        # in-flight window of qd: request i issues when completion i-qd done
        complete = np.zeros(n)
        next_free = 0.0  # device channel availability
        for i in range(n):
            issue = T_INIT_SW if i < qd else complete[i - qd]
            start_service = max(issue + lat[i], next_free)
            next_free = start_service + service
            complete[i] = start_service + service
        worst = max(worst, complete[-1] + T_TERM)
    achieved = n_requests / (worst * n_ssd)
    return BurstResult(n_requests, worst, achieved, achieved / spec.peak_iops)


def coalesce_lines(node_ids: np.ndarray, bytes_per_row: int,
                   io_bytes: int = IO_BYTES,
                   shard: np.ndarray | None = None) -> int:
    """Number of `io_bytes`-granule IOs needed to fetch the given storage
    rows, assuming rows are laid out contiguously by node id (the storage
    namespace is the feature array itself).

    Rows narrower than one IO line share it: a 256-dim float32 row is 1 KB,
    so 4 consecutive rows ride one 4 KB line and the merged executor issues
    a single IO for all of them (`rows_per_line = io_bytes // bytes_per_row`,
    row-aligned — a row never straddles two lines in this model).  Rows at
    or above the line size cost `ceil(bytes_per_row / io_bytes)` IOs each
    and nothing coalesces.

    With `shard` (per-row shard ids from a sharded storage tier) coalescing
    is SHARD-LOCAL: the line key is the `(shard, line)` tuple, because two
    rows that share a logical 4 KB line but live on different devices are
    two physical IOs — one per queue — and merging them would under-price
    every sharded plane."""
    n = len(node_ids)
    if n == 0 or bytes_per_row <= 0:
        return 0
    if bytes_per_row >= io_bytes:
        return n * int(-(-bytes_per_row // io_bytes))
    rows_per_line = io_bytes // bytes_per_row
    if rows_per_line <= 1:
        return n
    lines = np.asarray(node_ids, np.int64) // rows_per_line
    if shard is None:
        return len(np.unique(lines))
    key = np.asarray(shard, np.int64) * (int(lines.max()) + 1) + lines
    return len(np.unique(key))


def coalesce_lines_by_shard(node_ids: np.ndarray, shard: np.ndarray,
                            n_shards: int, bytes_per_row: int,
                            io_bytes: int = IO_BYTES) -> np.ndarray:
    """Per-shard 4 KB IO counts after shard-local coalescing, (n_shards,).
    Sums to `coalesce_lines(..., shard=shard)`; feeds the per-shard queue
    drain in `price_sharded_burst`.  One vectorized (shard, line) unique +
    bincount pass — no per-shard rescans."""
    shard = np.asarray(shard)
    node_ids = np.asarray(node_ids, np.int64)
    n = len(node_ids)
    if n == 0 or bytes_per_row <= 0:
        return np.zeros(n_shards, np.int64)
    if bytes_per_row >= io_bytes:
        per_row = int(-(-bytes_per_row // io_bytes))
        return np.bincount(shard, minlength=n_shards).astype(np.int64) \
            * per_row
    rows_per_line = io_bytes // bytes_per_row
    if rows_per_line <= 1:
        return np.bincount(shard, minlength=n_shards).astype(np.int64)
    lines = node_ids // rows_per_line
    stride = int(lines.max()) + 1
    key = shard.astype(np.int64) * stride + lines
    uniq = np.unique(key)
    return np.bincount(uniq // stride, minlength=n_shards).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ShardedBurstResult:
    """Per-shard drain telemetry for one storage burst over a sharded
    namespace.  `elapsed_s` is the max over shards — the slowest queue sets
    the critical path — and `straggler` names which shard that was, so
    placement skew and heterogeneous devices are measurable, not just
    modelled."""

    per_shard_s: tuple[float, ...]
    per_shard_rows: tuple[int, ...]
    per_shard_lines: tuple[int, ...]
    spec_names: tuple[str, ...]
    ssd_bytes: int                    # total line-capped transfer bytes

    @property
    def n_shards(self) -> int:
        return len(self.per_shard_s)

    @property
    def elapsed_s(self) -> float:
        return max(self.per_shard_s) if self.per_shard_s else 0.0

    @property
    def straggler(self) -> int:
        """Index of the shard whose queue drained last."""
        return int(np.argmax(self.per_shard_s)) if self.per_shard_s else 0

    @property
    def straggler_spec(self) -> str:
        return self.spec_names[self.straggler] if self.spec_names else ""

    @property
    def imbalance(self) -> float:
        """Queue imbalance: slowest shard's drain over the mean drain.  1.0
        = perfectly balanced; the modelled speedup lost to placement skew or
        a straggler device."""
        mean = float(np.mean(self.per_shard_s)) if self.per_shard_s else 0.0
        return self.elapsed_s / mean if mean > 0 else 1.0


@dataclasses.dataclass(frozen=True)
class HostBurstResult(ShardedBurstResult):
    """A sharded burst priced at HOST granularity (core/hosts.py): each
    shard is a host whose drain composes its LOCAL storage queue with the
    link transit of the 4 KB lines other hosts requested from it.
    `per_shard_s` already includes the link term — `elapsed_s`, straggler
    and imbalance telemetry therefore see network skew, not just device
    skew.  `local_s`/`link_s` split each host's drain into the two
    components, and `local_burst` keeps the pre-link result (including any
    `FaultedBurstResult` retry/failover telemetry) intact."""

    link_s: tuple[float, ...] = ()
    local_s: tuple[float, ...] = ()
    remote_lines: tuple[int, ...] = ()
    local_burst: ShardedBurstResult | None = None

    @property
    def remote_fraction(self) -> float:
        """Share of this burst's 4 KB lines that crossed a host link."""
        lines = sum(self.per_shard_lines)
        return sum(self.remote_lines) / lines if lines else 0.0


def price_sharded_burst(specs, shard_rows, shard_lines, bytes_per_row: int,
                        io_bytes: int = IO_BYTES,
                        shard_outstanding=None) -> ShardedBurstResult:
    """Price one storage burst over a sharded namespace: each shard drains
    its OWN queue at its OWN `SSDSpec` (Eq. 2-3 efficiency from that queue's
    concurrency alone — outstanding requests on shard a do not help shard b
    ramp), and the burst completes at the max over shards.

    `shard_rows` / `shard_lines` are per-shard unique storage row and
    coalesced 4 KB IO counts (`coalesce_lines_by_shard`); per-shard transfer
    is capped at line granularity exactly like the unsharded
    `price_merged_burst` accounting.  `shard_outstanding` overrides the
    per-shard queue depth used for the efficiency ramp (defaults to each
    shard's actual row count — the burst's real concurrency)."""
    specs = tuple(specs)
    shard_rows = tuple(int(r) for r in shard_rows)
    shard_lines = tuple(int(l) for l in shard_lines)
    if not (len(specs) == len(shard_rows) == len(shard_lines)):
        raise ValueError(
            f"shard arity mismatch: {len(specs)} specs, {len(shard_rows)} "
            f"row counts, {len(shard_lines)} line counts")
    if shard_outstanding is None:
        shard_outstanding = shard_rows
    per_shard_s, total_bytes = [], 0
    for spec, rows, lines, out in zip(specs, shard_rows, shard_lines,
                                      shard_outstanding):
        if rows <= 0:
            per_shard_s.append(0.0)
            continue
        eff = model_burst(spec, max(int(out), 1), n_ssd=1).efficiency
        ssd_bytes = min(rows * bytes_per_row, lines * io_bytes)
        total_bytes += ssd_bytes
        per_shard_s.append(ssd_bytes / (spec.peak_bw * eff))
    return ShardedBurstResult(
        per_shard_s=tuple(per_shard_s), per_shard_rows=shard_rows,
        per_shard_lines=shard_lines,
        spec_names=tuple(s.name for s in specs), ssd_bytes=total_bytes)


def host_sampling_hop_time(n_edge_reads: int, n_frontier: int,
                           id_bytes: int = 8,
                           threads: int = CPU_SAMPLE_THREADS) -> float:
    """One hop of the CPU-sampling baseline: `n_edge_reads` sampled
    adjacency words plus the indptr pair per frontier node, each a random
    DRAM access amortized over `threads`; the sampled block ships to the
    device over PCIe and the hop ends in one host->device handoff.  The
    GPU-tiered counterpart is `StorageTimeline.price_topology_hop` — the
    fig7 sampling benchmark compares the two on identical hops."""
    if n_edge_reads <= 0 and n_frontier <= 0:
        return 0.0
    reads = n_edge_reads + 2 * n_frontier
    t_cpu = reads * HOST_RANDOM_READ_S / max(threads, 1)
    t_xfer = n_edge_reads * id_bytes / PCIE_GEN4_BW
    return t_cpu + t_xfer + HOP_SYNC_S


def overlap_exposed(prep_s: float, compute_s: float) -> float:
    """max(0, prep - compute): the prep time left on the critical path after
    `compute_s` seconds of concurrent model compute hid the rest.  Pure —
    `StorageTimeline.price_batch_overlapped` and the serve engine's
    admission pricing share it."""
    return max(0.0, prep_s - max(compute_s, 0.0))


class StorageTimeline:
    """Accumulates modelled time for a training run (Fig. 13/14 E2E bench).

    Serves batches of requests split across tiers; returns elapsed time for
    the storage portion assuming perfect overlap within a batch (GIDS) or
    serial page-fault handling (mmap baseline).

    With `shard_specs` set (the loader wires it from a `ShardedStorageTier`
    backstop) the storage portion is priced per shard — each shard drains
    its own queue at its own device and the batch completes at the max over
    shards — and `shard_burst` keeps the most recent per-shard drain
    telemetry (`ShardedBurstResult`: straggler shard, queue imbalance).
    With a `MetricsRegistry` attached on `metrics` (the tracer wires one),
    every priced burst also folds its telemetry into the registry —
    observation only, never feeding back into pricing.
    """

    def __init__(self, spec: SSDSpec, n_ssd: int = 1, shard_specs=None):
        self.spec, self.n_ssd = spec, n_ssd
        self.shard_specs = tuple(shard_specs) if shard_specs else None
        self._shard_burst: ShardedBurstResult | None = None
        # observability plane (repro_torch.obs): an attached
        # MetricsRegistry receives per-burst telemetry via `_note_burst`;
        # None records nothing (the default, and the no-op tracer's path)
        self.metrics = None
        # multi-host plane (core/hosts.py): when the loader wires a tuple of
        # HostLinkSpec here, sharded bursts route through `price_host_burst`
        # — each shard is a host and remote lines pay its link; None keeps
        # every price on the single-host path
        self.host_specs = None
        # fault plane (core/faults.py): when a FaultInjector is attached,
        # every priced storage burst ticks its schedule and faulted bursts
        # are re-priced with retries / failover / hedging; None (the
        # default) leaves every price bit-identical to the fault-free plane
        self.injector = None

    # -- burst telemetry ---------------------------------------------------
    @property
    def shard_burst(self) -> ShardedBurstResult | None:
        """Most recent per-shard drain telemetry (supported accessor)."""
        return self._shard_burst

    @property
    def host_burst(self) -> "HostBurstResult | None":
        """The last burst, iff it was priced at host granularity."""
        burst = self._shard_burst
        return burst if isinstance(burst, HostBurstResult) else None

    def reset_telemetry(self) -> None:
        """Drop cross-burst telemetry (checkpoint restore calls this so a
        resumed run never reports the pre-restore epoch's last burst)."""
        self._shard_burst = None

    def _note_burst(self, burst: ShardedBurstResult) -> None:
        """Record one priced burst: keeps the `shard_burst` accessor fresh
        and, when a registry is attached, folds imbalance / remote-traffic /
        fault-recovery telemetry into it.  Observation only — pricing never
        reads anything written here."""
        self._shard_burst = burst
        m = self.metrics
        if m is None:
            return
        m.counter("storage.bursts").inc()
        m.counter("storage.ssd_bytes").inc(burst.ssd_bytes)
        m.histogram("storage.imbalance").observe(burst.imbalance)
        m.gauge("storage.last_straggler").set(burst.straggler)
        if isinstance(burst, HostBurstResult):
            m.histogram("hosts.remote_fraction").observe(
                burst.remote_fraction)
            m.counter("hosts.remote_lines").inc(sum(burst.remote_lines))
            m.counter("hosts.link_s").inc(sum(burst.link_s))
        fault_src = getattr(burst, "local_burst", None) or burst
        recovery = getattr(fault_src, "recovery_events", None)
        if callable(recovery):
            for kind, shard, args in recovery():
                m.counter(f"faults.{kind}_events").inc()
                if "lines" in args:
                    m.counter(f"faults.{kind}_lines").inc(args["lines"])
                if "saving_s" in args:
                    m.counter("faults.hedge_saving_s").inc(args["saving_s"])

    def _fault_adjust(self, burst: ShardedBurstResult,
                      bytes_per_row: int,
                      io_bytes: int = IO_BYTES) -> ShardedBurstResult:
        """Run one priced burst through the attached fault injector (no-op
        without one — the same object comes back, floats untouched)."""
        if self.injector is None:
            return burst
        specs = self.shard_specs or (self.spec,) * burst.n_shards
        return self.injector.price_burst(specs, burst, bytes_per_row,
                                         io_bytes)

    def price_host_burst(self, shard_rows, shard_lines, bytes_per_row: int,
                         io_bytes: int = IO_BYTES, shard_outstanding=None,
                         remote_lines=None) -> HostBurstResult:
        """Price one burst over a CLUSTER (core/hosts.py): shard h is a
        host, whose drain composes its local storage burst with a link-
        transit term, and the burst completes at the max over hosts.

        Each host first drains its local queue exactly like
        `price_sharded_burst` (same per-queue Eq. 2-3 efficiency, same line
        cap, same fault adjustment), then ships the `remote_lines[h]` 4 KB
        lines that OTHER hosts requested from it over its own link:

            t_h = t_local_h + (rtt_h + remote_lines[h] * io / link_bw_h)

        with the link term added only when remote lines exist — a host
        serving purely local traffic prices bit-identically to the single-
        host sharded path (float-for-float: `t + 0.0` is never computed).
        A 1-host cluster therefore reproduces the sharded plane exactly, and
        the metis-lite-vs-hash benchmark measures exactly the cross-host
        line traffic the placement was supposed to remove."""
        hosts = self.host_specs
        if hosts is None:
            raise ValueError(
                "price_host_burst needs host_specs wired — only host-"
                "storage planes (core/hosts.py) price over links")
        specs = self.shard_specs or tuple(
            (h.ssd if h.ssd is not None else self.spec) for h in hosts)
        local = price_sharded_burst(specs, shard_rows, shard_lines,
                                    bytes_per_row, io_bytes,
                                    shard_outstanding)
        local = self._fault_adjust(local, bytes_per_row, io_bytes)
        if remote_lines is None or len(tuple(remote_lines)) == 0:
            remote_lines = (0,) * local.n_shards
        remote_lines = tuple(int(r) for r in remote_lines)
        if not (len(hosts) == local.n_shards == len(remote_lines)):
            raise ValueError(
                f"host arity mismatch: {len(hosts)} hosts, "
                f"{local.n_shards} queues, {len(remote_lines)} remote "
                "line counts")
        link_s = tuple(
            (h.link_rtt_s + r * io_bytes / h.link_bw) if r > 0 else 0.0
            for h, r in zip(hosts, remote_lines))
        per_host_s = tuple(t if l == 0.0 else t + l
                           for t, l in zip(local.per_shard_s, link_s))
        return HostBurstResult(
            per_shard_s=per_host_s, per_shard_rows=local.per_shard_rows,
            per_shard_lines=local.per_shard_lines,
            spec_names=tuple(h.name for h in hosts),
            ssd_bytes=local.ssd_bytes, link_s=link_s,
            local_s=local.per_shard_s, remote_lines=remote_lines,
            local_burst=local)

    def price_batch(self, report, outstanding: int,
                    policy: str = "overlapped") -> float:
        """Price one gather from its `GatherReport` tier split.

        policy "overlapped": storage requests overlap under the
        accumulator-maintained outstanding count (GIDS/BaM planes);
        "page_fault": every request is a serially-handled page fault (the
        mmap baseline — redirection tiers don't exist, so the whole batch
        hits storage)."""
        bpr = report.bytes_per_row
        if policy == "page_fault":
            return self.mmap_batch_time(n_storage=report.n_requests,
                                        n_page_cache=0, feat_bytes=bpr)
        if policy == "overlapped":
            if self.shard_specs and getattr(report, "shard_rows", ()):
                return self.gids_batch_time_sharded(
                    shard_rows=report.shard_rows, n_host=report.n_host_hits,
                    n_hbm=report.n_hbm_hits, feat_bytes=bpr,
                    outstanding=outstanding,
                    remote_rows=getattr(report, "remote_rows", ()))
            return self.gids_batch_time(
                n_storage=report.n_storage, n_host=report.n_host_hits,
                n_hbm=report.n_hbm_hits, feat_bytes=bpr,
                outstanding=outstanding)
        raise ValueError(f"unknown pricing policy {policy!r}")

    def price_batch_overlapped(self, prep_s: float, compute_s: float) -> float:
        """Exposed (critical-path) prep time when data preparation for batch
        k+1 runs concurrently with batch k's model compute (paper §3.2: the
        decoupled stages hide storage latency behind training).  `compute_s`
        seconds of the prep are hidden; only the excess is exposed:

            exposed = max(0, prep_s - compute_s)

        A synchronous plane passes compute_s=0 and exposes everything."""
        return overlap_exposed(prep_s, compute_s)

    def price_merged_burst(self, report, outstanding: int | None = None,
                           io_bytes: int = IO_BYTES) -> float:
        """Price a merged window's gather as ONE storage burst (§3.2's merge
        made real — see `GIDSDataLoader.execute_window`).

        `report` is the window-level `CoalescedReport` over the *unique*
        request set: `n_storage` counts unique storage-bound rows,
        `n_storage_lines` the 4 KB IOs after line coalescing, and the
        host/HBM hit counts cover unique redirections.  Accounting matches
        `gids_batch_time` (per-row bytes, concurrent links, PCIe cap on
        host+storage ingress) so the comparison against the per-batch path
        isolates the dedup win; the SSD transfer is additionally capped at
        line granularity — when unique rows densely share IO lines, whole-
        line fetches (`n_storage_lines * io_bytes`) move fewer bytes than
        row-by-row reads and the device serves the smaller of the two.

        Efficiency comes from the burst's ACTUAL concurrency — the unique
        storage row requests the merged executor really issues in one burst
        — not the accumulator's modelled outstanding; the Eq. 2-3 ramp is
        paid once per window instead of once per batch.

        On a sharded namespace (`shard_specs` set and the report carrying
        per-shard row/line counts) the SSD term is the max over per-shard
        queue drains (`price_sharded_burst`) instead of one pooled burst;
        PCIe still caps the combined ingress.

        Returns TOTAL window seconds; the caller amortizes per batch."""
        bpr = report.bytes_per_row
        n_rows = report.n_storage
        if self.shard_specs and getattr(report, "shard_rows", ()):
            shard_lines = (report.shard_lines if
                           getattr(report, "shard_lines", ())
                           else report.shard_rows)
            if self.host_specs is not None:
                # host plane: the report's per-host remote line counts (the
                # second coalescing level) ride each serving host's link
                burst = self.price_host_burst(
                    report.shard_rows, shard_lines, bpr, io_bytes,
                    remote_lines=getattr(report, "remote_lines", ()))
            else:
                burst = price_sharded_burst(self.shard_specs,
                                            report.shard_rows, shard_lines,
                                            bpr, io_bytes)
                burst = self._fault_adjust(burst, bpr, io_bytes)
            self._note_burst(burst)
            t_ssd, ssd_bytes = burst.elapsed_s, burst.ssd_bytes
        else:
            lines = getattr(report, "n_storage_lines", n_rows)
            if outstanding is None:
                outstanding = max(n_rows, 1)
            eff = model_burst(self.spec, max(outstanding, 1),
                              self.n_ssd).efficiency
            ssd_bytes = min(n_rows * bpr, lines * io_bytes) if n_rows else 0
            t_ssd = ssd_bytes / (self.spec.peak_bw * self.n_ssd * eff) \
                if n_rows else 0.0
            if self.injector is not None:
                # the unsharded plane is one storage queue: wrap the burst
                # so the fault schedule prices it the same way
                burst = self._fault_adjust(
                    ShardedBurstResult((t_ssd,), (n_rows,), (int(lines),),
                                       (self.spec.name,), int(ssd_bytes)),
                    bpr, io_bytes)
                self._note_burst(burst)
                t_ssd, ssd_bytes = burst.elapsed_s, burst.ssd_bytes
        n_host, n_hbm = report.n_host_hits, report.n_hbm_hits
        t_host = n_host * bpr / HOST_DRAM_BW if n_host else 0.0
        t_hbm = n_hbm * bpr / HBM_BW if n_hbm else 0.0
        t_pcie = (ssd_bytes + n_host * bpr) / PCIE_GEN4_BW
        return max(t_ssd, t_host, t_hbm, t_pcie)

    def price_topology_hop(self, report, io_bytes: int = IO_BYTES) -> float:
        """Price one GPU-initiated sampling hop over a tiered topology store
        (core/topology.py).  `report` is a `TopologyGatherReport`: unique
        4 KB edge pages touched, split (hbm, host, storage).

        HBM-resident pages read at HBM bandwidth; pinned-host pages stream
        zero-copy over PCIe; storage pages are page-granular IOs — one
        4 KB line each, already deduplicated (the topology twin of
        `coalesce_lines`) — served as one burst whose elapsed time comes
        from the Eq. 2-3 model at the burst's own concurrency.  On a
        sharded topology namespace (`shard_specs` set and the report
        carrying per-shard page counts) the burst completes at the MAX over
        per-shard queue drains (`price_sharded_burst`), exactly like the
        feature plane's merged burst.  Tier reads overlap (GPU threads
        cover all three paths concurrently); the pinned-host pages' own
        service link IS PCIe (zero-copy reads), so they appear only inside
        the combined host+storage PCIe ingress cap — no separate host
        term; every hop pays one kernel launch."""
        n_hbm, n_host, n_sto = report.pages_by_tier
        if report.n_edge_reads <= 0:
            return 0.0
        t_hbm = n_hbm * io_bytes / HBM_BW
        t_sto = 0.0
        if n_sto:
            shard_pages = getattr(report, "shard_pages", ())
            if self.shard_specs and shard_pages:
                burst = price_sharded_burst(self.shard_specs, shard_pages,
                                            shard_pages, io_bytes, io_bytes)
                # topology edge-page reads see brownouts/outages too: the
                # same injector seam as the feature plane's merged burst
                # (an empty schedule returns the burst untouched)
                burst = self._fault_adjust(burst, io_bytes, io_bytes)
                self._note_burst(burst)
                t_sto = burst.elapsed_s
            else:
                t_sto = model_burst(self.spec, n_sto, self.n_ssd).elapsed_s
                if self.injector is not None:
                    # unsharded topology namespace = one storage queue:
                    # wrap the hop's page burst so the schedule prices it
                    burst = self._fault_adjust(
                        ShardedBurstResult((t_sto,), (n_sto,), (n_sto,),
                                           (self.spec.name,),
                                           n_sto * io_bytes),
                        io_bytes, io_bytes)
                    self._note_burst(burst)
                    t_sto = burst.elapsed_s
        t_pcie = (n_host + n_sto) * io_bytes / PCIE_GEN4_BW
        return TOPO_HOP_LAUNCH_S + max(t_hbm, t_sto, t_pcie)

    def price_migration(self, from_shard, to_shard, bytes_per_row: int,
                        n_shards: int | None = None,
                        io_bytes: int = IO_BYTES) -> float:
        """Price a placement migration: what it actually costs to MOVE rows
        between shards (the adaptive plane's rebalancing is never free).

        `from_shard[i]` / `to_shard[i]` are the source and destination shard
        of row i; rows whose shard does not change are ignored.  Every moved
        row is one read on its source queue and one write on its destination
        queue — rows wider than an IO line pay line-granular IOs — so each
        queue drains its reads+writes at its own `SSDSpec` via the Eq. 2-3
        burst model and the migration completes at the MAX over queues,
        exactly like a gather burst.  The moved bytes additionally transit
        host memory twice (source SSD -> host -> destination SSD) under the
        PCIe cap.  The `ShardRebalancer` (core/feedback.py) commits a
        migration only when the modelled imbalance saving over its
        amortization horizon exceeds this cost, then charges the cost back
        into subsequent batches."""
        src = np.asarray(from_shard, np.int64)
        dst = np.asarray(to_shard, np.int64)
        if src.shape != dst.shape:
            raise ValueError(
                f"migration arity mismatch: {src.shape} source vs "
                f"{dst.shape} destination shards")
        moved = src != dst
        src, dst = src[moved], dst[moved]
        if len(src) == 0:
            return 0.0
        if n_shards is None:
            n_shards = len(self.shard_specs) if self.shard_specs \
                else int(max(src.max(), dst.max())) + 1
        specs = self.shard_specs or (self.spec,) * n_shards
        per_queue = np.bincount(src, minlength=n_shards) \
            + np.bincount(dst, minlength=n_shards)
        lines_per_row = max(1, -(-bytes_per_row // io_bytes))
        burst = price_sharded_burst(
            specs, tuple(per_queue), tuple(per_queue * lines_per_row),
            bytes_per_row, io_bytes)
        t_pcie = 2 * len(src) * bytes_per_row / PCIE_GEN4_BW
        t_link = 0.0
        if self.host_specs is not None and len(self.host_specs) == n_shards:
            # host plane: a moved row leaves its source host and enters its
            # destination host over each one's link — per_queue already
            # counts both endpoints, and the slowest link gates the move
            t_link = max(
                (h.link_rtt_s + int(q) * bytes_per_row / h.link_bw
                 for h, q in zip(self.host_specs, per_queue) if q > 0),
                default=0.0)
        return max(burst.elapsed_s, t_pcie, t_link)

    def gids_batch_time(self, n_storage: int, n_host: int, n_hbm: int,
                        feat_bytes: int, outstanding: int) -> float:
        """GIDS: storage requests overlapped (efficiency from the accumulator's
        maintained outstanding count), host/HBM redirections run concurrently
        on their own links; PCIe caps combined host+storage ingress.
        `feat_bytes` is the size of ONE feature row — counts scale it."""
        eff = model_burst(self.spec, max(outstanding, 1), self.n_ssd).efficiency
        ssd_bw = self.spec.peak_bw * self.n_ssd * eff
        t_ssd = n_storage * feat_bytes / ssd_bw if n_storage else 0.0
        if self.injector is not None:
            lines = n_storage * max(1, -(-feat_bytes // IO_BYTES))
            burst = self._fault_adjust(
                ShardedBurstResult((t_ssd,), (n_storage,), (int(lines),),
                                   (self.spec.name,),
                                   int(n_storage * feat_bytes)),
                feat_bytes)
            self._note_burst(burst)
            t_ssd = burst.elapsed_s
        t_host = n_host * feat_bytes / HOST_DRAM_BW if n_host else 0.0
        t_hbm = n_hbm * feat_bytes / HBM_BW if n_hbm else 0.0
        pcie_bytes = (n_storage + n_host) * feat_bytes
        t_pcie = pcie_bytes / PCIE_GEN4_BW
        return max(t_ssd, t_host, t_hbm, t_pcie)

    def gids_batch_time_sharded(self, shard_rows, n_host: int, n_hbm: int,
                                feat_bytes: int, outstanding: int,
                                remote_rows=()) -> float:
        """GIDS batch pricing over a sharded namespace: the accumulator's
        maintained outstanding count splits across shard queues in
        proportion to each shard's share of the batch's storage rows, each
        shard drains at its own spec with the efficiency of ITS queue alone,
        and the storage term is the slowest shard's drain.  Host/HBM links
        and the PCIe ingress cap match `gids_batch_time` exactly, so a
        1-shard plane prices identically to the unsharded one.

        On a host plane (`host_specs` wired) `remote_rows[h]` counts the
        batch rows host h serves to OTHER hosts; they ship line-granular
        over h's link via `price_host_burst`."""
        shard_rows = tuple(int(r) for r in shard_rows)
        total = sum(shard_rows)
        shard_out = tuple(
            max(int(round(outstanding * r / total)), 1) if r else 0
            for r in shard_rows) if total else shard_rows
        specs = self.shard_specs or (self.spec,) * len(shard_rows)
        # per-batch pricing is row-granular (no merged-window coalescing):
        # lines = rows keeps the line cap at exactly the row bytes
        shard_lines = tuple(-(-r * feat_bytes // IO_BYTES)
                            for r in shard_rows)
        if self.host_specs is not None:
            remote_lines = tuple(
                -(-int(r) * feat_bytes // IO_BYTES) for r in remote_rows) \
                if remote_rows else None
            burst = self.price_host_burst(
                shard_rows, shard_lines, feat_bytes,
                shard_outstanding=shard_out, remote_lines=remote_lines)
        else:
            burst = price_sharded_burst(specs, shard_rows, shard_lines,
                                        feat_bytes,
                                        shard_outstanding=shard_out)
            burst = self._fault_adjust(burst, feat_bytes)
        self._note_burst(burst)
        t_host = n_host * feat_bytes / HOST_DRAM_BW if n_host else 0.0
        t_hbm = n_hbm * feat_bytes / HBM_BW if n_hbm else 0.0
        t_pcie = (total + n_host) * feat_bytes / PCIE_GEN4_BW
        return max(burst.elapsed_s, t_host, t_hbm, t_pcie)

    def mmap_batch_time(self, n_storage: int, n_page_cache: int,
                        feat_bytes: int, cpu_threads: int = 16) -> float:
        """mmap baseline: page faults served with limited overlap (readahead
        gives ~cpu_threads-deep concurrency), plus per-fault kernel overhead.
        `feat_bytes` is the size of ONE feature row; rows wider than the 4 KB
        IO line fault once per line (no double-scaling against counts)."""
        lines = max(1, feat_bytes // IO_BYTES)
        faults = n_storage * lines
        t_fault = faults * (MMAP_FAULT_OVERHEAD_S / cpu_threads)
        t_dev = faults * self.spec.latency_s / cpu_threads \
            + faults / (self.spec.peak_iops * self.n_ssd)
        t_hit = n_page_cache * feat_bytes / HOST_DRAM_BW
        return t_fault + t_dev + t_hit
