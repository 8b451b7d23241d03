"""Storage device models (paper §4.2, Table 1 constants): the port's copy
of the unsharded, fault-free part of `repro.core.storage_sim`.

The constants are the reference's, verbatim, so every priced time is
bit-identical to it.  They are the paper's A100 and SSD figures: the prices
are a model of that system, not a measurement of the card the port runs on.
Sharded, host and fault pricing wait for their slices (ROADMAP.md Queue 1:
sharded, host, fault and adaptive planes).

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
                   io_bytes: int = IO_BYTES) -> int:
    """Number of `io_bytes`-granule IOs needed to fetch the given storage
    rows, laid out contiguously by node id.  Rows narrower than one line
    share it (`rows_per_line = io_bytes // bytes_per_row`, row-aligned);
    rows at or above the line size cost `ceil(bytes_per_row / io_bytes)`
    IOs each.  Unsharded only: shard-local coalescing waits for the sharded
    planes (ROADMAP.md Queue 1)."""
    n = len(node_ids)
    if n == 0 or bytes_per_row <= 0:
        return 0
    if bytes_per_row >= io_bytes:
        return n * int(-(-bytes_per_row // io_bytes))
    rows_per_line = io_bytes // bytes_per_row
    if rows_per_line <= 1:
        return n
    lines = np.asarray(node_ids, np.int64) // rows_per_line
    return len(np.unique(lines))


def host_sampling_hop_time(n_edge_reads: int, n_frontier: int,
                           id_bytes: int = 8,
                           threads: int = CPU_SAMPLE_THREADS) -> float:
    """One hop of the CPU-sampling baseline: `n_edge_reads` sampled
    adjacency words plus the indptr pair per frontier node, each a random
    DRAM access amortized over `threads`; the sampled block ships to the
    device over PCIe and the hop ends in one host->device handoff."""
    if n_edge_reads <= 0 and n_frontier <= 0:
        return 0.0
    reads = n_edge_reads + 2 * n_frontier
    t_cpu = reads * HOST_RANDOM_READ_S / max(threads, 1)
    t_xfer = n_edge_reads * id_bytes / PCIE_GEN4_BW
    return t_cpu + t_xfer + HOP_SYNC_S


def overlap_exposed(prep_s: float, compute_s: float) -> float:
    """max(0, prep - compute): the prep time left on the critical path after
    `compute_s` seconds of concurrent model compute hid the rest."""
    return max(0.0, prep_s - max(compute_s, 0.0))


class StorageTimeline:
    """Prices each batch's storage portion from its tier split: storage
    requests overlapped under the accumulator's outstanding count (GIDS) or
    serial page-fault handling (the mmap baseline)."""

    def __init__(self, spec: SSDSpec, n_ssd: int = 1):
        self.spec, self.n_ssd = spec, n_ssd

    def price_batch(self, report, outstanding: int,
                    policy: str = "overlapped") -> float:
        """Price one gather from its `GatherReport` tier split."""
        bpr = report.bytes_per_row
        if policy == "page_fault":
            return self.mmap_batch_time(n_storage=report.n_requests,
                                        n_page_cache=0, feat_bytes=bpr)
        if policy == "overlapped":
            return self.gids_batch_time(
                n_storage=report.n_storage, n_host=report.n_host_hits,
                n_hbm=report.n_hbm_hits, feat_bytes=bpr,
                outstanding=outstanding)
        raise ValueError(f"unknown pricing policy {policy!r}")

    def price_batch_overlapped(self, prep_s: float, compute_s: float) -> float:
        """Exposed prep when batch k+1's preparation overlaps batch k's
        compute (§3.2): max(0, prep_s - compute_s)."""
        return overlap_exposed(prep_s, compute_s)

    def price_merged_burst(self, report, outstanding: int | None = None,
                           io_bytes: int = IO_BYTES) -> float:
        """Price a merged window's gather as ONE storage burst from its
        window-level `CoalescedReport` over the unique request set: per-row
        byte accounting as `gids_batch_time`, the SSD transfer capped at
        line granularity (`n_storage_lines * io_bytes`), and the Eq. 2-3
        efficiency from the burst's own unique storage rows.  Returns TOTAL
        window seconds; the caller amortizes per batch."""
        bpr = report.bytes_per_row
        n_rows = report.n_storage
        lines = getattr(report, "n_storage_lines", n_rows)
        if outstanding is None:
            outstanding = max(n_rows, 1)
        eff = model_burst(self.spec, max(outstanding, 1),
                          self.n_ssd).efficiency
        ssd_bytes = min(n_rows * bpr, lines * io_bytes) if n_rows else 0
        t_ssd = ssd_bytes / (self.spec.peak_bw * self.n_ssd * eff) \
            if n_rows else 0.0
        n_host, n_hbm = report.n_host_hits, report.n_hbm_hits
        t_host = n_host * bpr / HOST_DRAM_BW if n_host else 0.0
        t_hbm = n_hbm * bpr / HBM_BW if n_hbm else 0.0
        t_pcie = (ssd_bytes + n_host * bpr) / PCIE_GEN4_BW
        return max(t_ssd, t_host, t_hbm, t_pcie)

    def price_topology_hop(self, report, io_bytes: int = IO_BYTES) -> float:
        """Price one GPU-initiated sampling hop from its
        `TopologyGatherReport` (unique 4 KB edge pages by tier): HBM pages
        at HBM bandwidth, storage pages as one Eq. 2-3 burst at the hop's
        own page count, pinned-host pages only inside the combined
        host+storage PCIe cap, plus one kernel launch per hop."""
        n_hbm, n_host, n_sto = report.pages_by_tier
        if report.n_edge_reads <= 0:
            return 0.0
        t_hbm = n_hbm * io_bytes / HBM_BW
        t_sto = 0.0
        if n_sto:
            t_sto = model_burst(self.spec, n_sto, self.n_ssd).elapsed_s
        t_pcie = (n_host + n_sto) * io_bytes / PCIE_GEN4_BW
        return TOPO_HOP_LAUNCH_S + max(t_hbm, t_sto, t_pcie)

    def gids_batch_time(self, n_storage: int, n_host: int, n_hbm: int,
                        feat_bytes: int, outstanding: int) -> float:
        """GIDS: storage requests overlapped (efficiency from the accumulator's
        maintained outstanding count), host/HBM redirections run concurrently
        on their own links; PCIe caps combined host+storage ingress.
        `feat_bytes` is the size of ONE feature row."""
        eff = model_burst(self.spec, max(outstanding, 1), self.n_ssd).efficiency
        ssd_bw = self.spec.peak_bw * self.n_ssd * eff
        t_ssd = n_storage * feat_bytes / ssd_bw if n_storage else 0.0
        t_host = n_host * feat_bytes / HOST_DRAM_BW if n_host else 0.0
        t_hbm = n_hbm * feat_bytes / HBM_BW if n_hbm else 0.0
        pcie_bytes = (n_storage + n_host) * feat_bytes
        t_pcie = pcie_bytes / PCIE_GEN4_BW
        return max(t_ssd, t_host, t_hbm, t_pcie)

    def mmap_batch_time(self, n_storage: int, n_page_cache: int,
                        feat_bytes: int, cpu_threads: int = 16) -> float:
        """mmap baseline: page faults served with limited overlap plus
        per-fault kernel overhead; rows wider than the 4 KB line fault once
        per line."""
        lines = max(1, feat_bytes // IO_BYTES)
        faults = n_storage * lines
        t_fault = faults * (MMAP_FAULT_OVERHEAD_S / cpu_threads)
        t_dev = faults * self.spec.latency_s / cpu_threads \
            + faults / (self.spec.peak_iops * self.n_ssd)
        t_hit = n_page_cache * feat_bytes / HOST_DRAM_BW
        return t_fault + t_dev + t_hit
