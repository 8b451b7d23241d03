"""Storage device models (paper §4.2, Table 1 constants): the port's copy
of the unsharded, fault-free part of `repro.core.storage_sim`.

The constants are the reference's, verbatim, so every priced time is
bit-identical to it.  They are the paper's A100 and SSD figures: the prices
are a model of that system, not a measurement of the card the port runs on.
Sharded, host, topology and fault pricing wait for their slices (ROADMAP.md
Queue 1).

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
