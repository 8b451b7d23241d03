"""Dynamic storage access accumulator (paper §3.2), the port's copy of the
per-batch part of `repro.core.accumulator` (the merged-window and deadline
policies wait for their slices).

Sampling runs ahead of training and the storage requests of consecutive
mini-batches merge until the outstanding accesses cross the Eq. 2-3
threshold for the target fraction of peak SSD throughput.  Redirected
accesses (device-cache and constant-buffer hits) occupy no SSD queue slot,
so the measured redirection rate re-inflates the merge depth.
"""
from __future__ import annotations

import dataclasses

from .storage_sim import SSDSpec, required_accesses


@dataclasses.dataclass
class AccumulatorConfig:
    target_efficiency: float = 0.95
    n_ssd: int = 1
    max_merge_iters: int = 16       # buffer-memory guard
    ema: float = 0.9                # smoothing for the redirection estimate


class DynamicAccessAccumulator:
    """update(n_sampled, n_redirected) feeds per-iteration telemetry;
    merge_depth(requests_per_iter) returns how many iterations' data
    preparation should be in flight at once."""

    def __init__(self, spec: SSDSpec, config: AccumulatorConfig | None = None):
        self.spec = spec
        self.config = config or AccumulatorConfig()
        self.threshold = required_accesses(
            spec, self.config.target_efficiency, self.config.n_ssd)
        self._redirect_rate = 0.0

    def update(self, n_sampled: int, n_redirected: int) -> None:
        if n_sampled <= 0:
            return
        r = n_redirected / n_sampled
        a = self.config.ema
        self._redirect_rate = a * self._redirect_rate + (1 - a) * r

    @property
    def redirect_rate(self) -> float:
        return self._redirect_rate

    def storage_fraction(self) -> float:
        return max(1.0 - self._redirect_rate, 1e-3)

    def merge_depth(self, requests_per_iter: int) -> int:
        """Iterations to merge so that outstanding storage-bound requests
        >= threshold: depth * requests * (1 - redirect_rate) >= N_access."""
        if requests_per_iter <= 0:
            return 1
        eff_per_iter = requests_per_iter * self.storage_fraction()
        depth = int(-(-self.threshold // max(eff_per_iter, 1.0)))  # ceil
        return max(1, min(depth, self.config.max_merge_iters))

    def outstanding(self, requests_per_iter: int) -> int:
        d = self.merge_depth(requests_per_iter)
        return int(d * requests_per_iter * self.storage_fraction())
