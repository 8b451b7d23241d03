"""Dynamic storage access accumulator (paper §3.2), the port's copy of
`repro.core.accumulator`: the per-batch merge depth, the merged window,
and the serve plane's deadline-bounded window policy.

Sampling runs ahead of training and the storage requests of consecutive
mini-batches merge until the outstanding accesses cross the Eq. 2-3
threshold for the target fraction of peak SSD throughput.  Redirected
accesses (device-cache and constant-buffer hits) occupy no SSD queue slot,
so the measured redirection rate re-inflates the merge depth.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .storage_sim import SSDSpec, required_accesses


@dataclasses.dataclass
class AccumulatorConfig:
    target_efficiency: float = 0.95
    n_ssd: int = 1
    max_merge_iters: int = 16       # buffer-memory guard
    ema: float = 0.9                # smoothing for the redirection estimate


@dataclasses.dataclass
class MergedWindow:
    """The §3.2 merge made concrete: the union of `n_batches` consecutive
    request lists, deduplicated so each unique row is fetched once.

    unique_nodes: (U,) sorted unique node ids across the window
    inverse:      (sum_i B_i,) int64 index into `unique_nodes`; batch i's
                  slice is `inverse[offsets[i]:offsets[i+1]]`
    offsets:      (n_batches + 1,) slice boundaries into `inverse`
    """

    unique_nodes: np.ndarray
    inverse: np.ndarray
    offsets: np.ndarray

    @property
    def n_batches(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_requests(self) -> int:
        return int(self.offsets[-1])

    @property
    def n_unique(self) -> int:
        return len(self.unique_nodes)

    @property
    def n_duplicate(self) -> int:
        """Rows the per-batch path would have fetched again."""
        return self.n_requests - self.n_unique

    @property
    def dedup_factor(self) -> float:
        return self.n_requests / max(self.n_unique, 1)

    def batch_inverse(self, i: int) -> np.ndarray:
        return self.inverse[self.offsets[i]:self.offsets[i + 1]]

    def batch_multiplicity(self) -> np.ndarray:
        """Per-unique-node count of merged batches requesting it (each
        batch's list is already deduplicated)."""
        return np.bincount(self.inverse, minlength=self.n_unique)


def merge_window(node_lists) -> MergedWindow:
    """Merge consecutive batches' request lists into one deduplicated burst
    with `np.unique(..., return_inverse=True)` over the concatenation."""
    lists = [np.asarray(x) for x in node_lists]
    if not lists:
        raise ValueError("merge_window needs at least one batch")
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    unique, inverse = np.unique(np.concatenate(lists), return_inverse=True)
    return MergedWindow(unique_nodes=unique,
                        inverse=inverse.astype(np.int64),
                        offsets=offsets)


@dataclasses.dataclass
class DeadlineWindowConfig:
    max_window: int = 16            # depth cap — same buffer-memory guard as
                                    # AccumulatorConfig.max_merge_iters
    ema: float = 0.7                # smoothing for the service estimate
    init_request_s: float = 2e-4    # cold-start per-request service guess
    safety: float = 1.5             # close early by this factor over the
                                    # estimate (estimate error eats slack,
                                    # not the SLO)


class DeadlineWindowPolicy:
    """Deadline-bounded twin of `merge_depth` for ONLINE serving windows.

    Training merges a fixed lookahead depth because epochs have no deadlines;
    a serving window instead keeps admitting compatible in-flight requests
    until the OLDEST staged request's slack is spent: service must start by

        close_by = arrival + deadline - safety * est_service(n_staged)

    for that request to have any chance of meeting its SLO.  The per-request
    service estimate is an EMA over completed windows' measured service, so
    the close bound tightens as windows deepen and the estimate converges —
    the serving analogue of the accumulator's redirection-rate EMA.
    `max_window` keeps the same buffer-memory guard the merge depth has.
    """

    def __init__(self, config: DeadlineWindowConfig | None = None):
        self.config = config or DeadlineWindowConfig()
        self._request_s = self.config.init_request_s

    @property
    def est_request_s(self) -> float:
        return self._request_s

    def observe(self, service_s: float, n_requests: int) -> None:
        """Feed one completed window's measured service time."""
        if n_requests <= 0 or service_s < 0:
            return
        a = self.config.ema
        self._request_s = a * self._request_s \
            + (1 - a) * service_s / n_requests

    def est_service_s(self, n_staged: int) -> float:
        return self._request_s * max(n_staged, 1)

    def full(self, n_staged: int) -> bool:
        return n_staged >= self.config.max_window

    def close_by(self, oldest_arrival_s: float, oldest_deadline_s: float,
                 n_staged: int) -> float:
        """Latest virtual time the window can start service and still meet
        the oldest staged request's deadline (never before its arrival)."""
        slack_close = (oldest_arrival_s + oldest_deadline_s
                       - self.config.safety * self.est_service_s(n_staged))
        return max(oldest_arrival_s, slack_close)

    def reset(self) -> None:
        self._request_s = self.config.init_request_s


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

    def reset_telemetry(self) -> None:
        """Drop the redirection-rate EMA back to the fresh-accumulator state.
        Checkpoint resume calls this so a restored loader and a freshly
        built loader make bit-identical merge-depth decisions."""
        self._redirect_rate = 0.0

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

    def merge(self, node_lists) -> MergedWindow:
        """Execute the merge the depth policy only sizes: one deduplicated
        window whose unique set is gathered once."""
        return merge_window(node_lists)
