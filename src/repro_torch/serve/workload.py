"""Online inference request streams for the GNN serve plane, the port's
copy of `repro.serve.workload` (streams are bit-equal for the same seed).

Offline training drives the data plane in epoch order; serving is driven by
*arrival dynamics*.  This module generates the request streams the
`GNNServeEngine` consumes, fully deterministic from a seed:

  * arrivals — Poisson (memoryless baseline) or bursty MMPP (a two-state
    Markov-modulated Poisson process: a low-rate background state and a
    high-rate burst state with exponentially-distributed dwell times, the
    standard model for flash-crowd traffic);
  * seed fanouts — heavy-tailed (shifted-Pareto) per-request seed counts:
    most requests score a handful of nodes, a tail scores many;
  * tenant mixes — each arrival belongs to a tenant whose draws are skewed
    toward a tenant-private HOT SET (the per-user neighbourhood a
    recommender hits over and over), with `hot_prob` mass on the hot set
    and the rest uniform over the whole graph.  Hot-set skew is what makes
    the software-cache tier matter online, and per-tenant hot sets are what
    the tenant-partitioned cache isolates.

Every request carries its arrival time, tenant, seed nodes, and SLO
deadline; the stream is sorted by arrival and rid-stamped in arrival order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic and locality profile."""

    name: str
    rate_share: float = 1.0         # share of the offered load
    hot_fraction: float = 0.03      # fraction of the node space in the hot set
    hot_prob: float = 0.9           # P(seed drawn from the hot set)
    mean_seeds: int = 4             # mean seeds per request
    max_seeds: int = 64             # heavy-tail clip
    seed_tail: float = 1.5          # Pareto shape; smaller = heavier tail
    deadline_s: float = 3e-3        # SLO budget from arrival
    arrival: str = "poisson"        # "poisson" | "mmpp"
    burst_factor: float = 6.0       # MMPP: burst-state rate multiplier
    burst_fraction: float = 0.15    # MMPP: fraction of time in burst state
    burst_cycle_s: float = 0.02     # MMPP: mean on+off cycle length
    # half-open node-id range this tenant's seeds (and hot set) come from;
    # None = the whole graph.  With a `graph.csr.disjoint_union` graph this
    # pins each tenant to its own component — the colocated-datasets layout
    node_range: tuple[int, int] | None = None

    def resolve_range(self, num_nodes: int) -> tuple[int, int]:
        lo, hi = self.node_range or (0, num_nodes)
        if not 0 <= lo < hi <= num_nodes:
            raise ValueError(f"node_range {self.node_range} outside "
                             f"[0, {num_nodes})")
        return lo, hi


@dataclasses.dataclass
class ServeRequest:
    """One inference request: score `seeds` against the model by
    `arrival_s + deadline_s`."""

    rid: int
    tenant: int
    arrival_s: float
    seeds: np.ndarray               # (k,) int64 seed node ids
    deadline_s: float


def poisson_arrivals(rate_qps: float, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """n arrival times of a homogeneous Poisson process (exponential gaps)."""
    if rate_qps <= 0:
        raise ValueError(f"rate must be positive, got {rate_qps}")
    return np.cumsum(rng.exponential(1.0 / rate_qps, n))


def mmpp_arrivals(rate_qps: float, n: int, rng: np.random.Generator,
                  burst_factor: float = 6.0, burst_fraction: float = 0.15,
                  cycle_s: float = 0.02) -> np.ndarray:
    """n arrival times of a 2-state Markov-modulated Poisson process.

    The process alternates between a burst state (rate `m * base`) and a
    background state (rate `base`), with exponential dwell times averaging
    `burst_fraction * cycle_s` and `(1 - burst_fraction) * cycle_s`.  `base`
    is chosen so the long-run mean rate equals `rate_qps`:

        mean = base * (f * m + (1 - f))  =>  base = rate / (f*m + 1 - f)

    Same mean load as the Poisson stream, far burstier gaps — the stress
    test for deadline-bounded window formation.
    """
    if burst_factor < 1:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    f = burst_fraction
    base = rate_qps / (f * burst_factor + (1.0 - f))
    rates = (base, base * burst_factor)             # (background, burst)
    dwells = ((1.0 - f) * cycle_s, f * cycle_s)
    out = np.empty(n)
    t, got, state = 0.0, 0, 0
    state_end = t + rng.exponential(dwells[state])
    while got < n:
        gap = rng.exponential(1.0 / rates[state])
        if t + gap < state_end:
            t += gap
            out[got] = t
            got += 1
        else:
            # the memoryless gap does not survive the rate change: restart
            # the clock at the state boundary under the new rate
            t = state_end
            state = 1 - state
            state_end = t + rng.exponential(dwells[state])
    return out


def _seed_counts(spec: TenantSpec, n: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Heavy-tailed per-request seed counts: 1 + scaled Pareto, clipped.
    The scale puts the pre-clip mean at `mean_seeds` (shifted-Pareto mean
    is 1 + scale/(tail-1) for tail > 1)."""
    scale = max(spec.mean_seeds - 1, 0) * max(spec.seed_tail - 1, 0.05)
    draw = 1 + rng.pareto(spec.seed_tail, n) * scale
    return np.minimum(draw.astype(np.int64), spec.max_seeds).clip(1)


def tenant_hot_set(num_nodes: int, spec: TenantSpec, tenant: int,
                   seed: int) -> np.ndarray:
    """The tenant-private hot node set: a uniform sample without
    replacement from the tenant's node range, keyed by (stream seed,
    tenant) so distinct tenants get distinct (possibly overlapping) hot
    sets."""
    lo, hi = spec.resolve_range(num_nodes)
    size = max(1, int((hi - lo) * spec.hot_fraction))
    rng = np.random.default_rng(seed * 1009 + tenant)
    return np.sort(lo + rng.choice(hi - lo, size=size, replace=False))


def generate_stream(num_nodes: int, tenants: Sequence[TenantSpec],
                    offered_qps: float, n_requests: int,
                    seed: int = 0) -> list[ServeRequest]:
    """Generate a merged multi-tenant request stream.

    Each tenant runs its own arrival process at `rate_share`-weighted rate
    (so a bursty tenant stays bursty inside the mix); per-tenant request
    counts are proportional to the shares; the merged stream is sorted by
    arrival and rid-stamped in arrival order.
    """
    if not tenants:
        raise ValueError("need at least one TenantSpec")
    shares = np.array([t.rate_share for t in tenants], float)
    if (shares <= 0).any():
        raise ValueError("rate shares must be positive")
    shares = shares / shares.sum()
    counts = np.maximum(1, np.round(shares * n_requests).astype(int))

    requests: list[ServeRequest] = []
    for ti, (spec, n) in enumerate(zip(tenants, counts)):
        rng = np.random.default_rng([seed, ti])
        rate = offered_qps * shares[ti]
        if spec.arrival == "poisson":
            arrivals = poisson_arrivals(rate, n, rng)
        elif spec.arrival == "mmpp":
            arrivals = mmpp_arrivals(rate, n, rng, spec.burst_factor,
                                     spec.burst_fraction, spec.burst_cycle_s)
        else:
            raise ValueError(f"unknown arrival process {spec.arrival!r} "
                             "(expected 'poisson' or 'mmpp')")
        hot = tenant_hot_set(num_nodes, spec, ti, seed)
        lo, hi = spec.resolve_range(num_nodes)
        n_seeds = _seed_counts(spec, n, rng)
        for arrival, k in zip(arrivals, n_seeds):
            from_hot = rng.random(k) < spec.hot_prob
            seeds = np.where(from_hot,
                             rng.choice(hot, k),
                             rng.integers(lo, hi, k)).astype(np.int64)
            requests.append(ServeRequest(
                rid=-1, tenant=ti, arrival_s=float(arrival),
                seeds=np.unique(seeds), deadline_s=spec.deadline_s))
    requests.sort(key=lambda r: r.arrival_s)
    for i, r in enumerate(requests):
        r.rid = i
    return requests
