"""Sharded storage namespace, the port's copy of `repro.core.sharding`:
placement policies for multi-SSD and multi-host planes.

Each shard is an independent queue (an SSD, or a host on the cluster
plane): it drains at its own device's rate and the batch completes when
the slowest shard does.  This module owns the question "which shard holds
node i": a pluggable `PlacementPolicy` resolved through a registry, shared
by the `ShardedStorageTier` (core/tiers.py), the per-shard burst pricing
(`storage_sim.price_sharded_burst`) and the host plane (core/hosts.py):

  hash       — Fibonacci-hash striping (the default)
  range      — contiguous id blocks, one per shard
  degree     — nodes sorted by degree, dealt round-robin across shards
  skewed     — a deliberately imbalanced hash (shard 0 oversubscribed)
  adaptive   — `degree` that learns from measured touches; the
               `ShardRebalancer` (core/feedback.py) decides when a priced
               migration pays for itself
  metis-lite — greedy min-cut partitions grown over the CSR

`ReplicatedPlacement` wraps any of them in k-way replication for the fault
plane.  Tables, shard ids and checkpoint states are bit-identical to the
reference's, and a state of either package loads into the other.
"""
from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

import numpy as np

from .feedback import TouchTable

#: Fibonacci multiplier shared with the software cache's set hash — a
#: different shift keeps shard striping decorrelated from set indexing.
_FIB = np.uint64(0x9E3779B97F4A7C15)


def _mix(ids: np.ndarray) -> np.ndarray:
    """The shared Fibonacci mix both hash-family policies stripe with —
    one definition so their bit recipes can never silently diverge."""
    return (ids.astype(np.uint64) * _FIB) >> np.uint64(40)


@runtime_checkable
class PlacementPolicy(Protocol):
    """Maps node ids onto storage shards.  `shard_of` must be deterministic
    between calls (the merged executor and the pricing model both resolve the
    same ids) and total over the id namespace."""

    name: str
    n_shards: int

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray: ...

    def state_dict(self) -> dict: ...

    def load_state_dict(self, state: dict) -> None: ...


class _PolicyBase:
    """Shared shape checks + default (parameter-only) checkpoint state."""

    name = "placement"

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)

    def _ids(self, node_ids: np.ndarray) -> np.ndarray:
        return np.asarray(node_ids, dtype=np.int64)

    def state_dict(self) -> dict:
        return {"name": self.name, "n_shards": self.n_shards}

    def load_state_dict(self, state: dict) -> None:
        if state.get("name", self.name) != self.name \
                or state.get("n_shards", self.n_shards) != self.n_shards:
            raise ValueError(
                f"placement state {state.get('name')!r}/"
                f"{state.get('n_shards')} does not match policy "
                f"{self.name!r}/{self.n_shards}")


# -- registry ------------------------------------------------------------------

PlacementFactory = Callable[..., PlacementPolicy]
_PLACEMENTS: dict[str, PlacementFactory] = {}


def register_placement(name: str) -> Callable[[PlacementFactory],
                                              PlacementFactory]:
    """Register a factory ``(n_shards, *, num_nodes, degrees, graph, seed)
    -> PlacementPolicy`` under `name`.  The factory receives every context
    keyword and ignores what it does not need, so new policies (locality-,
    score-, or host-topology-aware) slot in without touching callers —
    `metis-lite` below consumes the full CSR via `graph`."""
    def deco(fn: PlacementFactory) -> PlacementFactory:
        _PLACEMENTS[name] = fn
        return fn
    return deco


def placement_names() -> tuple[str, ...]:
    return tuple(sorted(_PLACEMENTS))


def make_placement(name: str, n_shards: int, *, num_nodes: int | None = None,
                   degrees: np.ndarray | None = None, graph=None,
                   seed: int = 0) -> PlacementPolicy:
    try:
        factory = _PLACEMENTS[name]
    except KeyError:
        raise KeyError(f"unknown placement policy {name!r}; registered: "
                       f"{placement_names()}") from None
    return factory(n_shards, num_nodes=num_nodes, degrees=degrees,
                   graph=graph, seed=seed)


# -- the built-in policies -----------------------------------------------------

class HashPlacement(_PolicyBase):
    """Fibonacci-hash striping: balanced in expectation regardless of the id
    distribution, no per-node state."""

    name = "hash"

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray:
        mixed = _mix(self._ids(node_ids))
        return (mixed % np.uint64(self.n_shards)).astype(np.int16)


@register_placement("hash")
def _make_hash(n_shards: int, **_ctx) -> HashPlacement:
    return HashPlacement(n_shards)


class RangePlacement(_PolicyBase):
    """Contiguous id blocks: shard s owns rows
    ``[s * rows_per_shard, (s+1) * rows_per_shard)``.  Keeps each shard's
    rows physically adjacent (a range shard is one file / one namespace),
    at the cost of skew when hot ids cluster."""

    name = "range"

    def __init__(self, n_shards: int, num_nodes: int):
        super().__init__(n_shards)
        if num_nodes is None or num_nodes < 1:
            raise ValueError("range placement needs the namespace size "
                             "(num_nodes)")
        self.num_nodes = int(num_nodes)
        self.rows_per_shard = -(-self.num_nodes // self.n_shards)  # ceil

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray:
        shard = self._ids(node_ids) // self.rows_per_shard
        return np.clip(shard, 0, self.n_shards - 1).astype(np.int16)

    def state_dict(self) -> dict:
        return {**super().state_dict(), "num_nodes": self.num_nodes}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        # shard boundaries derive from the namespace size: restoring against
        # a different-size feature array would silently shift every boundary
        if state.get("num_nodes", self.num_nodes) != self.num_nodes:
            raise ValueError(
                f"{self.name} placement checkpointed over "
                f"{state.get('num_nodes')} nodes, namespace has "
                f"{self.num_nodes} — shard boundaries would shift")


@register_placement("range")
def _make_range(n_shards: int, *, num_nodes=None, **_ctx) -> RangePlacement:
    return RangePlacement(n_shards, num_nodes)


class DegreePlacement(_PolicyBase):
    """Degree-aware striping: nodes sorted by degree (descending, stable)
    are dealt round-robin across shards, so the hot high-degree head of a
    power-law graph spreads over every queue instead of hammering one.  The
    assignment is a materialized per-node table — the part a checkpoint must
    round-trip, and the seam an online rebalancer would mutate."""

    name = "degree"

    def __init__(self, n_shards: int, degrees: np.ndarray):
        super().__init__(n_shards)
        if degrees is None:
            raise ValueError("degree placement needs per-node degrees "
                             "(pass a graph to the tier factory)")
        degrees = np.asarray(degrees)
        order = np.argsort(-degrees, kind="stable")
        table = np.empty(len(degrees), np.int16)
        table[order] = np.arange(len(degrees), dtype=np.int64) % self.n_shards
        self.table = table

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray:
        return self.table[self._ids(node_ids)]

    def state_dict(self) -> dict:
        return {**super().state_dict(), "table": self.table.copy()}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        table = np.asarray(state["table"], np.int16)
        if table.shape != self.table.shape:
            # name the failing policy: multi-namespace checkpoints restore
            # several placements and "a table mismatched" is undebuggable
            raise ValueError(
                f"{self.name} placement table shape {table.shape} does not "
                f"match namespace {self.table.shape}")
        self.table = table.copy()


@register_placement("degree")
def _make_degree(n_shards: int, *, degrees=None, **_ctx) -> DegreePlacement:
    return DegreePlacement(n_shards, degrees)


class AdaptivePlacement(DegreePlacement):
    """Feedback-driven striping — `degree` that learns from measured touches.

    The initial table is *exactly* the degree deal (same stable sort, same
    round-robin), so an adaptive plane is bit-identical to a static `degree`
    plane until the first migration commits — static workloads pay nothing
    for turning feedback on.  A `TouchTable` (core/feedback.py) accumulates
    the measured per-node touches; `plan_rebalance()` proposes re-striping
    only the measured-hot nodes (score > 0) round-robin in score order,
    leaving the untouched cold tail wherever it already lives — that is what
    keeps migrations affordable: the moved set scales with the hot set, not
    the namespace.

    The policy is mechanism, not policy-about-policy: *when* to commit is
    the `ShardRebalancer`'s call (imbalance trigger + priced cost/benefit);
    `commit()` just swaps the table after validating it still partitions
    the namespace.  Table and touch table both ride `state_dict`, so a
    checkpoint taken mid-migration-epoch resumes the same assignment and
    the same learned scores."""

    name = "adaptive"

    def __init__(self, n_shards: int, degrees: np.ndarray,
                 alpha: float = 0.5):
        super().__init__(n_shards, degrees)
        self.touches = TouchTable(len(self.table), alpha=alpha)

    def plan_drain(self, shard: int) -> tuple[np.ndarray, np.ndarray]:
        """Propose evacuating the measured-hot rows OFF one shard — the
        fault plane's move when the `ShardHealthMonitor` flags a queue as
        browning out.  Hot nodes currently placed on `shard` are dealt
        round-robin by descending score across the OTHER shards; the cold
        tail stays put (a slow queue still holds its bytes — the drain
        moves the rows that are costing time, not the namespace).  Returns
        ``(new_table, moved_ids)`` like `plan_rebalance`; the
        `ShardRebalancer` prices and commits it."""
        if self.n_shards < 2 or not 0 <= int(shard) < self.n_shards:
            raise ValueError(
                f"{self.name} placement cannot drain shard {shard} of "
                f"{self.n_shards} — draining needs another shard to "
                "absorb the hot set")
        scores = self.touches.scores()
        hot = scores > scores.max() * 0.01 if scores.max() > 0 \
            else np.zeros(len(scores), bool)
        on = np.nonzero(hot & (self.table == int(shard)))[0]
        new = self.table.copy()
        if len(on):
            order = on[np.argsort(-scores[on], kind="stable")]
            others = np.array(
                [s for s in range(self.n_shards) if s != int(shard)],
                np.int16)
            new[order] = others[np.arange(len(order)) % len(others)]
        moved = np.nonzero(new != self.table)[0]
        return new, moved

    def plan_rebalance(self) -> tuple[np.ndarray, np.ndarray]:
        """Propose a re-striped table: measured-hot nodes dealt round-robin
        by descending score.  Returns ``(new_table, moved_ids)``; nothing is
        mutated — the caller decides whether the move is worth its price."""
        scores = self.touches.scores()
        # re-deal only the measurably hot: nodes whose decayed EMA has
        # fallen below 1% of the current peak stay where they are, so the
        # moved set (and the migration bill) tracks the LIVE hot set
        # instead of accreting every node ever touched
        hot = np.nonzero(scores > scores.max() * 0.01)[0] \
            if scores.max() > 0 else np.empty(0, np.int64)
        new = self.table.copy()
        if len(hot):
            order = hot[np.argsort(-scores[hot], kind="stable")]
            new[order] = (np.arange(len(order), dtype=np.int64)
                          % self.n_shards).astype(np.int16)
        moved = np.nonzero(new != self.table)[0]
        return new, moved

    def commit(self, new_table: np.ndarray) -> None:
        new_table = np.asarray(new_table, np.int16)
        if new_table.shape != self.table.shape:
            raise ValueError(
                f"{self.name} placement commit shape {new_table.shape} does "
                f"not match namespace {self.table.shape}")
        if len(new_table) and (new_table.min() < 0
                               or new_table.max() >= self.n_shards):
            raise ValueError(
                f"{self.name} placement commit maps nodes outside "
                f"[0, {self.n_shards}) — namespace no longer partitions")
        self.table = new_table.copy()

    def state_dict(self) -> dict:
        return {**super().state_dict(),
                "touches": self.touches.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.touches.load_state_dict(state["touches"])


@register_placement("adaptive")
def _make_adaptive(n_shards: int, *, degrees=None, **_ctx
                   ) -> AdaptivePlacement:
    return AdaptivePlacement(n_shards, degrees)


class MetisLitePlacement(_PolicyBase):
    """Greedy min-cut partitioning over the CSR — the distributed plane's
    locality policy (a METIS stand-in: BFS-grown balanced partitions, no
    external solver).

    Partitions are grown one at a time.  Each starts from the highest-
    degree unassigned seed and repeatedly absorbs the unassigned nodes
    with positive *gain* — the count of already-absorbed nodes pointing at
    them — best-gain-first (stable order), up to the balance target
    ``ceil(n / n_shards)``; when the frontier dries up (disconnected
    remainder) the next seed restarts it.  Growing along out-edges is what
    makes the policy pay off under the requester model (core/hosts.py): a
    node joins the partition holding most of its IN-neighbours, which is
    exactly the host that will request its feature row.

    Fully deterministic (argsort/argmax tie-breaks are positional), every
    partition is capped at the balance target, and the assignment is a
    materialized table that rides `state_dict` like `degree`'s."""

    name = "metis-lite"

    def __init__(self, n_shards: int, graph=None, indptr=None, indices=None,
                 num_nodes: int | None = None):
        super().__init__(n_shards)
        if graph is not None:
            indptr = getattr(graph, "indptr", indptr)
            indices = getattr(graph, "indices", indices)
        if indptr is None or indices is None:
            raise ValueError(
                "metis-lite placement needs the CSR adjacency — build the "
                "plane with a graph in context (the loader passes it)")
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        n = len(indptr) - 1
        if num_nodes is not None and int(num_nodes) != n:
            raise ValueError(
                f"metis-lite graph has {n} nodes but the namespace has "
                f"{num_nodes} rows — co-partitioning needs one host table "
                "covering both")
        self.table = _grow_partitions(indptr, indices, self.n_shards)

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray:
        return self.table[self._ids(node_ids)]

    def state_dict(self) -> dict:
        return {**super().state_dict(), "table": self.table.copy()}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        table = np.asarray(state["table"], np.int16)
        if table.shape != self.table.shape:
            raise ValueError(
                f"{self.name} placement table shape {table.shape} does not "
                f"match namespace {self.table.shape}")
        self.table = table.copy()


def _flat_adjacency(indptr: np.ndarray, take: np.ndarray,
                    indices: np.ndarray) -> np.ndarray:
    """All of `take`'s neighbours in one flat gather (CSR slice concat)."""
    counts = np.diff(indptr)[take]
    total = int(counts.sum())
    if not total:
        return indices[:0]
    flat = np.repeat(indptr[take] - (np.cumsum(counts) - counts),
                     counts) + np.arange(total)
    return indices[flat]


def _grow_partitions(indptr: np.ndarray, indices: np.ndarray,
                     k: int) -> np.ndarray:
    """The metis-lite growth loop: k balanced partitions, (N,) int16.

    Growth gain counts edges in BOTH directions (a candidate's edges into
    the growing partition plus the partition's edges into the candidate —
    the transpose CSR is built once), because the cut the multi-host plane
    pays for is symmetric: a cross-host edge costs a remote topology page
    on the sampling side and a remote feature row on the gather side
    (`requester_hosts`, core/hosts.py).

    Partitions are balanced by EDGE MASS (1 + in-degree + out-degree per
    node — METIS vertex weights), not node count: neighbor sampling lands
    on a node in proportion to its degree, so equal node counts on a
    power-law graph would pile nearly all sampled traffic onto whichever
    host drew the hub core and its SSD queue would straggle every burst.

    All k partitions grow ROUND-ROBIN, one absorption chunk each per
    round, from k distinct seeds.  Sequential growth would let partition
    0 harvest the tightest cluster and leave the last partition a bin of
    leftovers that requests everything remotely — interleaving keeps both
    the cut and the remote-serving load spread across hosts."""
    n = len(indptr) - 1
    table = np.full(n, -1, np.int16)
    if k <= 1 or n == 0:
        table[:] = 0
        return table
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    # transpose CSR: r_indices[r_indptr[u]:r_indptr[u+1]] = in-neighbours
    outdeg = np.diff(indptr)
    owner = np.repeat(np.arange(n, dtype=np.int64), outdeg)
    order = np.argsort(indices, kind="stable")
    r_indices = owner[order]
    r_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(indices, minlength=n), out=r_indptr[1:])
    deg = outdeg + np.diff(r_indptr)  # total degree seeds the densest hub
    w = 1 + deg  # per-node mass: expected sampled traffic, never zero
    target = -(-int(w.sum()) // k)  # ceil: the mass cap per partition
    gains = np.zeros((k, n), np.int64)  # per-partition: edges touching p
    masses = np.zeros(k, np.int64)
    active = True
    while active:
        active = False
        for p in range(k):
            if masses[p] >= target:
                continue
            gain = gains[p]
            cand = np.nonzero((table == -1) & (gain > 0))[0]
            if len(cand) == 0:
                unassigned = np.nonzero(table == -1)[0]
                if len(unassigned) == 0:
                    continue
                # (re)seed: densest unassigned node anchors the partition
                take = unassigned[np.argmax(deg[unassigned])][None]
            else:
                # absorb majority-internal candidates in bulk; when the
                # frontier is only weakly attached (gain 1-2 via stray
                # cross-cluster edges), cross it a few best-ratio nodes at
                # a time instead of flooding — raw gain > 0 would leak the
                # partition through every rewired edge and shred the cut
                ratio = gain[cand] / deg[cand]
                strong = ratio >= 0.5
                if strong.any():
                    cand = cand[strong]
                    order = np.argsort(-gain[cand], kind="stable")
                else:
                    order = np.argsort(-ratio, kind="stable")[:32]
                fill = np.cumsum(w[cand[order]])
                fit = fill <= target - masses[p]
                fit[0] = True  # always absorb the best candidate
                take = cand[order[fit]]
            table[take] = p
            masses[p] += int(w[take].sum())
            np.add.at(gain, _flat_adjacency(indptr, take, indices), 1)
            np.add.at(gain, _flat_adjacency(r_indptr, take, r_indices), 1)
            active = True
    leftover = np.nonzero(table == -1)[0]
    if len(leftover):
        # mass overshoot can exhaust later partitions' budgets: pack the
        # remainder onto the lightest partitions deterministically
        for v in leftover[np.argsort(-w[leftover], kind="stable")]:
            dest = int(np.argmin(masses))
            table[v] = dest
            masses[dest] += w[v]
    return table


@register_placement("metis-lite")
def _make_metis_lite(n_shards: int, *, graph=None, num_nodes=None, **_ctx
                     ) -> MetisLitePlacement:
    return MetisLitePlacement(n_shards, graph=graph, num_nodes=num_nodes)


class ReplicatedPlacement:
    """k-way replication wrapped around ANY registered placement policy.

    Replica j of a node whose primary shard is s lives on
    ``(s + j) % n_shards`` — chained declustering, so losing one shard
    spreads its read load over its neighbours instead of doubling one
    queue.  `shard_of` still answers with the PRIMARY (the fault-free plane
    routes and prices bit-identically to the bare policy); the extra
    copies exist for the fault plane: `FailoverRouter` (core/faults.py)
    re-routes reads off dead/degraded primaries at plan time, and the
    `FaultInjector`'s burst pricing drains a dead shard's IOs — and a
    straggler's hedged residual — on the replica queues.

    Replication perturbs routing, never data: every replica of a row holds
    the same bytes, so gathered features cannot depend on which copy
    served them.  Attribute access falls through to the wrapped policy, so
    an adaptive base keeps its `table`/`touches`/`plan_rebalance` seam and
    the `ShardRebalancer` works unchanged."""

    def __init__(self, base: PlacementPolicy, replication_factor: int,
                 failure_domains=None):
        k = int(replication_factor)
        name = getattr(base, "name", "placement")
        # fail loudly at construction: a bad replica map discovered at
        # failover time is an outage, not an exception
        if k < 2:
            raise ValueError(
                f"{name} placement: replication_factor must be >= 2 "
                f"(got {k}); use the bare policy for an unreplicated plane")
        if base.n_shards < 2:
            raise ValueError(
                f"{name} placement: replication needs n_shards >= 2 "
                f"(got {base.n_shards}) — with one shard every replica "
                "lands on the queue it is supposed to survive")
        if k > base.n_shards:
            raise ValueError(
                f"{name} placement: replication_factor {k} exceeds "
                f"n_shards {base.n_shards} — replicas of one node must "
                "land on distinct shards")
        self.base = base
        self.replication_factor = k
        self.n_shards = base.n_shards
        self.name = f"replicated({name})x{k}"
        # fault-aware spread: `failure_domains[s]` names the domain (host,
        # rack, ...) shard s lives in, and replica j walks s+1, s+2, ...
        # skipping shards whose domain is already used — so no two copies
        # of a row share a domain and a whole-domain outage cannot lose
        # data.  With None, or all-distinct domains (each HOST its own
        # domain — the core/hosts.py plane), the walk degenerates to the
        # chained-declustering formula above, bit-identically.
        self.failure_domains = None
        self._replica_map = None
        if failure_domains is not None:
            domains = np.asarray(failure_domains, np.int64)
            if domains.shape != (self.n_shards,):
                raise ValueError(
                    f"{self.name} placement: failure_domains shape "
                    f"{domains.shape} does not match {self.n_shards} shards")
            if len(np.unique(domains)) < k:
                raise ValueError(
                    f"{self.name} placement: only "
                    f"{len(np.unique(domains))} failure domain(s) for "
                    f"replication factor {k} — copies of one row would "
                    "share a domain and die together")
            self.failure_domains = domains
            rep = np.empty((self.n_shards, k), np.int64)
            for s in range(self.n_shards):
                rep[s, 0] = s
                used = {int(domains[s])}
                j, step = 1, 1
                while j < k:
                    t = (s + step) % self.n_shards
                    if int(domains[t]) not in used:
                        rep[s, j] = t
                        used.add(int(domains[t]))
                        j += 1
                    step += 1
            self._replica_map = rep

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray:
        return self.base.shard_of(node_ids)

    def replica_shards(self, shard: int) -> tuple[int, ...]:
        """The replica queues for primary shard `shard` (excludes it)."""
        if self._replica_map is not None:
            return tuple(int(t) for t in self._replica_map[int(shard), 1:])
        return tuple((int(shard) + j) % self.n_shards
                     for j in range(1, self.replication_factor))

    def replicas_of(self, node_ids: np.ndarray) -> np.ndarray:
        """``(len(node_ids), k)`` shard matrix; column 0 is the primary."""
        primary = np.asarray(self.base.shard_of(node_ids), np.int64)
        if self._replica_map is not None:
            return self._replica_map[primary]
        offsets = np.arange(self.replication_factor, dtype=np.int64)
        return (primary[:, None] + offsets[None, :]) % self.n_shards

    def state_dict(self) -> dict:
        domains = None if self.failure_domains is None \
            else self.failure_domains.copy()
        return {"name": self.name, "n_shards": self.n_shards,
                "replication_factor": self.replication_factor,
                "failure_domains": domains,
                "base": self.base.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        k = state.get("replication_factor")
        if state.get("name", self.name) != self.name \
                or k != self.replication_factor:
            raise ValueError(
                f"{self.name} placement: checkpoint replica map "
                f"{state.get('name')!r} (x{k}) does not match "
                f"x{self.replication_factor} — failover would route reads "
                "to shards that never held the replica")
        saved = state.get("failure_domains", self.failure_domains)
        ours = self.failure_domains
        if (saved is None) != (ours is None) or (
                ours is not None
                and not np.array_equal(np.asarray(saved), ours)):
            raise ValueError(
                f"{self.name} placement: checkpoint failure domains do not "
                "match — the replica map would route failover reads to "
                "shards that never held the copy")
        self.base.load_state_dict(state["base"])

    def __getattr__(self, attr: str):
        # the adaptive seam (table / touches / plan_rebalance / plan_drain /
        # commit) and any policy-specific state fall through to the base
        return getattr(self.base, attr)


class SkewedPlacement(_PolicyBase):
    """A deliberately bad hash for the degradation benchmark: shard 0 gets
    `n_shards` weight slots to every other shard's one, so it owns
    ``n / (2n - 1)`` of the namespace (half, in the large-n limit) and the
    max-over-shards pricing exposes the straggler queue."""

    name = "skewed"

    def __init__(self, n_shards: int):
        super().__init__(n_shards)
        weights = np.ones(self.n_shards, np.int64)
        weights[0] = self.n_shards
        self.slots = np.repeat(np.arange(self.n_shards, dtype=np.int16),
                               weights)

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray:
        mixed = _mix(self._ids(node_ids))
        return self.slots[mixed % np.uint64(len(self.slots))]


@register_placement("skewed")
def _make_skewed(n_shards: int, **_ctx) -> SkewedPlacement:
    return SkewedPlacement(n_shards)
