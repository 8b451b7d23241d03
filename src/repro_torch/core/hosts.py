"""Multi-host distributed data plane, the port's copy of
`repro.core.hosts`: the placement registry promoted from partitioning an
SSD namespace to partitioning a *cluster*.

Each shard is a HOST described by a `HostLinkSpec` (its interconnect into
the fabric plus its local `SSDSpec`), so the max-over-shards burst
pricing, straggler/imbalance telemetry, fault injection and the feedback
machinery all carry over unchanged.  What changes is the cost model: a
feature row served by a host other than the one that *requested* it
transits that host's link, and `StorageTimeline.price_host_burst`
(core/storage_sim.py) composes the remote host's local storage drain with
that link-transit term.

Who requests a row?  The cluster runs one trainer per host (DistDGL-style
data-parallel sampling): host h samples the frontier expanded from ITS
partition of the adjacency, so feature row u is requested by the host that
owns the edges *into* u.  `requester_hosts` materializes that as a static
per-node table (the majority vote over u's in-neighbors' topology hosts).
A storage request is REMOTE iff its requester differs from the serving
shard; remote rows ship as whole 4 KB lines over the serving host's link.

Under `hash` striping ~(k-1)/k of every batch is remote no matter how the
topology is placed, while a min-cut placement (`metis-lite`,
core/sharding.py) co-partitioned with the adjacency
(`CoPartitionedPlacement`: one placement decision drives both the feature
rows and the CSR edge pages of a node) keeps a node's in-neighbors, hence
its requester, on its own host.

`n_hosts=1` degenerates exactly: no remote lines exist, the link term is
never added, and the plane prices bit-identically to the single-host
plane.  Features and blocks are bit-identical across all host counts and
placements: hosts change pricing and telemetry, never bytes.  The link
presets are the reference's data; `HostShardTier.record_metrics` folds
the static placement telemetry into a metrics registry.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .storage_sim import IO_BYTES, SSDSpec
from .tiers import ShardedStorageTier

#: Decorrelated 64-bit mix for the *independent* (non-co-partitioned)
#: topology-host assignment — a different odd constant than sharding._FIB
#: so the two namespaces' hash stripes never accidentally align.
_MIX2 = np.uint64(0xC2B2AE3D27D4EB4F)


@dataclasses.dataclass(frozen=True)
class HostLinkSpec:
    """One host of the cluster: its interconnect into the fabric (NIC /
    PCIe peer link / ICI) and its local storage device.  `ssd=None` means
    "inherit the loader's device spec" — `HostShardTier.resolve_hosts`
    fills it in, the same fallback `ShardedStorageTier.resolve_shard_specs`
    gives spec-less shards."""

    name: str
    link_bw: float                    # bytes/s into the fabric
    link_rtt_s: float                 # one remote exchange's round trip
    ssd: SSDSpec | None = None        # local device; None = loader default

    def with_ssd(self, ssd: SSDSpec) -> "HostLinkSpec":
        return dataclasses.replace(self, ssd=ssd)


# Stock interconnects.  100GbE is the default cluster fabric; the RTTs are
# switch-traversal scale (not WAN) — a rack-local training pod.
NIC_100GBE = HostLinkSpec("nic-100gbe", link_bw=12.5e9, link_rtt_s=10e-6)
NIC_400GBE = HostLinkSpec("nic-400gbe", link_bw=50e9, link_rtt_s=5e-6)
TPU_ICI = HostLinkSpec("tpu-ici", link_bw=90e9, link_rtt_s=1.5e-6)


def default_hosts(n_hosts: int, link: HostLinkSpec = NIC_100GBE,
                  ssd: SSDSpec | None = None) -> tuple[HostLinkSpec, ...]:
    """A homogeneous cluster of `n_hosts` copies of `link`, named host0..N."""
    return tuple(
        dataclasses.replace(link, name=f"{link.name}/host{h}", ssd=ssd)
        for h in range(int(n_hosts)))


def independent_hosts(num_nodes: int, n_hosts: int,
                      seed: int = 0) -> np.ndarray:
    """The NON-co-partitioned topology-host assignment: a hash stripe over
    node ids deliberately decorrelated from every feature placement, so
    "independent" means what it says — a node's adjacency host carries no
    information about its feature host.  (int16, like every shard table.)"""
    if n_hosts <= 1:
        return np.zeros(num_nodes, np.int16)
    ids = np.arange(num_nodes, dtype=np.uint64)
    mixed = ((ids + np.uint64(seed) * np.uint64(0x9E3779B9)) * _MIX2) \
        >> np.uint64(40)
    return (mixed % np.uint64(n_hosts)).astype(np.int16)


def requester_hosts(indptr: np.ndarray, indices: np.ndarray,
                    topo_host: np.ndarray, n_hosts: int) -> np.ndarray:
    """Which host requests each node's feature row, (N,) int16.

    One trainer per host samples the frontier expanded from its own
    adjacency partition, so node u's features are fetched by the host
    owning the edges INTO u: the majority vote over u's in-neighbors v of
    `topo_host[v]`.  Ties break toward u's OWN adjacency host when it is
    among the winners (a host sampling its own partition touches its own
    nodes first; any residual tie takes the lowest host index — fully
    deterministic).  Nodes nothing points at (seed-only nodes) are
    requested by their own adjacency's host: seeds expand locally."""
    n = len(indptr) - 1
    topo_host = np.asarray(topo_host)
    if n_hosts <= 1 or len(indices) == 0:
        return topo_host.astype(np.int16).copy()
    outdeg = np.diff(np.asarray(indptr, np.int64))
    owner = np.repeat(np.arange(n, dtype=np.int64), outdeg)
    votes = np.zeros((n, int(n_hosts)), np.int64)
    np.add.at(votes, (np.asarray(indices, np.int64),
                      topo_host[owner].astype(np.int64)), 1)
    req = votes.argmax(axis=1).astype(np.int16)
    own = topo_host.astype(np.int64)
    own_wins = votes[np.arange(n), own] == votes[np.arange(n), req]
    req[own_wins] = own[own_wins].astype(np.int16)
    unsampled = votes.sum(axis=1) == 0
    req[unsampled] = topo_host[unsampled].astype(np.int16)
    return req


def cut_edge_fraction(indptr: np.ndarray, indices: np.ndarray,
                      node_host: np.ndarray) -> float:
    """Fraction of CSR edges whose endpoints live on different hosts — the
    DistDGL cost driver the metis-lite placement minimizes.  Static (a
    function of graph + placement only), so benchmarks can report it
    without running a single batch."""
    indices = np.asarray(indices, np.int64)
    if len(indices) == 0:
        return 0.0
    node_host = np.asarray(node_host)
    outdeg = np.diff(np.asarray(indptr, np.int64))
    owner = np.repeat(np.arange(len(outdeg), dtype=np.int64), outdeg)
    return float(np.mean(node_host[owner] != node_host[indices]))


class CoPartitionedPlacement:
    """ONE placement decision driving BOTH namespaces: a node's feature
    rows and its CSR edge pages land on the same host.

    Wraps any registered placement policy; `shard_of` (the feature
    namespace) answers with the base decision and `topology_host_of` (the
    adjacency namespace) answers with the SAME decision — agreement for
    every node by construction, which is the property the hypothesis suite
    pins.  Edge pages are placed by the owner of their first edge word
    (`page_host_of`), so a node's adjacency pages follow it.

    Attribute access falls through to the base policy, so an adaptive base
    keeps its `plan_rebalance`/`commit` seam and a replicated base its
    replica map — the whole feedback/fault stack works unchanged
    through this wrapper."""

    def __init__(self, base):
        self.base = base
        self.n_shards = base.n_shards
        self.name = f"co-partitioned({getattr(base, 'name', 'placement')})"

    def shard_of(self, node_ids: np.ndarray) -> np.ndarray:
        return self.base.shard_of(node_ids)

    def topology_host_of(self, node_ids: np.ndarray) -> np.ndarray:
        """The adjacency namespace's host for each node == the feature
        namespace's shard.  This method EXISTING is what marks a placement
        co-partitioned (`HostShardTier` keys off it)."""
        return self.base.shard_of(node_ids)

    def page_host_of(self, indptr: np.ndarray, n_edge_words: int,
                     page_words: int) -> np.ndarray:
        """Host of each 4 KB edge page: the owner node of the page's first
        edge word (pages are node-contiguous in CSR order, so this keeps a
        node's whole adjacency with its features up to page-boundary
        spill)."""
        indptr = np.asarray(indptr, np.int64)
        n_pages = max(1, -(-int(n_edge_words) // int(page_words)))
        first = np.minimum(np.arange(n_pages, dtype=np.int64) * page_words,
                           max(int(n_edge_words) - 1, 0))
        owner = np.searchsorted(indptr, first, side="right") - 1
        owner = np.clip(owner, 0, len(indptr) - 2)
        return np.asarray(self.base.shard_of(owner), np.int16)

    def state_dict(self) -> dict:
        return {"name": self.name, "n_shards": self.n_shards,
                "base": self.base.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if state.get("name", self.name) != self.name \
                or state.get("n_shards", self.n_shards) != self.n_shards:
            raise ValueError(
                f"co-partitioned placement state {state.get('name')!r}/"
                f"{state.get('n_shards')} does not match {self.name!r}/"
                f"{self.n_shards}")
        self.base.load_state_dict(state["base"])

    def __getattr__(self, attr: str):
        # adaptive seam (table/touches/plan_rebalance/commit), replica map
        # (replicas_of/replica_shards), and policy state fall through
        return getattr(self.base, attr)


class HostShardTier(ShardedStorageTier):
    """The storage backstop partitioned across a CLUSTER: each shard is a
    host (`HostLinkSpec` — interconnect + local SSD) rather than a bare
    SSD queue.  Bytes are unchanged; what this tier adds over
    `ShardedStorageTier` is the *requester* model: a static per-node table
    of which host fetches each row (in-neighbor majority over the
    topology-host assignment, `requester_hosts`), from which `build_plan`
    stamps a per-request remote mask and the merged executor derives the
    per-host remote 4 KB line counts that `StorageTimeline.
    price_host_burst` ships over each host's link.

    `co_partition=True` (default) wraps the placement in
    `CoPartitionedPlacement` — one decision for features AND edge pages;
    False assigns the adjacency by an `independent_hosts` hash stripe, the
    double-network-hop baseline the benchmarks compare against."""

    def __init__(self, features: np.ndarray, placement, hosts=None, *,
                 graph=None, co_partition: bool = True,
                 name: str = "host-storage", seed: int = 0):
        if co_partition and not hasattr(placement, "topology_host_of"):
            placement = CoPartitionedPlacement(placement)
        super().__init__(features, placement, specs=None, name=name)
        n_hosts = placement.n_shards
        if hosts is None:
            hosts = default_hosts(n_hosts)
        elif isinstance(hosts, HostLinkSpec):
            hosts = default_hosts(n_hosts, link=hosts, ssd=hosts.ssd)
        else:
            hosts = tuple(hosts)
        if len(hosts) != n_hosts:
            raise ValueError(
                f"{len(hosts)} host specs for {n_hosts} hosts — pass one "
                "HostLinkSpec per host (or a single spec to replicate)")
        self.hosts = hosts
        self.graph = graph
        self.seed = int(seed)
        self.co_partition = hasattr(placement, "topology_host_of")
        n = len(features)
        if self.co_partition:
            self._topo_host = np.asarray(
                placement.topology_host_of(np.arange(n)), np.int16)
        else:
            self._topo_host = independent_hosts(n, n_hosts, seed)
        if graph is not None:
            self._requester = requester_hosts(
                graph.indptr, graph.indices, self._topo_host, n_hosts)
        else:
            # no adjacency to vote over: each row is requested where its
            # (modelled) adjacency lives — co-partitioned planes see zero
            # remote, independent planes the decorrelated-hash mismatch
            self._requester = self._topo_host.copy()

    # -- the host-level vocabulary --------------------------------------------
    @property
    def n_hosts(self) -> int:
        return self.n_shards

    def resolve_hosts(self, default_ssd: SSDSpec) -> tuple[HostLinkSpec, ...]:
        """Per-host `HostLinkSpec`s with every `ssd=None` filled from the
        loader's device — what the loader wires into
        `StorageTimeline.host_specs`."""
        return tuple(h if h.ssd is not None else h.with_ssd(default_ssd)
                     for h in self.hosts)

    def resolve_shard_specs(self, default_spec) -> tuple:
        """Each host's local SSD is its shard's device."""
        return tuple(h.ssd if h.ssd is not None else default_spec
                     for h in self.hosts)

    def topo_host_of(self, node_ids: np.ndarray) -> np.ndarray:
        """Host owning each node's adjacency (== `shard_of` under
        co-partitioning — the agreement property)."""
        return self._topo_host[np.asarray(node_ids, np.int64)]

    def requester_of(self, node_ids: np.ndarray) -> np.ndarray:
        return self._requester[np.asarray(node_ids, np.int64)]

    def remote_mask(self, node_ids: np.ndarray,
                    serving_shard: np.ndarray) -> np.ndarray:
        """True where the serving host differs from the requester —
        `build_plan` stamps this into `GatherPlan.remote` and the priced
        burst ships those rows' lines over the serving hosts' links."""
        req = self._requester[np.asarray(node_ids, np.int64)]
        return req != np.asarray(serving_shard, np.int16)

    def topology_page_shard(self, page_bytes: int = IO_BYTES) -> np.ndarray:
        """Per-page host assignment for the topology store — each CSR edge
        page goes to the host owning its first edge word's node, resolved
        against THIS tier's topology-host table (co-partitioned or
        independent), so the loader builds one cluster, not two."""
        if self.graph is None:
            raise ValueError(
                f"{self.name}: topology_page_shard needs the graph — build "
                "the tier with graph= (the host_storage factory passes it)")
        indices = self.graph.indices
        indptr = np.asarray(self.graph.indptr, np.int64)
        page_words = max(1, int(page_bytes) // indices.dtype.itemsize)
        n_pages = max(1, -(-len(indices) // page_words))
        first = np.minimum(np.arange(n_pages, dtype=np.int64) * page_words,
                           max(len(indices) - 1, 0))
        owner = np.searchsorted(indptr, first, side="right") - 1
        owner = np.clip(owner, 0, len(indptr) - 2)
        return self._topo_host[owner].astype(np.int16)

    # -- telemetry -------------------------------------------------------------
    def cut_edge_fraction(self) -> float:
        """Fraction of edges crossing hosts under this tier's topology
        placement (0.0 without a graph)."""
        if self.graph is None:
            return 0.0
        return cut_edge_fraction(self.graph.indptr, self.graph.indices,
                                 self._topo_host)

    def remote_fraction(self) -> float:
        """Expected fraction of the namespace whose requester differs from
        its PRIMARY feature shard — the static cross-host traffic share
        (failover rerouting can shift the realized value)."""
        n = len(self.features)
        primary = np.asarray(self.placement.shard_of(np.arange(n)), np.int16)
        return float(np.mean(self._requester != primary))

    def record_metrics(self, registry) -> None:
        """Fold the cluster's static placement telemetry into a
        MetricsRegistry (repro_torch.obs): host count, the placement's
        expected cross-host request share, and the edge-cut fraction the
        metis-lite partitioner minimizes.  Per-burst realized traffic lands
        in the registry separately via `StorageTimeline._note_burst`."""
        registry.gauge("hosts.n_hosts").set(self.n_hosts)
        registry.gauge("hosts.placement_remote_fraction").set(
            self.remote_fraction())
        registry.gauge("hosts.cut_edge_fraction").set(
            self.cut_edge_fraction())

    # -- checkpoint ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {**super().state_dict(), "co_partition": self.co_partition}

    def load_state_dict(self, state: dict) -> None:
        if bool(state.get("co_partition", self.co_partition)) \
                != self.co_partition:
            raise ValueError(
                f"checkpoint is {'co-partitioned' if state.get('co_partition') else 'independent'}, "
                f"tier is {'co-partitioned' if self.co_partition else 'independent'} "
                "— the topology-host table would not round-trip")
        super().load_state_dict(state)
        # the placement table may have been restored (adaptive bases):
        # rebuild the derived host tables so topology/requester stay in sync
        n = len(self.features)
        if self.co_partition:
            self._topo_host = np.asarray(
                self.placement.topology_host_of(np.arange(n)), np.int16)
            if self.graph is not None:
                self._requester = requester_hosts(
                    self.graph.indptr, self.graph.indices, self._topo_host,
                    self.n_shards)
            else:
                self._requester = self._topo_host.copy()
