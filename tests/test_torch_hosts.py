"""The port's cluster plane (repro_torch.core.hosts and clustered_graph)
against the JAX package's on the CPU: the community-structured graph, the
link presets, requester and independent host tables, the cut-edge
fraction, co-partitioned placement, `HostShardTier`, and the `gids-hosts`
and `gids-hosts-merged` loaders (blocks, features, reports, priced prep
and states) bit for bit.  With one host the cluster plane is the
single-host merged plane, float for float."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.core import hosts as jhosts  # noqa: E402
from repro.core import sharding as jsh  # noqa: E402
from repro.core.dataplane import DataPlaneSpec as JSpec  # noqa: E402
from repro.core.storage_sim import INTEL_OPTANE as J_OPTANE  # noqa: E402
from repro.graph.synthetic import clustered_graph as jclustered  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core import hosts as thosts  # noqa: E402
from repro_torch.core import sharding as tsh  # noqa: E402
from repro_torch.core.dataplane import DataPlaneSpec  # noqa: E402
from repro_torch.core.storage_sim import INTEL_OPTANE as T_OPTANE  # noqa: E402
from repro_torch.graph.synthetic import clustered_graph  # noqa: E402

N, DIM = 4000, 16


def same(a, b) -> bool:
    """Equal, recursing through dicts, sequences and numpy arrays."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.fixture(scope="module")
def graphs():
    kw = dict(communities=16, intra=0.9, seed=1)
    return jclustered(N, 10, DIM, **kw), clustered_graph(N, 10, DIM, **kw)


@pytest.mark.parametrize("n,communities,intra,seed", [
    (3000, 16, 0.9, 0), (5000, 7, 0.5, 3), (2000, 1, 1.0, 2),
    (1500, 32, 0.0, 5)])
def test_clustered_graph_matches_reference(n, communities, intra, seed):
    a = jclustered(n, 8, 4, communities=communities, intra=intra, seed=seed)
    b = clustered_graph(n, 8, 4, communities=communities, intra=intra,
                        seed=seed)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indices.dtype == b.indices.dtype
    with pytest.raises(ValueError, match="intra"):
        clustered_graph(100, 4, 4, intra=1.5)


def test_link_presets_and_default_hosts_match_reference():
    for name in ("NIC_100GBE", "NIC_400GBE", "TPU_ICI"):
        assert dataclasses.asdict(getattr(jhosts, name)) \
            == dataclasses.asdict(getattr(thosts, name))
    a = jhosts.default_hosts(3, jhosts.NIC_400GBE)
    b = thosts.default_hosts(3, thosts.NIC_400GBE)
    assert [dataclasses.asdict(h) for h in a] \
        == [dataclasses.asdict(h) for h in b]


@pytest.mark.parametrize("n_hosts", [1, 2, 4, 5])
def test_host_tables_match_reference(graphs, n_hosts):
    jg, tg = graphs
    for seed in (0, 3):
        ja = jhosts.independent_hosts(N, n_hosts, seed)
        tb = thosts.independent_hosts(N, n_hosts, seed)
        assert ja.dtype == tb.dtype
        np.testing.assert_array_equal(ja, tb)
    topo = jsh.make_placement("metis-lite", n_hosts, graph=jg).table
    np.testing.assert_array_equal(
        topo, tsh.make_placement("metis-lite", n_hosts, graph=tg).table)
    for table in (topo, tb):
        ra = jhosts.requester_hosts(jg.indptr, jg.indices, table, n_hosts)
        rb = thosts.requester_hosts(tg.indptr, tg.indices, table, n_hosts)
        np.testing.assert_array_equal(ra, rb)
        assert jhosts.cut_edge_fraction(jg.indptr, jg.indices, table) \
            == thosts.cut_edge_fraction(tg.indptr, tg.indices, table)


def test_co_partitioned_placement_matches_reference(graphs):
    jg, tg = graphs
    a = jhosts.CoPartitionedPlacement(
        jsh.make_placement("adaptive", 4, degrees=jg.degrees()))
    b = thosts.CoPartitionedPlacement(
        tsh.make_placement("adaptive", 4, degrees=tg.degrees()))
    ids = np.arange(N)
    np.testing.assert_array_equal(b.shard_of(ids), b.topology_host_of(ids))
    np.testing.assert_array_equal(a.topology_host_of(ids),
                                  b.topology_host_of(ids))
    for words in (1024, 97):
        np.testing.assert_array_equal(
            a.page_host_of(jg.indptr, len(jg.indices), words),
            b.page_host_of(tg.indptr, len(tg.indices), words))
    assert a.name == b.name and hasattr(b, "plan_rebalance")
    assert same(a.state_dict(), b.state_dict())
    b.load_state_dict(a.state_dict())
    with pytest.raises(ValueError, match="does not match"):
        b.load_state_dict({**a.state_dict(), "n_shards": 3})


@pytest.mark.parametrize("placement,co", [("metis-lite", True),
                                          ("hash", False), ("degree", True)])
def test_host_shard_tier_matches_reference(graphs, placement, co):
    jg, tg = graphs
    feats = np.zeros((N, 4), np.float32)
    ja = jhosts.HostShardTier(
        feats, jsh.make_placement(placement, 4, degrees=jg.degrees(),
                                  graph=jg), graph=jg, co_partition=co)
    tb = thosts.HostShardTier(
        feats, tsh.make_placement(placement, 4, degrees=tg.degrees(),
                                  graph=tg), graph=tg, co_partition=co)
    ids = np.random.default_rng(0).permutation(N)[:1500]
    for name in ("topo_host_of", "requester_of", "shard_of"):
        np.testing.assert_array_equal(getattr(ja, name)(ids),
                                      getattr(tb, name)(ids))
    np.testing.assert_array_equal(ja.remote_mask(ids, ja.shard_of(ids)),
                                  tb.remote_mask(ids, tb.shard_of(ids)))
    np.testing.assert_array_equal(ja.topology_page_shard(),
                                  tb.topology_page_shard())
    assert ja.cut_edge_fraction() == tb.cut_edge_fraction()
    assert ja.remote_fraction() == tb.remote_fraction()
    assert tb.n_hosts == 4 and tb.co_partition == co
    assert [dataclasses.asdict(h) for h in ja.resolve_hosts(J_OPTANE)] \
        == [dataclasses.asdict(h) for h in tb.resolve_hosts(T_OPTANE)]
    assert tb.resolve_shard_specs(T_OPTANE) == (T_OPTANE,) * 4
    assert same(ja.state_dict(), tb.state_dict())
    tb.load_state_dict(ja.state_dict())
    with pytest.raises(ValueError, match="round-trip"):
        tb.load_state_dict({**ja.state_dict(), "co_partition": not co})
    with pytest.raises(ValueError, match="host specs"):
        thosts.HostShardTier(feats, tsh.make_placement("hash", 4),
                             hosts=thosts.default_hosts(3))


@pytest.mark.parametrize("link", ["NIC_400GBE", "TPU_ICI"])
def test_host_tier_links_match_reference(link):
    """A tier built with its own links resolves them as the reference
    does: one link for every host, or one per host with a host's own
    local SSD; the loader's device fills only the hosts without one."""
    from repro.core import storage_sim as jsim
    from repro_torch.core import storage_sim as tsim
    feats = np.zeros((100, 4), np.float32)

    def per_host(m, sim):
        hs = m.default_hosts(4, getattr(m, link))
        return hs[:3] + (hs[3].with_ssd(sim.SAMSUNG_980PRO),)
    for hosts in (lambda m, sim: getattr(m, link), per_host):
        ja = jhosts.HostShardTier(feats, jsh.make_placement("hash", 4),
                                  hosts=hosts(jhosts, jsim),
                                  co_partition=False)
        tb = thosts.HostShardTier(feats, tsh.make_placement("hash", 4),
                                  hosts=hosts(thosts, tsim),
                                  co_partition=False)
        want = [dataclasses.asdict(h) for h in ja.resolve_hosts(J_OPTANE)]
        got = [dataclasses.asdict(h) for h in tb.resolve_hosts(T_OPTANE)]
        assert got == want and got[0]["link_bw"] == getattr(
            thosts, link).link_bw
        assert [dataclasses.asdict(s) for s in tb.resolve_shard_specs(
            T_OPTANE)] == [dataclasses.asdict(s)
                           for s in ja.resolve_shard_specs(J_OPTANE)]


KW = dict(batch_size=96, fanouts=(4, 3), cache_lines=256, cache_ways=4,
          window_depth=4, seed=5)


def _loaders(graphs, plane, topology=False, **kw):
    jg, tg = graphs
    feats = np.random.default_rng(0).standard_normal((N, DIM)) \
        .astype(np.float32)
    jplane = JSpec.preset(plane, topology=True) if topology else plane
    tplane = DataPlaneSpec.preset(plane, topology=True) if topology \
        else plane
    ref = JLoader(jg, feats, JConfig(data_plane=jplane, **KW, **kw))
    port = GIDSDataLoader(tg, feats, LoaderConfig(data_plane=tplane, **KW,
                                                  **kw), device="cpu")
    return feats, ref, port


@pytest.mark.parametrize("topology", [False, True])
@pytest.mark.parametrize("placement,co", [("metis-lite", True),
                                          ("hash", False)])
@pytest.mark.parametrize("plane", ["gids-hosts", "gids-hosts-merged"])
def test_host_loader_matches_reference(graphs, plane, placement, co,
                                       topology):
    """Blocks, features, reports (shard and remote rows and lines), priced
    prep, sampling time and host-burst telemetry bit-identical for 12
    batches, and the loader states equal and cross-loaded."""
    feats, ref, port = _loaders(graphs, plane, topology, n_hosts=4,
                                placement=placement, co_partition=co)
    for _ in range(12):
        a, b = ref.next_batch(), port.next_batch()
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
        assert dataclasses.asdict(a.report) == dataclasses.asdict(b.report)
        assert (a.prep_time_s, a.exposed_prep_s, a.sample_time_s) \
            == (b.prep_time_s, b.exposed_prep_s, b.sample_time_s)
        ha, hb = ref.timeline.host_burst, port.timeline.host_burst
        assert (ha is None) == (hb is None)
        if hb is not None:
            assert (ha.per_shard_s, ha.link_s, ha.remote_lines,
                    ha.remote_fraction) == (hb.per_shard_s, hb.link_s,
                                            hb.remote_lines,
                                            hb.remote_fraction)
    if topology:
        np.testing.assert_array_equal(ref.topo.page_shard,
                                      port.topo.page_shard)
    sa, sb = ref.state_dict(), port.state_dict()
    assert "tier_state" in sb and same(sa, sb)
    _, ref2, port2 = _loaders(graphs, plane, topology, n_hosts=4,
                              placement=placement, co_partition=co)
    ref2.load_state_dict(sb)
    port2.load_state_dict(sa)
    for _ in range(4):
        a, b = ref2.next_batch(), port2.next_batch()
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert a.prep_time_s == b.prep_time_s


@pytest.mark.parametrize("placement", ["metis-lite", "hash"])
def test_one_host_is_the_merged_plane(graphs, placement):
    """n_hosts=1: blocks, features and every priced float equal the
    port's gids-merged plane's (and so the reference's)."""
    _, _, single = _loaders(graphs, "gids-merged")
    _, ref, one = _loaders(graphs, "gids-hosts-merged", n_hosts=1,
                           placement=placement)
    for _ in range(12):
        a, b, c = single.next_batch(), one.next_batch(), ref.next_batch()
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert torch.equal(a.features, b.features)
        assert a.prep_time_s == b.prep_time_s == c.prep_time_s
        assert a.exposed_prep_s == b.exposed_prep_s
    assert one.timeline.host_burst is None


def test_replicas_spread_across_hosts(graphs):
    _, ref, port = _loaders(graphs, "gids-hosts-merged", n_hosts=4,
                            placement="metis-lite", replication_factor=2)
    ja, tb = ref.store.tiers[-1], port.store.tiers[-1]
    ids = np.arange(N)
    np.testing.assert_array_equal(ja.placement.replicas_of(ids),
                                  tb.placement.replicas_of(ids))
    assert (tb.placement.replicas_of(ids)[:, 0]
            != tb.placement.replicas_of(ids)[:, 1]).all()
    for _ in range(8):
        a, b = ref.next_batch(), port.next_batch()
        assert a.prep_time_s == b.prep_time_s
