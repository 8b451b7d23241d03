"""The port's sharded namespace (repro_torch.core.sharding, the sharded
parts of storage_sim, tiers and feature_store) against the JAX package's
on the CPU: every placement's table and shard ids, placement states equal
and loaded across the packages, the adaptive placement's drain, rebalance
and commit, replica maps and failure domains, per-shard coalescing and
burst, host-burst and migration pricing, and the sharded loaders'
reports, priced prep and states.  Everything is bit-exact."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.core import hosts as jhosts  # noqa: E402
from repro.core import sharding as jsh  # noqa: E402
from repro.core import storage_sim as jsim  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.graph.synthetic import clustered_graph as jclustered  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core import hosts as thosts  # noqa: E402
from repro_torch.core import sharding as tsh  # noqa: E402
from repro_torch.core import storage_sim as tsim  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.graph.synthetic import clustered_graph  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402

PLACEMENTS = ["hash", "range", "degree", "skewed", "adaptive", "metis-lite"]
SPECS = (jsim.INTEL_OPTANE, jsim.SAMSUNG_980PRO)


def same(a, b) -> bool:
    """Equal, recursing through dicts, sequences and numpy arrays (arrays
    by value and dtype)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.fixture(scope="module", params=["rmat", "clustered"])
def graphs(request):
    if request.param == "rmat":
        return jrmat(5000, 10, 8, seed=2), rmat_graph(5000, 10, 8, seed=2)
    return (jclustered(5000, 10, 8, communities=16, seed=2),
            clustered_graph(5000, 10, 8, communities=16, seed=2))


def _pair(name, n_shards, graphs):
    jg, tg = graphs
    kw = dict(num_nodes=jg.num_nodes, seed=3)
    return (jsh.make_placement(name, n_shards, degrees=jg.degrees(),
                               graph=jg, **kw),
            tsh.make_placement(name, n_shards, degrees=tg.degrees(),
                               graph=tg, **kw))


def test_registry_matches_reference():
    assert jsh.placement_names() == tsh.placement_names()
    with pytest.raises(KeyError, match="unknown placement"):
        tsh.make_placement("no-such-policy", 4)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 7])
@pytest.mark.parametrize("name", PLACEMENTS)
def test_placement_table_and_shard_of_match_reference(graphs, name,
                                                      n_shards):
    a, b = _pair(name, n_shards, graphs)
    ids = np.arange(graphs[0].num_nodes)
    sa, sb = a.shard_of(ids), b.shard_of(ids)
    assert sa.dtype == sb.dtype
    np.testing.assert_array_equal(sa, sb)
    if hasattr(a, "table"):
        np.testing.assert_array_equal(a.table, b.table)
    probe = np.random.default_rng(1).integers(0, len(ids), 777)
    np.testing.assert_array_equal(a.shard_of(probe), b.shard_of(probe))


@pytest.mark.parametrize("name", PLACEMENTS)
def test_placement_state_equal_and_cross_loads(graphs, name):
    a, b = _pair(name, 4, graphs)
    if name == "adaptive":
        ids = np.random.default_rng(5).integers(0, graphs[0].num_nodes, 900)
        for pol in (a, b):
            pol.touches.observe(ids)
            pol.touches.fold()
            pol.touches.observe(ids[:100])
    assert same(a.state_dict(), b.state_dict())
    a2, b2 = _pair(name, 4, graphs)
    a2.load_state_dict(b.state_dict())
    b2.load_state_dict(a.state_dict())
    assert same(a2.state_dict(), b2.state_dict())
    assert same(b2.state_dict(), a.state_dict())
    with pytest.raises(ValueError):
        _pair(name, 2, graphs)[1].load_state_dict(a.state_dict())


def _touched_adaptive(graphs):
    """The adaptive pair after measured touches on a hot set of one shard
    of the degree deal (with per-id counts), folded twice."""
    a, b = _pair("adaptive", 4, graphs)
    rng = np.random.default_rng(7)
    hot = np.nonzero(a.table == 1)[0][:600]
    for _ in range(2):
        ids, counts = rng.choice(hot, 400), rng.integers(1, 4, 400)
        for pol in (a, b):
            pol.touches.observe(ids, counts)
            pol.touches.fold()
    return a, b


def test_adaptive_plan_drain_rebalance_and_commit(graphs):
    a, b = _touched_adaptive(graphs)
    for plan in ("plan_rebalance", "plan_drain"):
        args = (1,) if plan == "plan_drain" else ()
        ta, ma = getattr(a, plan)(*args)
        tb, mb = getattr(b, plan)(*args)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ma, mb)
        assert len(mb) > 0
    new, moved = b.plan_rebalance()
    a.commit(new)
    b.commit(new)
    np.testing.assert_array_equal(a.table, b.table)
    assert same(a.state_dict(), b.state_dict())
    for bad in (new[:-1], np.full_like(new, 4)):
        with pytest.raises(ValueError):
            b.commit(bad)
    with pytest.raises(ValueError, match="cannot drain"):
        b.plan_drain(4)


@pytest.mark.parametrize("domains", [None, (0, 1, 0, 1, 2, 2)])
@pytest.mark.parametrize("k", [2, 3])
def test_replicated_placement_matches_reference(graphs, k, domains):
    a, b = _pair("degree", 6, graphs)
    ra = jsh.ReplicatedPlacement(a, k, failure_domains=domains)
    rb = tsh.ReplicatedPlacement(b, k, failure_domains=domains)
    assert ra.name == rb.name
    ids = np.arange(graphs[0].num_nodes)
    np.testing.assert_array_equal(ra.replicas_of(ids), rb.replicas_of(ids))
    np.testing.assert_array_equal(ra.shard_of(ids), rb.shard_of(ids))
    assert [ra.replica_shards(s) for s in range(6)] \
        == [rb.replica_shards(s) for s in range(6)]
    assert same(ra.state_dict(), rb.state_dict())
    rb.load_state_dict(ra.state_dict())
    ra.load_state_dict(rb.state_dict())
    if domains is not None:
        # no two copies of a row share a failure domain
        reps = rb.replicas_of(ids)
        dom = np.asarray(domains)[reps]
        assert all(len(set(row)) == k for row in dom[:200])
    adaptive = tsh.ReplicatedPlacement(_pair("adaptive", 6, graphs)[1], 2)
    assert hasattr(adaptive, "plan_rebalance")     # the seam falls through


def test_replicated_placement_validation(graphs):
    b = _pair("hash", 4, graphs)[1]
    for k, dom, match in ((1, None, ">= 2"), (5, None, "exceeds"),
                          (3, (0, 0, 1, 1), "failure domain")):
        with pytest.raises(ValueError, match=match):
            tsh.ReplicatedPlacement(b, k, failure_domains=dom)
    with pytest.raises(ValueError, match="n_shards >= 2"):
        tsh.ReplicatedPlacement(_pair("hash", 1, graphs)[1], 2)


# -- per-shard coalescing and pricing --------------------------------------------

@pytest.mark.parametrize("bpr", [64, 1000, 4096, 6000])
def test_coalesce_lines_by_shard_matches_reference(bpr):
    rng = np.random.default_rng(bpr)
    ids = np.unique(rng.integers(0, 50_000, 3000))
    shard = rng.integers(0, 5, len(ids)).astype(np.int16)
    a = jsim.coalesce_lines_by_shard(ids, shard, 5, bpr)
    b = tsim.coalesce_lines_by_shard(ids, shard, 5, bpr)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    assert jsim.coalesce_lines(ids, bpr, shard=shard) \
        == tsim.coalesce_lines(ids, bpr, shard=shard) == int(b.sum())
    np.testing.assert_array_equal(
        tsim.coalesce_lines_by_shard(ids[:0], shard[:0], 5, bpr),
        np.zeros(5, np.int64))


def _burst_dict(burst):
    d = dataclasses.asdict(burst)
    d.update(elapsed_s=burst.elapsed_s, straggler=burst.straggler,
             imbalance=burst.imbalance, straggler_spec=burst.straggler_spec)
    return d


@pytest.mark.parametrize("bpr", [256, 4096])
def test_price_sharded_burst_matches_reference(bpr):
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 900, 4)
    rows[1] = 0
    lines = -(-rows * bpr // 4096)
    specs = (SPECS[0], SPECS[1], SPECS[0], SPECS[1])
    for out in (None, rows * 3):
        a = jsim.price_sharded_burst(specs, rows, lines, bpr,
                                     shard_outstanding=out)
        b = tsim.price_sharded_burst(specs, rows, lines, bpr,
                                     shard_outstanding=out)
        assert _burst_dict(a) == _burst_dict(b)
    with pytest.raises(ValueError, match="arity"):
        tsim.price_sharded_burst(specs, rows[:3], lines, bpr)


def _timelines(n, hosts=False, injector=None):
    out = []
    for sim, hmod in ((jsim, jhosts), (tsim, thosts)):
        tl = sim.StorageTimeline(sim.INTEL_OPTANE,
                                 shard_specs=(sim.INTEL_OPTANE,) * n)
        if hosts:
            tl.host_specs = tuple(h.with_ssd(sim.INTEL_OPTANE)
                                  for h in hmod.default_hosts(n))
        out.append(tl)
    return out


def test_price_host_burst_matches_reference():
    ja, tb = _timelines(4, hosts=True)
    rows, lines = (300, 0, 120, 77), (80, 0, 40, 20)
    for remote in (None, (0, 0, 0, 0), (10, 0, 3, 20)):
        a = ja.price_host_burst(rows, lines, 1024, remote_lines=remote)
        b = tb.price_host_burst(rows, lines, 1024, remote_lines=remote)
        da, db = _burst_dict(a), _burst_dict(b)
        da.pop("local_burst"), db.pop("local_burst")
        assert da == db and a.remote_fraction == b.remote_fraction
    with pytest.raises(ValueError, match="host_specs"):
        _timelines(4)[1].price_host_burst(rows, lines, 1024)


@pytest.mark.parametrize("hosts", [False, True])
@pytest.mark.parametrize("bpr", [64, 4096, 9000])
def test_price_migration_matches_reference(bpr, hosts):
    ja, tb = _timelines(4, hosts=hosts)
    rng = np.random.default_rng(bpr)
    src = rng.integers(0, 4, 2000)
    dst = np.where(rng.random(2000) < 0.3, rng.integers(0, 4, 2000), src)
    assert ja.price_migration(src, dst, bpr) \
        == tb.price_migration(src, dst, bpr) > 0
    assert tb.price_migration(src, src, bpr) == 0.0
    with pytest.raises(ValueError, match="arity"):
        tb.price_migration(src, dst[:-1], bpr)


def test_sharded_batch_and_merged_pricing_match_reference():
    from repro.core.feature_store import CoalescedReport as JRep
    from repro_torch.core.feature_store import CoalescedReport as TRep
    kw = dict(n_requests=900, bytes_per_row=512,
              tier_names=("hbm", "host", "storage"),
              tier_classes=("hbm", "host", "storage"),
              tier_counts=(300, 100, 500), n_shards=4,
              shard_rows=(200, 50, 150, 100), n_storage_unique=500,
              n_storage_lines=140, shard_lines=(60, 20, 35, 25))
    for hosts in (False, True):
        ja, tb = _timelines(4, hosts=hosts)
        extra = dict(remote_rows=(20, 0, 5, 0), remote_lines=(9, 0, 2, 0)) \
            if hosts else {}
        assert ja.price_merged_burst(JRep(**kw, **extra)) \
            == tb.price_merged_burst(TRep(**kw, **extra))
        da, db = _burst_dict(ja.shard_burst), _burst_dict(tb.shard_burst)
        da.pop("local_burst", None), db.pop("local_burst", None)
        assert da == db
        assert ja.gids_batch_time_sharded(kw["shard_rows"], 100, 300, 512,
                                          4000, (20, 0, 5, 0)) \
            == tb.gids_batch_time_sharded(kw["shard_rows"], 100, 300, 512,
                                          4000, (20, 0, 5, 0))
        tb.reset_telemetry()
        assert tb.shard_burst is None and tb.host_burst is None


# -- tiers and loaders -----------------------------------------------------------

def test_build_plan_carries_shard_ids(graphs):
    jg, tg = graphs
    feats = np.zeros((jg.num_nodes, 4), np.float32)
    a, b = _pair("degree", 3, graphs)
    ja = jtiers.ShardedStorageTier(feats, a)
    tb = ttiers.ShardedStorageTier(feats, b)
    ids = np.random.default_rng(2).permutation(jg.num_nodes)[:500]
    pa = jtiers.build_plan([ja], ids)
    pb = ttiers.build_plan([tb], ids)
    np.testing.assert_array_equal(pa.shard, pb.shard)
    np.testing.assert_array_equal(pa.shard_counts(), pb.shard_counts())
    assert pb.n_shards == 3 and pb.shard_consistent() and pb.remote is None
    np.testing.assert_array_equal(pb.remote_counts(), np.zeros(3, np.int64))
    assert same(ja.state_dict(), tb.state_dict())
    assert tb.resolve_shard_specs(SPECS[0]) == (SPECS[0],) * 3
    plain = ttiers.build_plan([ttiers.StorageTier(feats)], ids)
    assert plain.n_shards == 1 and (plain.shard == 0).all()


@pytest.mark.parametrize("specs", ["one", "per-shard"])
def test_sharded_tier_specs_match_reference(specs):
    """A tier built with its own device specs (one for every shard, or one
    per shard: a heterogeneous array) resolves them as the reference does,
    whatever the loader's default; a wrong count raises in both."""
    feats = np.zeros((100, 4), np.float32)

    def pick(m):
        if specs == "one":
            return m.SAMSUNG_980PRO
        return (m.INTEL_OPTANE, m.SAMSUNG_980PRO, m.SAMSUNG_980PRO)
    ja = jtiers.ShardedStorageTier(feats, jsh.make_placement("hash", 3),
                                   specs=pick(jsim))
    tb = ttiers.ShardedStorageTier(feats, tsh.make_placement("hash", 3),
                                   specs=pick(tsim))
    want = [dataclasses.asdict(s)
            for s in ja.resolve_shard_specs(jsim.INTEL_OPTANE)]
    got = [dataclasses.asdict(s)
           for s in tb.resolve_shard_specs(tsim.INTEL_OPTANE)]
    assert got == want and len(got) == 3
    assert got[1]["name"] == tsim.SAMSUNG_980PRO.name
    for sim, tiers, sh in ((jsim, jtiers, jsh), (tsim, ttiers, tsh)):
        with pytest.raises(ValueError, match="2 shard specs for 3"):
            tiers.ShardedStorageTier(feats, sh.make_placement("hash", 3),
                                     specs=(sim.INTEL_OPTANE,) * 2)


N, DIM = 4000, 16
KW = dict(batch_size=96, fanouts=(4, 3), cache_lines=256, cache_ways=4,
          window_depth=4, seed=5)


def _loaders(plane, **kw):
    feats = np.random.default_rng(0).standard_normal((N, DIM)) \
        .astype(np.float32)
    ref = JLoader(jrmat(N, 10, DIM, seed=4), feats,
                  JConfig(data_plane=plane, **KW, **kw))
    port = GIDSDataLoader(rmat_graph(N, 10, DIM, seed=4), feats,
                          LoaderConfig(data_plane=plane, **KW, **kw),
                          device="cpu")
    return feats, ref, port


@pytest.mark.parametrize("placement", ["hash", "degree", "skewed", "range"])
@pytest.mark.parametrize("plane", ["gids-sharded", "gids-merged-sharded"])
def test_sharded_loader_matches_reference(plane, placement):
    """Blocks, reports (shard rows and lines), priced prep and the last
    burst's telemetry bit-identical for 12 batches; features are
    feats[all_nodes]; the loader states are equal and cross-load."""
    feats, ref, port = _loaders(plane, n_shards=4, placement=placement)
    for _ in range(12):
        a, b = ref.next_batch(), port.next_batch()
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert dataclasses.asdict(a.report) == dataclasses.asdict(b.report)
        assert (a.prep_time_s, a.exposed_prep_s) \
            == (b.prep_time_s, b.exposed_prep_s)
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
        assert _burst_dict(ref.timeline.shard_burst) \
            == _burst_dict(port.timeline.shard_burst)
        np.testing.assert_array_equal(ref.store.last_plan.shard,
                                      port.store.last_plan.shard)
    sa, sb = ref.state_dict(), port.state_dict()
    assert "tier_state" in sb and same(sa, sb)
    _, ref2, port2 = _loaders(plane, n_shards=4, placement=placement)
    ref2.load_state_dict(sb)
    port2.load_state_dict(sa)
    for _ in range(4):
        a, b = ref2.next_batch(), port2.next_batch()
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert a.prep_time_s == b.prep_time_s


def test_sharded_plane_rejects_legacy_n_ssd():
    with pytest.raises(ValueError, match="n_ssd"):
        _loaders("gids-sharded", n_shards=4, n_ssd=2)
