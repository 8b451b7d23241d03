"""The port's feedback controllers (repro_torch.core.feedback) against the
JAX package's on the CPU: the touch table, amortized cost, shard health
monitor, shard rebalancer and topology refresher, each decision and event
bit-identical; after a topology refresh the port's device page table and
hot pages hold the new assignment.  Then the migration twin: the
fig_adaptive rotation, where the reference commits 5 migrations, through
both packages, with the features of every batch equal across them."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.core import feedback as jfb  # noqa: E402
from repro.core import sharding as jsh  # noqa: E402
from repro.core import storage_sim as jsim  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core import feedback as tfb  # noqa: E402
from repro_torch.core import storage_sim as tsim  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402


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


def test_touch_table_matches_reference():
    rng = np.random.default_rng(0)
    a, b = jfb.TouchTable(500, alpha=0.3), tfb.TouchTable(500, alpha=0.3)
    for i in range(6):
        ids = rng.integers(0, 500, 300)
        counts = rng.integers(1, 5, 300) if i % 2 else None
        for t in (a, b):
            t.observe(ids, counts)
            t.observe(ids[:0])
            if i % 3 != 2:
                t.fold()
        assert same(a.state_dict(), b.state_dict())
    np.testing.assert_array_equal(a.scores(), b.scores())
    fresh = tfb.TouchTable(500)
    fresh.load_state_dict(a.state_dict())
    assert same(fresh.state_dict(), a.state_dict())
    for bad in (lambda: tfb.TouchTable(0), lambda: tfb.TouchTable(4, 0.0),
                lambda: tfb.TouchTable(4).load_state_dict(a.state_dict())):
        with pytest.raises(ValueError):
            bad()


def test_amortized_cost_matches_reference():
    a, b = jfb.AmortizedCost(5), tfb.AmortizedCost(5)
    charges = []
    for i in range(14):
        if i in (0, 3, 4):
            a.add(1e-4 * (i + 1))
            b.add(1e-4 * (i + 1))
        charges.append((a.charge(), b.charge()))
    assert all(x == y for x, y in charges) and charges[0][0] > 0
    assert a.outstanding_s == b.outstanding_s
    with pytest.raises(ValueError):
        tfb.AmortizedCost(0)
    with pytest.raises(ValueError):
        b.add(-1.0)


def test_shard_health_monitor_matches_reference():
    """Per-row EMAs, the degraded set, worst and healthiest over bursts
    in which shard 2 browns out 6x and then recovers."""
    specs = (jsim.INTEL_OPTANE,) * 4
    a, b = jfb.ShardHealthMonitor(4), tfb.ShardHealthMonitor(4)
    rng = np.random.default_rng(2)
    flagged = False
    for burst in range(16):
        rows = rng.integers(50, 400, 4)
        rows[3] = 0 if burst == 5 else rows[3]
        ja = jsim.price_sharded_burst(specs, rows, rows, 4096)
        slow = 6.0 if 3 <= burst < 11 else 1.0
        per = tuple(t * (slow if s == 2 else 1.0)
                    for s, t in enumerate(ja.per_shard_s))
        ja = dataclasses.replace(ja, per_shard_s=per)
        tb = tsim.ShardedBurstResult(**dataclasses.asdict(ja))
        a.observe(ja)
        b.observe(tb)
        np.testing.assert_array_equal(a.degraded(), b.degraded())
        assert a.worst() == b.worst()
        assert a.healthiest([0, 2, 3]) == b.healthiest([0, 2, 3])
        flagged |= b.worst() == 2
        assert same(a.state_dict(), b.state_dict())
    assert flagged and b.first_flag_burst == a.first_flag_burst > 0
    fresh = jfb.ShardHealthMonitor(4)
    fresh.load_state_dict(b.state_dict())
    assert same(fresh.state_dict(), b.state_dict())
    with pytest.raises(ValueError, match="burst spans"):
        b.observe(tsim.price_sharded_burst(specs[:2], (1, 1), (1, 1), 64))
    with pytest.raises(ValueError, match="checkpointed over"):
        tfb.ShardHealthMonitor(3).load_state_dict(b.state_dict())


N_ADAPT = 10_000


@pytest.fixture(scope="module")
def adaptive_graphs():
    feats = np.random.default_rng(0).standard_normal((N_ADAPT, 64)) \
        .astype(np.float32)
    return (jrmat(N_ADAPT, 12, 16, seed=1), rmat_graph(N_ADAPT, 12, 16,
                                                        seed=1), feats)


def _pair(graphs, **kw):
    jg, tg, feats = graphs
    ref = JLoader(jg, feats, JConfig(**kw))
    port = GIDSDataLoader(tg, feats, LoaderConfig(**kw), device="cpu")
    return ref, port


ROTATION = dict(batch_size=256, fanouts=(2,),
                data_plane="gids-merged-sharded", cache_lines=512,
                window_depth=4, n_shards=4, placement="adaptive", seed=7,
                rebalance_interval=4, migration_horizon=64)


def test_rebalancer_requires_adaptive_placement(adaptive_graphs):
    ref, port = _pair(adaptive_graphs, **{**ROTATION, "placement": "degree"})
    assert port.rebalancer is None and ref.rebalancer is None
    with pytest.raises(ValueError, match="adaptive"):
        tfb.ShardRebalancer(port.store.tiers[-1], port.timeline, 256)


def test_migration_twin_of_fig_adaptive_rotation(adaptive_graphs):
    """fig_adaptive.rotation's setup (each epoch trains exactly one shard
    of the static degree table) through both packages: the reference
    commits migrations, the port commits the same ones (events equal),
    and every batch's features, before and after each migration, are
    bit-identical across the packages and equal feats[all_nodes]."""
    jg, _, feats = adaptive_graphs
    ref, port = _pair(adaptive_graphs, **ROTATION)
    table = jsh.make_placement("degree", 4, degrees=np.diff(jg.indptr)).table
    hot = [np.nonzero(table == s)[0] for s in range(4)]
    seen = []
    for epoch in range(4):
        ref.train_ids = port.train_ids = hot[epoch]
        for _ in range(64):
            a, b = ref.next_batch(), port.next_batch()
            np.testing.assert_array_equal(a.blocks.all_nodes,
                                          b.blocks.all_nodes)
            np.testing.assert_array_equal(b.features.numpy(), a.features)
            np.testing.assert_array_equal(b.features.numpy(),
                                          feats[b.blocks.all_nodes])
            assert a.prep_time_s == b.prep_time_s
            seen.append(port.rebalancer.n_migrations)
    assert port.rebalancer.n_migrations >= 1
    assert [dataclasses.asdict(e) for e in ref.rebalancer.events] \
        == [dataclasses.asdict(e) for e in port.rebalancer.events]
    assert ref.rebalancer.total_migration_cost_s \
        == port.rebalancer.total_migration_cost_s
    # batches were delivered on both sides of every migration
    assert len(set(seen)) == port.rebalancer.n_migrations + 1
    np.testing.assert_array_equal(ref.store.tiers[-1].placement.table,
                                  port.store.tiers[-1].placement.table)
    assert same(ref.state_dict(), port.state_dict())


def test_drain_under_brownout_matches_reference(adaptive_graphs):
    """A browning-out shard is flagged by the health monitor and drained by
    the rebalancer (reason "drain") on both packages alike."""
    from repro.core import faults as jf
    from repro_torch.core import faults as tf

    def sched(m):
        return m.FaultSchedule(events=(m.BrownoutEvent(
            shard=1, start=2, end=60, multiplier=8.0),))
    jg, tg, feats = adaptive_graphs
    kw = dict(ROTATION, rebalance_interval=2, cache_lines=2048)
    ref = JLoader(jg, feats, JConfig(**kw, fault_schedule=sched(jf)))
    port = GIDSDataLoader(tg, feats, LoaderConfig(
        **kw, fault_schedule=sched(tf)), device="cpu")
    for _ in range(64):
        a, b = ref.next_batch(), port.next_batch()
        assert a.prep_time_s == b.prep_time_s
    events = [dataclasses.asdict(e) for e in port.rebalancer.events]
    assert events == [dataclasses.asdict(e) for e in ref.rebalancer.events]
    assert any(e["reason"] == "drain" for e in events)
    assert same(ref.health.state_dict(), port.health.state_dict())


TOPO = dict(batch_size=256, fanouts=(5, 3), data_plane="gids-topo",
            cache_lines=2048, topo_admission="adaptive",
            topo_gpu_fraction=0.05, topo_host_fraction=0.25, seed=7,
            rebalance_interval=4, migration_horizon=64)


def test_topology_refresher_matches_reference_and_moves_the_pages(
        adaptive_graphs):
    """Quarter rotation over the adaptive topology plane: the refresh
    events, assignments and priced sampling time equal the reference's;
    after every refresh the port's device page table is the new page
    slots and its hot pages hold the new HBM pages' words, and the sampled
    words still equal graph.indices."""
    jg, tg, _ = adaptive_graphs
    ref, port = _pair(adaptive_graphs, **TOPO)
    assert ref.topo_refresher is not None and port.topo_refresher is not None
    quarters = np.array_split(np.arange(N_ADAPT), 4)
    n_seen = 0
    for epoch in range(4):
        ref.train_ids = port.train_ids = quarters[epoch]
        for _ in range(12):
            a, b = ref.next_batch(), port.next_batch()
            np.testing.assert_array_equal(a.blocks.all_nodes,
                                          b.blocks.all_nodes)
            assert (a.prep_time_s, a.sample_time_s) \
                == (b.prep_time_s, b.sample_time_s)
            topo = port.topo
            if port.topo_refresher.n_refreshes != n_seen:
                n_seen = port.topo_refresher.n_refreshes
                np.testing.assert_array_equal(topo.assignment,
                                              ref.topo.assignment)
                np.testing.assert_array_equal(topo.page_table.numpy(),
                                              topo.page_slot)
                hbm = np.nonzero(topo.assignment == 0)[0]
                np.testing.assert_array_equal(
                    topo.page_slot[hbm], np.arange(len(hbm)))
                words = topo.hot_pages().numpy()
                idx = np.minimum(hbm[:, None] * topo.page_words
                                 + np.arange(topo.page_words),
                                 len(tg.indices) - 1)
                np.testing.assert_array_equal(words, tg.indices[idx])
                pos = np.random.default_rng(n_seen).integers(
                    0, len(tg.indices), 5000)
                np.testing.assert_array_equal(topo.frontier_gather(pos),
                                              tg.indices[pos])
    assert n_seen >= 1
    assert [dataclasses.asdict(e) for e in ref.topo_refresher.events] \
        == [dataclasses.asdict(e) for e in port.topo_refresher.events]
    np.testing.assert_array_equal(ref.topo.touches.scores(),
                                  port.topo.touches.scores())
    with pytest.raises(ValueError, match="adaptive"):
        tfb.TopologyRefresher(_pair(adaptive_graphs, **{
            **TOPO, "topo_admission": "degree"})[1].topo)
