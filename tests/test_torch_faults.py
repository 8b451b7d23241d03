"""The port's fault plane (repro_torch.core.faults) against the JAX
package's on the CPU: schedule validation, the injector's re-priced bursts
and counters, failover routing, the loader's data stream under a chaos
schedule, and the loader's `fault_state` (including the topology plane's
own injector) equal to the reference's and loaded across the packages.
Everything is bit-exact."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import feedback as jfb  # noqa: E402
from repro.core import sharding as jsh  # noqa: E402
from repro.core import storage_sim as jsim  # noqa: E402
from repro.core.dataplane import DataPlaneSpec as JSpec  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import feedback as tfb  # noqa: E402
from repro_torch.core import sharding as tsh  # noqa: E402
from repro_torch.core import storage_sim as tsim  # noqa: E402
from repro_torch.core.dataplane import DataPlaneSpec  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402

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


def chaos(m, seed=3):
    """The chaos schedule of benchmarks/fig_faults.py, in module `m`."""
    return m.FaultSchedule(
        events=(m.BrownoutEvent(shard=2, start=1, end=9, multiplier=10.0),
                m.OutageEvent(shard=0, start=4, end=7),
                m.FlakyReadsEvent(shard=1, start=2, end=12, fail_prob=0.2)),
        seed=seed)


@pytest.mark.parametrize("build,match", [
    (lambda m: m.BrownoutEvent(shard=0, start=0, end=1, multiplier=0.5),
     ">= 1"),
    (lambda m: m.BrownoutEvent(shard=-1, start=0, end=1, multiplier=2.0),
     "shard"),
    (lambda m: m.OutageEvent(shard=0, start=3, end=3), "empty"),
    (lambda m: m.FlakyReadsEvent(shard=0, start=0, end=2, fail_prob=1.0),
     "fail_prob"),
    (lambda m: m.RetryPolicy(max_retries=-1), "max_retries"),
    (lambda m: m.RetryPolicy(backoff_base_s=1e-3, backoff_cap_s=1e-4),
     "backoff"),
    (lambda m: m.HedgePolicy(quantile=1.5), "quantile"),
    (lambda m: m.HedgePolicy(factor=0.5), "factor"),
    (lambda m: m.FaultInjector(chaos(m), 2), "targets shard"),
    (lambda m: m.FaultInjector(m.FaultSchedule(), 2, replication=3),
     "exceeds"),
    (lambda m: m.FaultInjector(m.FaultSchedule(), 0), "n_shards"),
])
def test_schedule_validation_matches_reference(build, match):
    for m in (jf, tf):
        with pytest.raises(ValueError, match=match):
            build(m)
    for m in (jf, tf):
        with pytest.raises(TypeError, match="unknown fault event"):
            m.FaultSchedule(events=("not an event",))


def test_schedule_queries_match_reference():
    a, b = chaos(jf), chaos(tf)
    assert a.max_shard == b.max_shard == 2
    assert [a.any_active(i) for i in range(14)] \
        == [b.any_active(i) for i in range(14)]


def _burst_fields(burst):
    d = dataclasses.asdict(burst)
    d.update(elapsed_s=burst.elapsed_s, straggler=burst.straggler,
             imbalance=burst.imbalance)
    if hasattr(burst, "recovery_events"):
        d["recovery"] = burst.recovery_events()
    return d


@pytest.mark.parametrize("replication", [1, 2, 3])
@pytest.mark.parametrize("bpr", [512, 4096])
def test_injector_price_burst_and_counters_match_reference(bpr,
                                                           replication):
    """14 bursts through the chaos schedule (a quiet burst returns the
    clean object itself), then the counters and the state; the state
    loads across the packages."""
    rng = np.random.default_rng(bpr + replication)
    specs = (jsim.INTEL_OPTANE, jsim.SAMSUNG_980PRO) * 2
    ja = jf.FaultInjector(chaos(jf), 4, replication=replication)
    tb = tf.FaultInjector(chaos(tf), 4, replication=replication)
    for _ in range(14):
        rows = rng.integers(0, 800, 4)
        lines = -(-rows * bpr // 4096)
        ca = jsim.price_sharded_burst(specs, rows, lines, bpr)
        cb = tsim.price_sharded_burst(specs, rows, lines, bpr)
        a, b = ja.price_burst(specs, ca, bpr), tb.price_burst(specs, cb, bpr)
        assert (a is ca) == (b is cb)
        assert _burst_fields(a) == _burst_fields(b)
    assert ja.state_dict() == tb.state_dict()
    assert tb.n_faulted_bursts > 0
    fresh = tf.FaultInjector(chaos(tf), 4, replication=replication)
    fresh.load_state_dict(ja.state_dict())
    assert fresh.state_dict() == ja.state_dict() and fresh.burst == 14
    back = jf.FaultInjector(chaos(jf), 4, replication=replication)
    back.load_state_dict(tb.state_dict())
    assert back.state_dict() == tb.state_dict()
    with pytest.raises(ValueError, match="does not match"):
        tf.FaultInjector(chaos(tf, seed=4), 4,
                         replication=replication).load_state_dict(
            ja.state_dict())
    tb.reset()
    assert tb.burst == 0 and tb.n_faulted_bursts == 0


def test_failover_router_matches_reference():
    degrees = np.random.default_rng(0).integers(0, 40, N)
    pa = jsh.ReplicatedPlacement(jsh.make_placement("degree", 4,
                                                    degrees=degrees), 2)
    pb = tsh.ReplicatedPlacement(tsh.make_placement("degree", 4,
                                                    degrees=degrees), 2)
    ia, ib = jf.FaultInjector(chaos(jf), 4, 2), tf.FaultInjector(
        chaos(tf), 4, 2)
    ma, mb = jfb.ShardHealthMonitor(4), tfb.ShardHealthMonitor(4)
    ra = jf.FailoverRouter(pa, monitor=ma, injector=ia)
    rb = tf.FailoverRouter(pb, monitor=mb, injector=ib)
    ids = np.random.default_rng(1).permutation(N)[:1200]
    specs = (jsim.INTEL_OPTANE,) * 4
    for burst in range(10):
        prim = pb.shard_of(ids)
        out_a, out_b = ra.route(ids, prim), rb.route(ids, prim)
        np.testing.assert_array_equal(out_a, out_b)
        assert ra.bad_shards() == rb.bad_shards()
        rows = np.bincount(out_b, minlength=4)
        ma.observe(ia.price_burst(specs, jsim.price_sharded_burst(
            specs, rows, rows, 4096), 4096))
        mb.observe(ib.price_burst(specs, tsim.price_sharded_burst(
            specs, rows, rows, 4096), 4096))
    assert (ra.n_rerouted, ra.first_reroute_burst) \
        == (rb.n_rerouted, rb.first_reroute_burst)
    assert rb.n_rerouted > 0
    healthy = tf.FailoverRouter(pb)
    prim = pb.shard_of(ids)
    assert healthy.route(ids, prim) is prim
    with pytest.raises(ValueError, match="replicated placement"):
        tf.FailoverRouter(tsh.make_placement("hash", 4))


KW = dict(batch_size=96, fanouts=(4, 3), cache_lines=256, cache_ways=4,
          window_depth=4, n_shards=4, placement="degree", seed=5)


def _loaders(plane="gids-merged-sharded", topology=False, **kw):
    feats = np.random.default_rng(0).standard_normal((N, DIM)) \
        .astype(np.float32)
    sched = kw.pop("schedule", None)
    jkw = dict(kw, **({"fault_schedule": chaos(jf)} if sched else {}))
    tkw = dict(kw, **({"fault_schedule": chaos(tf)} if sched else {}))
    jplane = JSpec.preset(plane, topology=True) if topology else plane
    tplane = DataPlaneSpec.preset(plane, topology=True) if topology \
        else plane
    ref = JLoader(jrmat(N, 10, DIM, seed=4), feats,
                  JConfig(data_plane=jplane, **{**KW, **jkw}))
    port = GIDSDataLoader(rmat_graph(N, 10, DIM, seed=4), feats,
                          LoaderConfig(data_plane=tplane, **{**KW, **tkw}),
                          device="cpu")
    return feats, ref, port


@pytest.mark.parametrize("plane", ["gids-sharded", "gids-merged-sharded"])
def test_chaos_never_touches_data_and_never_prices_cheaper(plane):
    """Under the chaos schedule with 2-way replication the port's blocks
    and features equal its fault-free loader's, prep is never cheaper
    than clean and some batches are slower; every priced float equals the
    reference's faulted loader's."""
    _, _, clean = _loaders(plane)
    _, ref, port = _loaders(plane, schedule=True, replication_factor=2)
    slower = 0
    for _ in range(24):
        c, a, b = clean.next_batch(), ref.next_batch(), port.next_batch()
        np.testing.assert_array_equal(c.blocks.all_nodes, b.blocks.all_nodes)
        assert torch.equal(c.features, b.features)
        assert b.prep_time_s >= c.prep_time_s
        slower += b.prep_time_s > c.prep_time_s
        assert (a.prep_time_s, a.exposed_prep_s) \
            == (b.prep_time_s, b.exposed_prep_s)
        assert dataclasses.asdict(a.report) == dataclasses.asdict(b.report)
    assert slower > 0
    assert ref.fault_injector.state_dict() == port.fault_injector.state_dict()
    assert ref.store.tiers[-1].router.n_rerouted \
        == port.store.tiers[-1].router.n_rerouted


def test_empty_schedule_is_invisible():
    _, _, plain = _loaders()
    feats = np.random.default_rng(0).standard_normal((N, DIM)) \
        .astype(np.float32)
    empty = GIDSDataLoader(rmat_graph(N, 10, DIM, seed=4), feats,
                           LoaderConfig(data_plane="gids-merged-sharded",
                                        fault_schedule=tf.FaultSchedule(),
                                        **KW), device="cpu")
    for _ in range(8):
        a, b = plain.next_batch(), empty.next_batch()
        assert (a.prep_time_s, a.exposed_prep_s) \
            == (b.prep_time_s, b.exposed_prep_s)
        assert torch.equal(a.features, b.features)


@pytest.mark.parametrize("topology", [False, True])
@pytest.mark.parametrize("plane", ["gids-sharded", "gids-hosts-merged"])
def test_loader_fault_state_matches_reference_and_cross_loads(plane,
                                                              topology):
    """After 7 batches the `fault_state` (injector, monitor and, on a
    topology plane, the topology injector) equals the reference's; each
    package's state resumes the other's fresh loader, and the resumed
    loaders deliver the same blocks and priced prep."""
    extra = dict(n_hosts=4, placement="metis-lite") \
        if plane == "gids-hosts-merged" else {}
    _, ref, port = _loaders(plane, topology, schedule=True,
                            replication_factor=2, **extra)
    for _ in range(7):
        ref.next_batch(), port.next_batch()
    sa, sb = ref.state_dict(), port.state_dict()
    want = {"injector", "monitor"} | ({"topo_injector"} if topology
                                      else set())
    assert set(sb["fault_state"]) == want and "tier_state" in sb
    assert same(sa, sb)
    _, ref2, port2 = _loaders(plane, topology, schedule=True,
                              replication_factor=2, **extra)
    ref2.load_state_dict(sb)
    port2.load_state_dict(sa)
    assert same(ref2.state_dict(), port2.state_dict())
    assert port2.fault_injector.burst == port.fault_injector.burst
    for _ in range(6):
        a, b = ref2.next_batch(), port2.next_batch()
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert (a.prep_time_s, a.sample_time_s) \
            == (b.prep_time_s, b.sample_time_s)
    # a plane without the schedule refuses the faulted state
    _, _, plain = _loaders(plane, topology, replication_factor=2, **extra)
    with pytest.raises(ValueError, match="no fault_schedule"):
        plain.load_state_dict(sa)


@pytest.mark.parametrize("plane,extra", [
    ("gids-sharded", dict(placement="adaptive", n_shards=4,
                          rebalance_interval=2)),
    ("gids-hosts-merged", dict(n_hosts=4, placement="metis-lite"))])
def test_loader_state_resumes_through_the_checkpoint(tmp_path, plane, extra):
    """A state carrying `tier_state` and `fault_state` (numpy tables and
    EMAs) saved with `train.checkpoint` comes back equal to the one in
    memory, and a fresh loader restored from it delivers what a loader
    restored from the in-memory state does: blocks, features and priced
    prep.  The reference's `checkpoint.save` cannot write such a state
    (ROADMAP.md Queue 3 item 5)."""
    import jax.numpy as jnp

    from repro.train import checkpoint as jckpt
    from repro_torch.train import checkpoint as ckpt
    _, ref, port = _loaders(plane, schedule=True, replication_factor=2,
                            **extra)
    for _ in range(7):
        ref.next_batch(), port.next_batch()
    state = port.state_dict()
    assert {"tier_state", "fault_state"} <= set(state)
    assert same(ref.state_dict(), state)
    with pytest.raises(TypeError, match="not JSON serializable"):
        jckpt.save(tmp_path / "ref", 7, {"w": jnp.ones(2)},
                   {"loader": ref.state_dict()})
    ckpt.save(tmp_path, 7, {"w": torch.ones(2)}, {"loader": state})
    _, got = ckpt.restore(tmp_path, 7, {"w": torch.zeros(2)})
    assert same(got["loader"], state)
    loaders = [_loaders(plane, schedule=True, replication_factor=2,
                        **extra)[2] for _ in range(2)]
    loaders[0].load_state_dict(state)
    loaders[1].load_state_dict(got["loader"])
    for _ in range(6):
        a, b = (loader.next_batch() for loader in loaders)
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert torch.equal(a.features, b.features)
        assert (a.prep_time_s, a.sample_time_s, a.exposed_prep_s) \
            == (b.prep_time_s, b.sample_time_s, b.exposed_prep_s)
    assert same(loaders[0].state_dict(), loaders[1].state_dict())


def test_replication_needs_a_sharded_plane():
    feats = np.zeros((N, DIM), np.float32)
    with pytest.raises(ValueError, match="no replica queues"):
        GIDSDataLoader(rmat_graph(N, 10, DIM, seed=4), feats,
                       LoaderConfig(data_plane="gids-merged",
                                    replication_factor=2), device="cpu")
