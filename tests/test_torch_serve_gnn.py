"""The port's online GNN serving (repro_torch.serve and its data plane)
against the JAX package's on the CPU: twins of tests/test_serve_gnn.py,
each holding the port's streams, batcher decisions, records, priced floats,
tenant hit ratios and quota traces to the reference's on the same numpy
inputs, plus the logits of the real forward within 1e-5 and the tenant
tier's row store, which holds every resident line's row across a
repartition."""
import pytest

torch = pytest.importorskip("torch")

from collections import deque  # noqa: E402

import numpy as np  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import DeadlineWindowConfig as JWinConfig  # noqa: E402
from repro.core import DeadlineWindowPolicy as JPolicy  # noqa: E402
from repro.core import TenantCacheTier as JTenantTier  # noqa: E402
from repro.core.faults import BrownoutEvent as JBrownout  # noqa: E402
from repro.core.faults import FaultSchedule as JSchedule  # noqa: E402
from repro.graph.csr import disjoint_union as jdisjoint  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro.graph.synthetic import uniform_graph as juniform  # noqa: E402
from repro_torch.core import (BrownoutEvent, DataPlaneSpec,  # noqa: E402
                              DeadlineWindowConfig, DeadlineWindowPolicy,
                              FaultSchedule, TenantCacheTier)
from repro_torch.graph.csr import disjoint_union  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph, uniform_graph  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.serve import (GNNServeConfig, GNNServeEngine,  # noqa: E402
                               SLOBatcher, ServeRequest, TenantSpec,
                               generate_stream, mmpp_arrivals,
                               poisson_arrivals)


@pytest.fixture(scope="module")
def graphs():
    return jrmat(2_000, 8, 16, seed=5), rmat_graph(2_000, 8, 16, seed=5)


@pytest.fixture(scope="module")
def small_feats(graphs):
    return np.random.default_rng(1).standard_normal(
        (graphs[0].num_nodes, 16)).astype(np.float32)


def _replay(requests, cls=ServeRequest):
    return [cls(r.rid, r.tenant, r.arrival_s, r.seeds.copy(), r.deadline_s)
            for r in requests]


def _specs(mod, tenants=2, deadline=20e-3):
    return tuple(
        mod.TenantSpec(f"t{i}", hot_fraction=0.05, hot_prob=0.8,
                       mean_seeds=3, deadline_s=deadline,
                       arrival="mmpp" if i % 2 else "poisson")
        for i in range(tenants))


def _streams(graph, n=60, qps=2000, deadline=20e-3, tenants=2, seed=4):
    """The same stream from both packages, held equal on the way."""
    j = jserve.generate_stream(graph.num_nodes, _specs(jserve, tenants,
                                                       deadline),
                               qps, n, seed=seed)
    t = generate_stream(graph.num_nodes, _specs(tserve, tenants, deadline),
                        qps, n, seed=seed)
    _assert_same_stream(j, t)
    return j, t


def _assert_same_stream(j, t):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert (a.rid, a.tenant, a.arrival_s, a.deadline_s) \
            == (b.rid, b.tenant, b.arrival_s, b.deadline_s)
        assert a.seeds.dtype == b.seeds.dtype
        np.testing.assert_array_equal(a.seeds, b.seeds)


RECORD_FIELDS = ("rid", "tenant", "arrival_s", "deadline_s", "rejected",
                 "shed_reason", "start_s", "completion_s", "queue_wait_s",
                 "sample_s", "gather_s", "forward_s", "window_size",
                 "n_rows", "degraded_level", "stale", "staleness_s")


def _assert_same_result(jres, tres, feats=None):
    """Record for record, field for field, and the result's rollups."""
    assert len(jres.records) == len(tres.records)
    for a, b in zip(jres.records, tres.records):
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
        if a.all_nodes is not None:
            np.testing.assert_array_equal(a.all_nodes, b.all_nodes)
        if a.features is not None:
            assert torch.equal(b.features,
                               torch.from_numpy(np.asarray(a.features)))
            if feats is not None:
                np.testing.assert_array_equal(b.features.numpy(),
                                              feats[b.all_nodes])
    assert [vars(w) for w in jres.windows] == [vars(w) for w in tres.windows]
    assert jres.tenant_hit_ratios == tres.tenant_hit_ratios
    assert jres.quota_trace == tres.quota_trace
    for fn in ("p50_s", "p99_s", "goodput_qps", "attainment"):
        a, b = getattr(jres, fn)(), getattr(tres, fn)()
        assert a == b or (np.isnan(a) and np.isnan(b)), fn
    assert jres.mean_breakdown_s() == tres.mean_breakdown_s()
    assert (jres.n_shed_expired, jres.n_shed_brownout, jres.n_degraded,
            jres.n_stale_served, jres.n_deadline_missed) == \
        (tres.n_shed_expired, tres.n_shed_brownout, tres.n_degraded,
         tres.n_stale_served, tres.n_deadline_missed)


def _both(graphs, feats, jstream, tstream, **cfg):
    jres = jserve.GNNServeEngine(graphs[0], feats,
                                 jserve.GNNServeConfig(**cfg)).run(
        _replay(jstream, jserve.ServeRequest))
    tengine = GNNServeEngine(graphs[1], feats, GNNServeConfig(**cfg),
                             device="cpu")
    return jres, tengine.run(_replay(tstream)), tengine


# -- workload ------------------------------------------------------------------

def test_stream_deterministic_and_arrival_ordered():
    specs = (TenantSpec("a"), TenantSpec("b", arrival="mmpp"))
    s1 = generate_stream(1000, specs, 5000, 60, seed=9)
    s2 = generate_stream(1000, specs, 5000, 60, seed=9)
    _assert_same_stream(s1, s2)
    assert [r.arrival_s for r in s1] == sorted(r.arrival_s for r in s1)
    assert [r.rid for r in s1] == list(range(60))
    s3 = generate_stream(1000, specs, 5000, 60, seed=10)
    assert any(not np.array_equal(a.seeds, b.seeds) for a, b in zip(s1, s3))
    ref = jserve.generate_stream(
        1000, (jserve.TenantSpec("a"), jserve.TenantSpec("b",
                                                         arrival="mmpp")),
        5000, 60, seed=9)
    _assert_same_stream(ref, s1)


def test_mmpp_burstier_than_poisson():
    po = poisson_arrivals(1000, 4000, np.random.default_rng(0))
    mm = mmpp_arrivals(1000, 4000, np.random.default_rng(0),
                       burst_factor=8.0, burst_fraction=0.1, cycle_s=0.02)

    def cv2(arr):
        gaps = np.diff(arr)
        return gaps.var() / gaps.mean() ** 2
    assert cv2(mm) > 1.5 * cv2(po)
    assert mm[-1] == pytest.approx(po[-1], rel=0.15)
    np.testing.assert_array_equal(
        po, jserve.poisson_arrivals(1000, 4000, np.random.default_rng(0)))
    np.testing.assert_array_equal(mm, jserve.mmpp_arrivals(
        1000, 4000, np.random.default_rng(0), burst_factor=8.0,
        burst_fraction=0.1, cycle_s=0.02))


def test_node_range_confines_tenant_traffic():
    specs = (TenantSpec("lo", node_range=(0, 500)),
             TenantSpec("hi", node_range=(500, 2000), hot_prob=0.0))
    stream = generate_stream(2000, specs, 3000, 80, seed=2)
    for r in stream:
        lo, hi = (0, 500) if r.tenant == 0 else (500, 2000)
        assert (r.seeds >= lo).all() and (r.seeds < hi).all()
    with pytest.raises(ValueError):
        TenantSpec("bad", node_range=(100, 50)).resolve_range(2000)
    ref = jserve.generate_stream(
        2000, (jserve.TenantSpec("lo", node_range=(0, 500)),
               jserve.TenantSpec("hi", node_range=(500, 2000),
                                 hot_prob=0.0)), 3000, 80, seed=2)
    _assert_same_stream(ref, stream)


def test_disjoint_union_offsets_components():
    a = rmat_graph(300, 6, 8, seed=1)
    b = uniform_graph(200, 4, 8, seed=2)
    u = disjoint_union([a, b])
    assert u.num_nodes == 500
    assert u.num_edges == a.num_edges + b.num_edges
    for v in (0, 7, 299):
        assert np.array_equal(u.neighbors(v), a.neighbors(v))
    for v in (0, 3, 199):
        assert np.array_equal(u.neighbors(300 + v), b.neighbors(v) + 300)
    assert (u.indices[:a.num_edges] < 300).all()
    assert (u.indices[a.num_edges:] >= 300).all()
    ref = jdisjoint([jrmat(300, 6, 8, seed=1), juniform(200, 4, 8, seed=2)])
    for f in ("indptr", "indices"):
        x, y = getattr(ref, f), getattr(u, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (ref.num_nodes, ref.feature_dim, ref.name) \
        == (u.num_nodes, u.feature_dim, u.name)


# -- deadline windows ----------------------------------------------------------

def _mk(rid, arrival, deadline=10e-3, seeds=(1,), cls=ServeRequest):
    return cls(rid=rid, tenant=0, arrival_s=arrival,
               seeds=np.asarray(seeds, np.int64), deadline_s=deadline)


def test_deadline_policy_close_by_and_ema():
    kw = dict(max_window=4, ema=0.5, init_request_s=1e-4, safety=2.0)
    pol, ref = (DeadlineWindowPolicy(DeadlineWindowConfig(**kw)),
                JPolicy(JWinConfig(**kw)))
    assert pol.close_by(1.0, 10e-3, 2) == pytest.approx(1.0 + 10e-3 - 4e-4)
    assert pol.close_by(1.0, 1e-4, 4) == 1.0
    assert pol.full(4) and not pol.full(3)
    for service, n in ((8e-4, 4), (3e-4, 1), (5e-3, 7), (-1.0, 2), (1.0, 0)):
        pol.observe(service, n)
        ref.observe(service, n)
        assert pol.est_request_s == ref.est_request_s
        for args in ((1.0, 10e-3, 2), (0.5, 3e-3, 9)):
            assert pol.close_by(*args) == ref.close_by(*args)
    pol.reset()
    assert pol.est_request_s == 1e-4


def _decisions(policy_kw, pending, busy, shed_expired=True, rounds=1):
    """The same window formation through both packages' batchers."""
    out = []
    for mod_policy, mod_cfg, batcher, cls in (
            (JPolicy, JWinConfig, jserve.SLOBatcher, jserve.ServeRequest),
            (DeadlineWindowPolicy, DeadlineWindowConfig, SLOBatcher,
             ServeRequest)):
        b = batcher(mod_policy(mod_cfg(**policy_kw)),
                    shed_expired=shed_expired)
        q = deque(_replay(pending, cls))
        got = []
        for _ in range(rounds):
            d = b.next_window(q, busy)
            got.append(None if d is None else (
                [r.rid for r in d.staged], [r.rid for r in d.shed],
                d.start_s, d.hit_cap))
        out.append((got, [r.rid for r in q]))
    assert out[0] == out[1]
    return out[1]


def test_batcher_batches_within_slack():
    pol = DeadlineWindowPolicy(DeadlineWindowConfig(
        max_window=4, init_request_s=1e-4, safety=1.0))
    batcher = SLOBatcher(pol)
    pending = deque([_mk(0, 0.0), _mk(1, 1e-4), _mk(2, 2e-4)])
    d = batcher.next_window(pending, busy_until_s=0.0)
    assert [r.rid for r in d.staged] == [0, 1, 2] and not d.shed
    assert not d.hit_cap
    assert d.start_s == pytest.approx(pol.close_by(0.0, 10e-3, 3))
    assert not pending
    _decisions(dict(max_window=4, init_request_s=1e-4, safety=1.0),
               [_mk(0, 0.0), _mk(1, 1e-4), _mk(2, 2e-4)], 0.0)


def test_batcher_closes_at_depth_cap():
    (got, left) = _decisions(dict(max_window=2, init_request_s=1e-4,
                                  safety=1.0),
                             [_mk(i, i * 1e-5) for i in range(5)], 0.0,
                             rounds=2)
    assert got[0][0] == [0, 1] and got[0][3]
    assert got[0][2] == pytest.approx(1e-5)
    assert left == [4]


def test_batcher_far_future_arrival_yields_singleton():
    (got, left) = _decisions(dict(max_window=8),
                             [_mk(0, 0.0), _mk(1, 5.0)], 0.0)
    assert got[0][0] == [0] and left == [1]


def test_batcher_sheds_expired_requests():
    (got, _) = _decisions(dict(max_window=4),
                          [_mk(0, 0.0, deadline=1e-3),
                           _mk(1, 0.0, deadline=9.0)], 5.0)
    assert got[0][1] == [0] and got[0][0] == [1]
    (got, _) = _decisions(dict(max_window=4), [_mk(0, 0.0, deadline=1e-3)],
                          5.0, shed_expired=False)
    assert got[0][0] == [0] and not got[0][1]
    (got, _) = _decisions(dict(max_window=4), [], 0.0)
    assert got == [None]


# -- engine --------------------------------------------------------------------

def test_merged_and_per_request_bit_identical(graphs, small_feats):
    """Merging changes latency, never results; both modes equal the
    reference engine's, record for record."""
    jstream, tstream = _streams(graphs[1])
    results = {}
    for merged in (True, False):
        jres, tres, _ = _both(graphs, small_feats, jstream, tstream,
                              merged=merged, tenants=2, cache_lines=512,
                              keep_features=True, seed=7)
        _assert_same_result(jres, tres, small_feats)
        results[merged] = tres
    recs_m = {r.rid: r for r in results[True].records}
    recs_p = {r.rid: r for r in results[False].records}
    assert set(recs_m) == set(recs_p) == {r.rid for r in tstream}
    served_both = 0
    for rid, a in recs_m.items():
        b = recs_p[rid]
        if a.rejected or b.rejected:
            continue
        served_both += 1
        assert np.array_equal(a.all_nodes, b.all_nodes)
        assert torch.equal(a.features, b.features)
    assert served_both >= 50


def test_every_request_retires_exactly_once(graphs, small_feats):
    jstream, tstream = _streams(graphs[1], n=80, qps=30_000, deadline=2e-3)
    jres, res, _ = _both(graphs, small_feats, jstream, tstream, tenants=2,
                         cache_lines=512, seed=7)
    _assert_same_result(jres, res)
    assert sorted(r.rid for r in res.records) == [r.rid for r in tstream]
    for r in res.served:
        assert r.completion_s >= r.start_s >= r.arrival_s
        assert r.window_size >= 1
        assert r.latency_s >= r.gather_s + r.forward_s - 1e-12


def test_overload_sheds_and_counts_against_goodput(graphs, small_feats):
    jstream, tstream = _streams(graphs[1], n=120, qps=2_000_000,
                                deadline=5e-4)
    jres, res, _ = _both(graphs, small_feats, jstream, tstream, tenants=2,
                         cache_lines=512, seed=7)
    _assert_same_result(jres, res)
    assert len(res.records) == 120 and res.n_rejected > 0
    for r in res.records:
        if r.rejected:
            assert r.completion_s == 0.0 and not r.deadline_met
    assert sum(r.deadline_met for r in res.records) < 120


def test_windows_form_under_load(graphs, small_feats):
    jstream, tstream = _streams(graphs[1], n=80, qps=20_000)
    jres, res, _ = _both(graphs, small_feats, jstream, tstream, tenants=2,
                         cache_lines=512, seed=7)
    _assert_same_result(jres, res)
    assert res.mean_window > 1.5
    assert any(w.dedup_factor > 1.0 for w in res.windows)
    by_window = {}
    for r in res.served:
        by_window.setdefault((r.start_s, r.completion_s), set()).add(r.tenant)
    assert all(len(t) == 1 for t in by_window.values())


def test_engine_reset_replays_bit_identically(graphs, small_feats):
    _, tstream = _streams(graphs[1], n=40)
    engine = GNNServeEngine(graphs[1], small_feats, GNNServeConfig(
        tenants=2, cache_lines=512, seed=7, keep_features=True),
        device="cpu")
    r1 = engine.run(_replay(tstream))
    engine.reset()
    assert not engine._tenant_tier.rows.any()
    r2 = engine.run(_replay(tstream))
    _assert_same_result(r1, r2)


# -- tenant cache isolation ----------------------------------------------------

def _tier_pair(feats, **kw):
    return (JTenantTier(**kw),
            TenantCacheTier(**kw, features=feats, device="cpu"))


def _probe_both(pair, ids, tenant):
    outs = []
    for tier in pair:
        tier.stage_tenants(np.full(len(ids), tenant, np.int64))
        outs.append(tier.probe(ids))
    np.testing.assert_array_equal(outs[0], outs[1])
    return outs[1]


def _assert_store_coherent(tier, feats):
    """Every resident line of the row store holds its tag's row."""
    tags = tier._flat_tags()
    assert tier.rows.shape[0] == len(tags) == tier.total_lines
    resident = torch.from_numpy(tags >= 0)
    assert torch.equal(tier.rows[resident],
                       torch.from_numpy(feats)[torch.from_numpy(
                           tags[tags >= 0])])


def test_tenant_cache_partitions_are_isolated():
    feats = np.random.default_rng(0).standard_normal(
        (1500, 8)).astype(np.float32)
    pair = _tier_pair(feats, num_lines=64, ways=8, tenants=2, seed=0)
    victim = np.arange(0, 24)
    noisy = np.arange(1000, 1480)
    _probe_both(pair, victim, 0)
    assert _probe_both(pair, victim, 0).all()
    for chunk in np.split(noisy, 8):
        _probe_both(pair, chunk, 1)
        _assert_store_coherent(pair[1], feats)
        np.testing.assert_array_equal(pair[1].last_rows.numpy(),
                                      feats[chunk])
    assert _probe_both(pair, victim, 0).all()
    tier = pair[1]
    assert tier.hit_ratio(0) > tier.hit_ratio(1)
    assert pair[0].hit_ratios() == tier.hit_ratios()
    np.testing.assert_array_equal(pair[0].lookup_slots(np.arange(1500)),
                                  tier.lookup_slots(np.arange(1500)))


def test_tenant_cache_quota_sizing_and_staging_contract():
    feats = np.zeros((10, 4), np.float32)
    pair = _tier_pair(feats, num_lines=96, ways=8, tenants=3,
                      quotas=(2.0, 1.0, 1.0), seed=0)
    tier = pair[1]
    lines = [tier.partition_lines(t) for t in range(3)]
    assert lines == [pair[0].partition_lines(t) for t in range(3)]
    assert all(n % 8 == 0 and n >= 8 for n in lines)
    assert lines[0] >= lines[1] == lines[2]
    assert tier.capacity_bytes == pair[0].capacity_bytes
    assert tier.rows.shape == (sum(lines), 4)
    with pytest.raises(ValueError):
        tier.stage_tenants(np.array([3]))
    tier.stage_tenants(np.array([0, 1]))
    with pytest.raises(ValueError):
        tier.probe(np.array([1, 2, 3]))
    with pytest.raises(ValueError):
        TenantCacheTier(num_lines=64, ways=8, tenants=2, quotas=(1.0,),
                        features=feats, device="cpu")


def test_serve_gnn_presets(graphs, small_feats):
    kw = dict(cache_lines=256, tenants=2, tenant_quotas=(3.0, 1.0), seed=0)
    plane = DataPlaneSpec.preset("serve-gnn").build(
        graphs[1], small_feats, device="cpu", **kw)
    first = plane.store.tiers[0]
    assert isinstance(first, TenantCacheTier)
    assert first.tenants == 2
    assert first.partition_lines(0) > first.partition_lines(1)
    from repro.core import DataPlaneSpec as JSpec
    ref = JSpec.preset("serve-gnn").build(graphs[0], small_feats, **kw)
    assert [t.name for t in ref.store.tiers] \
        == [t.name for t in plane.store.tiers]
    assert [first.partition_lines(t) for t in range(2)] \
        == [ref.store.tiers[0].partition_lines(t) for t in range(2)]
    shared = DataPlaneSpec.preset("serve-gnn-shared").build(
        graphs[1], small_feats, cache_lines=256, seed=0, device="cpu")
    assert not any(isinstance(t, TenantCacheTier)
                   for t in shared.store.tiers)
    assert shared.store.tiers[0].window_depth == 0


def test_partitioned_victim_hit_ratio_beats_shared(graphs, small_feats):
    def specs(mod):
        return (mod.TenantSpec("victim", hot_fraction=0.01, hot_prob=0.95,
                               mean_seeds=3, deadline_s=50e-3,
                               node_range=(0, 1000)),
                mod.TenantSpec("noisy", hot_fraction=0.9, hot_prob=0.0,
                               mean_seeds=6, deadline_s=50e-3,
                               node_range=(1000, 2000)))
    j = jserve.generate_stream(2000, specs(jserve), 4000, 120, seed=3)
    t = generate_stream(2000, specs(tserve), 4000, 120, seed=3)
    jres, tres, engine = _both(graphs, small_feats, j, t, tenants=2,
                               cache_lines=512, tenant_quotas=(1.0, 1.0),
                               seed=7)
    _assert_same_result(jres, tres)
    tier = engine._tenant_tier
    assert tier.hit_ratio(0) > tier.hit_ratio(1)


# -- gather correctness property -----------------------------------------------

def _assert_serve_rows_exact(graphs, feats, jstream, tstream):
    tenants = max(r.tenant for r in tstream) + 1
    jres, res, engine = _both(graphs, feats, jstream, tstream,
                              tenants=tenants, cache_lines=512,
                              keep_features=True, seed=7)
    _assert_same_result(jres, res, feats)
    assert sorted(r.rid for r in res.records) == [r.rid for r in tstream]
    assert res.served
    for rec in res.served:
        np.testing.assert_array_equal(rec.features.numpy(),
                                      feats[rec.all_nodes])
    _assert_store_coherent(engine._tenant_tier, feats)


def test_serve_rows_match_direct_gather(graphs, small_feats):
    jstream, tstream = _streams(graphs[1], n=50, qps=8000)
    _assert_serve_rows_exact(graphs, small_feats, jstream, tstream)


@pytest.mark.parametrize("seed,qps,n_tenants,deadline_ms,bursty", [
    (0, 500, 1, 1.0, False), (17, 5_000, 2, 5.0, True),
    (301, 50_000, 3, 50.0, True), (4242, 50_000, 2, 1.0, False),
    (9999, 5_000, 3, 5.0, False)])
def test_serve_rows_property(graphs, small_feats, seed, qps, n_tenants,
                             deadline_ms, bursty):
    """Under any arrival pattern and tenant mix, each request's rows are
    `features[all_nodes]` bit for bit and equal the reference engine's."""

    def specs(mod):
        return tuple(
            mod.TenantSpec(f"t{i}", hot_fraction=0.02 + 0.03 * i,
                           hot_prob=0.5 + 0.15 * i, mean_seeds=2 + i,
                           deadline_s=deadline_ms * 1e-3,
                           arrival="mmpp" if bursty and i % 2 else "poisson")
            for i in range(n_tenants))
    j = jserve.generate_stream(2000, specs(jserve), qps, 30, seed=seed)
    t = generate_stream(2000, specs(tserve), qps, 30, seed=seed)
    _assert_same_stream(j, t)
    _assert_serve_rows_exact(graphs, small_feats, j, t)


def test_serve_runs_real_gnn_forward(graphs, small_feats):
    """The port's GNN forward per request, with the reference's parameters,
    agrees with the reference engine's logits within 1e-5."""
    jax = pytest.importorskip("jax")
    from repro.models.gnn import GNN as JGNN
    from repro.models.gnn import GNNConfig as JGNNConfig
    from repro_torch.models.gnn import GNN, GNNConfig
    kw = dict(model="sage", in_dim=16, hidden_dim=8, num_classes=5,
              fanouts=(3, 2))
    jgnn = JGNN(JGNNConfig(**kw, use_pallas=False))
    params = jgnn.init(jax.random.PRNGKey(0))
    tgnn = GNN(GNNConfig(**kw), device="cpu")
    tgnn.load_reference_params(jax.tree.map(np.asarray, params))
    jstream, tstream = _streams(graphs[1], n=6, qps=500)
    cfg = dict(fanouts=(3, 2), tenants=2, cache_lines=512, seed=7)
    jres = jserve.GNNServeEngine(graphs[0], small_feats,
                                 jserve.GNNServeConfig(**cfg), model=jgnn,
                                 params=params).run(
        _replay(jstream, jserve.ServeRequest))
    tres = GNNServeEngine(graphs[1], small_feats, GNNServeConfig(**cfg),
                          model=tgnn, device="cpu").run(_replay(tstream))
    _assert_same_result(jres, tres)
    n_served = 0
    for a, b, req in zip(jres.records, tres.records,
                         sorted(tstream, key=lambda r: r.rid)):
        if b.rejected:
            continue
        n_served += 1
        assert b.logits.shape == (len(req.seeds), 5)
        np.testing.assert_allclose(b.logits.numpy(), a.logits, rtol=1e-5,
                                   atol=1e-5)
    assert n_served


# -- the reference's records under quota control, faults and brownout ----------

@pytest.mark.parametrize("merged", [True, False], ids=["merged", "per_req"])
@pytest.mark.parametrize("plane", ["serve-gnn", "serve-gnn-shared"])
def test_records_match_reference_with_adaptive_quotas(graphs, small_feats,
                                                      merged, plane):
    jstream, tstream = _streams(graphs[1], n=120, qps=20_000)
    jres, tres, engine = _both(
        graphs, small_feats, jstream, tstream, merged=merged,
        data_plane=plane, tenants=2, tenant_quotas=(3.0, 1.0),
        cache_lines=512, adaptive_quotas=True, quota_interval=2,
        keep_features=True, seed=7)
    _assert_same_result(jres, tres, small_feats)
    if plane == "serve-gnn":
        assert tres.quota_trace, "no repartition happened"


def test_records_match_reference_under_brownout_and_faults(graphs):
    """fig_faults' serve scenario at this graph's size: shard 0 browns out
    10x from burst 3; with the ladder on, some requests are served stale
    (their rows staged from the host features) and some shed."""
    feats = np.random.default_rng(0).standard_normal(
        (graphs[0].num_nodes, 64)).astype(np.float32)
    j = jserve.generate_stream(2000, [jserve.TenantSpec(
        name="t0", deadline_s=3e-3, mean_seeds=8)], 500, 200, seed=3)
    t = generate_stream(2000, [tserve.TenantSpec(
        name="t0", deadline_s=3e-3, mean_seeds=8)], 500, 200, seed=3)
    jsched = JSchedule(events=(JBrownout(shard=0, start=3, end=10_000,
                                         multiplier=10.0),))
    tsched = FaultSchedule(events=(BrownoutEvent(shard=0, start=3,
                                                 end=10_000,
                                                 multiplier=10.0),))
    cfg = dict(seed=5, cache_lines=256, brownout=True, keep_features=True)
    jres = jserve.GNNServeEngine(graphs[0], feats, jserve.GNNServeConfig(
        fault_schedule=jsched, **cfg)).run(j)
    engine = GNNServeEngine(graphs[1], feats, GNNServeConfig(
        fault_schedule=tsched, **cfg), device="cpu")
    tres = engine.run(t)
    _assert_same_result(jres, tres, feats)
    assert tres.n_stale_served > 0 and tres.n_shed_brownout > 0
    assert engine.brownout.level_trace
    _assert_store_coherent(engine._tenant_tier, feats)


def test_tenant_row_store_coherent_across_repartition(graphs, small_feats):
    """After every probe, and right after every repartition (when the store
    is laid out and zeroed again for the new budgets), every resident line
    holds its tag's row; every served row is `features[all_nodes]`."""
    _, tstream = _streams(graphs[1], n=120, qps=20_000)
    engine = GNNServeEngine(graphs[1], small_feats, GNNServeConfig(
        tenants=2, tenant_quotas=(3.0, 1.0), cache_lines=512,
        adaptive_quotas=True, quota_interval=2, keep_features=True, seed=7),
        device="cpu")
    tier = engine._tenant_tier
    seen = {"probes": 0, "repartitions": 0}
    probe, repartition = tier._probe_rows, tier.repartition

    def checked_probe(*a, **k):
        out = probe(*a, **k)
        seen["probes"] += 1
        _assert_store_coherent(tier, small_feats)
        return out

    def checked_repartition(quotas):
        before = tier.total_lines
        repartition(quotas)
        seen["repartitions"] += 1
        assert not tier.rows.any(), "the store was not zeroed"
        assert (tier._flat_tags() < 0).all()
        assert tier.rows.shape[0] == tier.total_lines
        assert before > 0
    tier._probe_rows = checked_probe
    engine.quota_controller.tier.repartition = checked_repartition
    res = engine.run(_replay(tstream))
    assert seen["repartitions"] >= 1 and seen["probes"] > seen["repartitions"]
    for rec in res.served:
        np.testing.assert_array_equal(rec.features.numpy(),
                                      small_feats[rec.all_nodes])
    assert tier.quotas != (3.0, 1.0)


def test_engine_needs_a_card_unless_asked_for_the_cpu(graphs, small_feats):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNNServeEngine(graphs[1], small_feats, GNNServeConfig())


def test_reference_forward_under_brownout_fault_is_shared(graphs):
    """Both engines run the model built for the configured fanouts, and the
    brownout ladder's first step samples smaller ones: the reference's
    forward then fails to reshape a hop, and so does the port's (ROADMAP.md
    Queue 3 item 6).  The port matches the reference here; it does not
    serve such a request with other logits."""
    jax = pytest.importorskip("jax")
    from repro.models.gnn import GNN as JGNN
    from repro.models.gnn import GNNConfig as JGNNConfig
    from repro_torch.models.gnn import GNN, GNNConfig
    feats = np.random.default_rng(0).standard_normal(
        (graphs[0].num_nodes, 64)).astype(np.float32)
    kw = dict(model="sage", in_dim=64, hidden_dim=8, num_classes=5,
              fanouts=(10, 5))
    jgnn = JGNN(JGNNConfig(**kw, use_pallas=False))
    params = jgnn.init(jax.random.PRNGKey(0))
    tgnn = GNN(GNNConfig(**kw), device="cpu")
    cfg = dict(seed=5, cache_lines=256, brownout=True)
    j = jserve.generate_stream(2000, [jserve.TenantSpec(
        name="t0", deadline_s=3e-3, mean_seeds=8)], 500, 200, seed=3)
    t = generate_stream(2000, [tserve.TenantSpec(
        name="t0", deadline_s=3e-3, mean_seeds=8)], 500, 200, seed=3)
    with pytest.raises(TypeError, match="cannot reshape"):
        jserve.GNNServeEngine(graphs[0], feats, jserve.GNNServeConfig(
            fault_schedule=JSchedule(events=(JBrownout(
                shard=0, start=3, end=10_000, multiplier=10.0),)), **cfg),
            model=jgnn, params=params).run(j)
    with pytest.raises(RuntimeError, match="is invalid for input"):
        GNNServeEngine(graphs[1], feats, GNNServeConfig(
            fault_schedule=FaultSchedule(events=(BrownoutEvent(
                shard=0, start=3, end=10_000, multiplier=10.0),)), **cfg),
            model=tgnn, device="cpu").run(t)
