"""The serve-plane priced keys recorded in BENCH_pr10.json, computed through
the port on the CPU with the same streams, graphs and engine configurations
as the `headline()` of benchmarks/fig_serve_load.py, and the serve halves of
benchmarks/fig_faults.py and fig_adaptive.py.  Every key must be equal, not
close: each is a priced float, a ratio of them or a count of the virtual-
time engine.  The fig_faults and fig_adaptive serve keys are held both
against their BENCH_pr10.json literals and against the reference's own run
here, through the same functions."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import (BrownoutEvent, FaultSchedule,  # noqa: E402
                              GIDSDataLoader, LoaderConfig)
from repro_torch.graph.csr import disjoint_union  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph, uniform_graph  # noqa: E402
from repro_torch.serve import (GNNServeConfig, GNNServeEngine,  # noqa: E402
                               TenantSpec, generate_stream)

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCH_pr10.json").read_text())

# -- fig_serve_load: the module's constants, spelled with the port's types ----
DEADLINE_S = 3e-3
P99_TARGET_S = 1.1 * DEADLINE_S
ATTAINMENT_FLOOR = 0.95
LOAD_GRID_QPS = (2000, 4000, 8000, 16000, 24000, 32000)
SWEEP_TENANTS = (
    TenantSpec("steady", rate_share=1.0, hot_fraction=0.03, hot_prob=0.9,
               mean_seeds=4, deadline_s=DEADLINE_S, arrival="poisson"),
    TenantSpec("bursty", rate_share=1.0, hot_fraction=0.5, hot_prob=0.2,
               mean_seeds=8, deadline_s=DEADLINE_S, arrival="mmpp",
               burst_factor=8.0, burst_fraction=0.1, burst_cycle_s=0.02),
)
VICTIM = TenantSpec("victim", rate_share=1.0, hot_fraction=0.02,
                    hot_prob=0.95, mean_seeds=10, deadline_s=1.5e-3,
                    arrival="poisson", node_range=(0, 10_000))
NOISY = TenantSpec("noisy", rate_share=1.0, hot_fraction=0.9, hot_prob=0.0,
                   mean_seeds=8, deadline_s=8e-3, arrival="mmpp",
                   burst_factor=8.0, burst_fraction=0.1, burst_cycle_s=0.02,
                   node_range=(10_000, 20_000))


def _clone(requests):
    return [type(r)(r.rid, r.tenant, r.arrival_s, r.seeds.copy(),
                    r.deadline_s) for r in requests]


def _serve(graph, feats, requests, **cfg_kw):
    engine = GNNServeEngine(graph, feats, GNNServeConfig(seed=3, **cfg_kw),
                            device="cpu")
    return engine.run(_clone(requests)), engine


def _sustainable(curves, mode):
    best = 0.0
    for point in (c for c in curves if c["mode"] == mode):
        if not point["sustained"]:
            break
        best = point["offered_qps"]
    return best


@pytest.fixture(scope="module")
def serve_load():
    graph = rmat_graph(20_000, 12, 64, seed=7)
    feats = np.random.default_rng(0).standard_normal(
        (graph.num_nodes, 64)).astype(np.float32)
    curves = []
    for qps in LOAD_GRID_QPS:
        requests = generate_stream(graph.num_nodes, SWEEP_TENANTS, qps, 400,
                                   seed=11)
        for merged in (True, False):
            res, _ = _serve(graph, feats, requests, merged=merged, tenants=2)
            attainment = sum(r.deadline_met for r in res.records) \
                / len(res.records)
            p99 = res.p99_s()
            curves.append({
                "mode": "merged" if merged else "per_request",
                "offered_qps": res.offered_qps(),
                "goodput_qps": res.goodput_qps(),
                "sustained": (p99 <= P99_TARGET_S
                              and attainment >= ATTAINMENT_FLOOR)})
    colocated = disjoint_union([rmat_graph(10_000, 12, 1024, seed=7),
                                uniform_graph(10_000, 12, 1024, seed=8)],
                               name="colocated")
    wide = np.random.default_rng(0).standard_normal(
        (colocated.num_nodes, 1024)).astype(np.float32)
    alone = generate_stream(colocated.num_nodes, (VICTIM,), 1000, 300,
                            seed=11)
    both = generate_stream(colocated.num_nodes, (VICTIM, NOISY), 2000, 600,
                           seed=11)
    res_alone, _ = _serve(colocated, wide, alone, merged=True, tenants=1,
                          data_plane="serve-gnn-shared")
    res_shared, _ = _serve(colocated, wide, both, merged=True, tenants=2,
                           data_plane="serve-gnn-shared")
    res_part, engine = _serve(colocated, wide, both, merged=True, tenants=2,
                              data_plane="serve-gnn",
                              tenant_quotas=(3.0, 1.0))
    merged_max = _sustainable(curves, "merged")
    per_request_max = _sustainable(curves, "per_request")
    p99_alone = res_alone.p99_s(tenant=0)
    p99_shared = res_shared.p99_s(tenant=0)
    p99_part = res_part.p99_s(tenant=0)
    return {
        "deadline_s": DEADLINE_S,
        "p99_target_s": P99_TARGET_S,
        "attainment_floor": ATTAINMENT_FLOOR,
        "merged_max_qps": merged_max,
        "per_request_max_qps": per_request_max,
        "sustainable_qps_ratio": merged_max / max(per_request_max, 1e-9),
        "merged_peak_goodput_qps": max(c["goodput_qps"] for c in curves
                                       if c["mode"] == "merged"),
        "per_request_peak_goodput_qps": max(c["goodput_qps"] for c in curves
                                            if c["mode"] == "per_request"),
        "victim_p99_alone_s": p99_alone,
        "victim_p99_shared_s": p99_shared,
        "victim_p99_partitioned_s": p99_part,
        "victim_degradation_shared": p99_shared / p99_alone,
        "victim_degradation_partitioned": p99_part / p99_alone,
        "victim_hit_ratio_partitioned": engine._tenant_tier.hit_ratio(0),
        "noisy_hit_ratio_partitioned": engine._tenant_tier.hit_ratio(1),
    }


@pytest.mark.parametrize("key", sorted(BENCH["fig_serve_load"]))
def test_fig_serve_load_key(serve_load, key):
    assert serve_load[key] == BENCH["fig_serve_load"][key]


# -- fig_faults: faultfree_identity's serve half and serve_brownout ------------

def _faults_graph(dim):
    g = rmat_graph(10_000, 12, 16, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.num_nodes, dim)).astype(np.float32)
    return g, feats


@pytest.fixture(scope="module")
def serve_faults():
    g, feats = _faults_graph(512)
    reqs = list(generate_stream(
        g.num_nodes, [TenantSpec(name="t0", deadline_s=3e-3, mean_seeds=8)],
        offered_qps=500, n_requests=300, seed=3))
    sched = FaultSchedule(events=(
        BrownoutEvent(shard=0, start=3, end=10_000, multiplier=10.0),))

    def run(**over):
        cfg = dict(seed=5, cache_lines=256)
        cfg.update(over)
        eng = GNNServeEngine(g, feats, GNNServeConfig(**cfg), device="cpu")
        return eng.run(reqs), eng

    free, _ = run()
    free_again, _ = run(fault_schedule=None, brownout=False)
    naive, _ = run(fault_schedule=sched)
    ctl, _ = run(fault_schedule=sched, brownout=True)
    serve_ok = len(free.records) == len(free_again.records) and all(
        a.completion_s == b.completion_s and a.gather_s == b.gather_s
        and not b.stale and b.degraded_level == 0
        for a, b in zip(free.records, free_again.records))
    # the loader half of faultfree_identity: an empty schedule is invisible
    gl, feats_l = _faults_graph(16)
    kw = dict(batch_size=256, fanouts=(2,), data_plane="gids-merged-sharded",
              cache_lines=512, window_depth=4, n_shards=4,
              placement="degree", seed=7)
    plain = GIDSDataLoader(gl, feats_l, LoaderConfig(**kw), device="cpu")
    empty = GIDSDataLoader(gl, feats_l, LoaderConfig(
        fault_schedule=FaultSchedule(), **kw), device="cpu")
    loader_ok = True
    for _ in range(8):
        a, b = plain.next_batch(), empty.next_batch()
        loader_ok &= (a.prep_time_s == b.prep_time_s
                      and a.exposed_prep_s == b.exposed_prep_s
                      and torch.equal(a.features, b.features))
    return {
        "faultfree_identical": bool(loader_ok and serve_ok),
        "serve_free_p99_ms": free.p99_s() * 1e3,
        "serve_naive_p99_ratio": naive.p99_s() / max(free.p99_s(), 1e-12),
        "serve_ctl_p99_ratio": ctl.p99_s() / max(free.p99_s(), 1e-12),
        "serve_naive_attainment": naive.attainment(),
        "serve_ctl_attainment": ctl.attainment(),
        "serve_shed_fraction": ctl.shed_fraction,
        "serve_n_stale_served": ctl.n_stale_served,
    }


@pytest.fixture(scope="module")
def reference_serve_faults():
    sys.path.insert(0, str(ROOT))
    from benchmarks import fig_faults
    serve = fig_faults.serve_brownout()
    return {
        "serve_free_p99_ms": serve["free_p99_ms"],
        "serve_naive_p99_ratio": serve["naive_p99_ratio"],
        "serve_ctl_p99_ratio": serve["ctl_p99_ratio"],
        "serve_naive_attainment": serve["naive_attainment"],
        "serve_ctl_attainment": serve["ctl_attainment"],
        "serve_shed_fraction": serve["shed_fraction"],
        "serve_n_stale_served": serve["n_stale_served"],
    }


FAULT_KEYS = ["faultfree_identical", "serve_free_p99_ms",
              "serve_naive_p99_ratio", "serve_ctl_p99_ratio",
              "serve_naive_attainment", "serve_ctl_attainment",
              "serve_shed_fraction", "serve_n_stale_served"]


@pytest.mark.parametrize("key", FAULT_KEYS)
def test_fig_faults_serve_key(serve_faults, key):
    assert serve_faults[key] == BENCH["fig_faults"][key]


def test_fig_faults_serve_matches_reference_run(serve_faults,
                                                reference_serve_faults):
    for key, want in reference_serve_faults.items():
        assert serve_faults[key] == want, key


# -- fig_adaptive: serve_quota -------------------------------------------------

QUOTA_TENANTS = (
    TenantSpec("big", rate_share=2.0, hot_fraction=0.12, hot_prob=0.95,
               deadline_s=4e-3),
    TenantSpec("small", rate_share=1.0, hot_fraction=0.004, hot_prob=0.95,
               deadline_s=4e-3),
)


@pytest.fixture(scope="module")
def serve_quota():
    g = rmat_graph(10_000, 12, 16, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 64)).astype(np.float32)
    stream = generate_stream(g.num_nodes, QUOTA_TENANTS, offered_qps=3000,
                             n_requests=600, seed=3)
    out = {}
    for adaptive in (False, True):
        engine = GNNServeEngine(g, feats, GNNServeConfig(
            tenants=2, cache_lines=2048, adaptive_quotas=adaptive,
            quota_interval=8, seed=5), device="cpu")
        res = engine.run(list(stream))
        key = "adaptive" if adaptive else "fixed"
        out[f"quota_{key}_p99_ms"] = res.p99_s() * 1e3
        out[f"quota_{key}_big_hit_ratio"] = res.tenant_hit_ratios[0]
        if adaptive:
            out["quota_repartitions"] = len(res.quota_trace)
            out["quota_trace"] = res.quota_trace
    return out


QUOTA_KEYS = ["quota_repartitions", "quota_fixed_big_hit_ratio",
              "quota_adaptive_big_hit_ratio", "quota_fixed_p99_ms",
              "quota_adaptive_p99_ms"]


@pytest.mark.parametrize("key", QUOTA_KEYS)
def test_fig_adaptive_quota_key(serve_quota, key):
    assert serve_quota[key] == BENCH["fig_adaptive"][key]


def test_fig_adaptive_quota_matches_reference_run(serve_quota):
    sys.path.insert(0, str(ROOT))
    from benchmarks import fig_adaptive
    ref = fig_adaptive.serve_quota()
    assert serve_quota["quota_repartitions"] == ref["repartitions"]
    assert serve_quota["quota_trace"][-1][1] == ref["final_quotas"]
    assert serve_quota["quota_fixed_p99_ms"] == ref["fixed_p99_s"] * 1e3
    assert serve_quota["quota_adaptive_p99_ms"] == ref["adaptive_p99_s"] * 1e3
    assert serve_quota["quota_adaptive_big_hit_ratio"] \
        == ref["adaptive_big_hit_ratio"]
