"""The sharded, cluster, fault and adaptive priced keys recorded in
BENCH_pr10.json, computed through the port on the CPU with the same loaders
as the `headline()` of benchmarks/fig_shard_scaling.py, fig_hosts.py,
fig_faults.py and fig_adaptive.py.  Every key must be equal, not close:
each is a priced float or a count of the storage model.

Three fig_faults keys (`naive_prep_us`, `hedged_prep_us`,
`hedged_vs_naive_speedup`) are held against the reference's own
`brownout_hedge()` run here: the reference no longer reproduces their
BENCH_pr10.json literals to the last bit (ROADMAP.md Queue 1 item 7).  The
serve keys, `faultfree_identical` and the quota keys wait for the GNN
serving slice."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import (INTEL_OPTANE, SAMSUNG_980PRO,  # noqa: E402
                              BrownoutEvent, FaultSchedule, FlakyReadsEvent,
                              GIDSDataLoader, LoaderConfig, OutageEvent,
                              make_placement)
from repro_torch.graph.synthetic import (clustered_graph,  # noqa: E402
                                         rmat_graph)

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCH_pr10.json").read_text())


def _loader(g, feats, ssd=INTEL_OPTANE, **kw):
    return GIDSDataLoader(g, feats, LoaderConfig(**kw), ssd=ssd,
                          device="cpu")


# -- fig_shard_scaling ---------------------------------------------------------

@pytest.fixture(scope="module")
def shard_scaling():
    g = rmat_graph(20_000, 12, 64, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 64)).astype(np.float32)
    kw = dict(batch_size=256, fanouts=(6, 4),
              data_plane="gids-merged-sharded", cache_lines=2048,
              window_depth=4, seed=3)

    def run(n_shards, placement):
        dl = _loader(g, feats, SAMSUNG_980PRO, n_shards=n_shards,
                     placement=placement, **kw)
        batches = [dl.next_batch() for _ in range(16)]
        return float(np.mean([b.exposed_prep_s for b in batches[6:]])), dl

    out = {}
    for n in (1, 2, 4, 8):
        out[f"hash_{n}shard_exposed_prep_us"] = run(n, "hash")[0] * 1e6
    out["prep_speedup_4shard_vs_1shard"] = (
        out["hash_1shard_exposed_prep_us"] / 1e6
        / max(out["hash_4shard_exposed_prep_us"] / 1e6, 1e-12))
    prep, dl = run(4, "skewed")
    out["skewed_4shard_exposed_prep_us"] = prep * 1e6
    out["skewed_4shard_imbalance"] = dl.timeline.shard_burst.imbalance
    dl = _loader(g, feats, INTEL_OPTANE, n_shards=4, placement="hash", **kw)
    dl.timeline.shard_specs = (SAMSUNG_980PRO, INTEL_OPTANE, INTEL_OPTANE,
                               INTEL_OPTANE)
    for _ in range(16):
        dl.next_batch()
    het = dl.timeline.shard_burst
    out.update(hetero_straggler_shard=het.straggler,
               hetero_straggler_spec=het.straggler_spec,
               hetero_imbalance=het.imbalance)
    return out


@pytest.mark.parametrize("key", sorted(BENCH["fig_shard_scaling"]))
def test_fig_shard_scaling_key(shard_scaling, key):
    assert shard_scaling[key] == BENCH["fig_shard_scaling"][key]


# -- fig_hosts -----------------------------------------------------------------

@pytest.fixture(scope="module")
def hosts():
    g = clustered_graph(20_000, 12, 64, communities=32, intra=0.9, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 64)).astype(np.float32)
    kw = dict(batch_size=256, fanouts=(6, 4), cache_lines=256,
              window_depth=4, seed=3)

    def run(plane, **over):
        dl = _loader(g, feats, SAMSUNG_980PRO, data_plane=plane, **kw,
                     **over)
        batches = [dl.next_batch() for _ in range(16)]
        return (float(np.mean([b.exposed_prep_s for b in batches[6:]])),
                batches, dl)

    _, ref_batches, _ = run("gids-merged")
    by, identical = {}, True
    for placement, co in (("metis-lite", True), ("hash", False)):
        for n in (1, 2, 4, 8):
            prep, batches, dl = run("gids-hosts-merged", n_hosts=n,
                                    placement=placement, co_partition=co)
            for a, b in zip(ref_batches, batches, strict=True):
                identical &= torch.equal(a.features, b.features)
                identical &= np.array_equal(a.blocks.all_nodes,
                                            b.blocks.all_nodes)
                if n == 1:
                    identical &= a.exposed_prep_s == b.exposed_prep_s
            tier, burst = dl.store.tiers[-1], dl.timeline.shard_burst
            by[placement, co, n] = dict(
                prep=prep, cut=tier.cut_edge_fraction(),
                remote=tier.remote_fraction(),
                imbalance=burst.imbalance if burst else 1.0,
                straggler=burst.straggler if burst else 0)
    out = {}
    for n in (1, 2, 4, 8):
        out[f"metis_co_{n}host_exposed_prep_us"] = \
            by["metis-lite", True, n]["prep"] * 1e6
        out[f"hash_indep_{n}host_exposed_prep_us"] = \
            by["hash", False, n]["prep"] * 1e6
    win, lose = by["metis-lite", True, 4], by["hash", False, 4]
    out.update(
        speedup_metis_co_vs_hash_indep_4hosts=(
            lose["prep"] / max(win["prep"], 1e-12)),
        metis_co_4host_cut_edge_fraction=win["cut"],
        hash_indep_4host_cut_edge_fraction=lose["cut"],
        metis_co_4host_remote_fraction=win["remote"],
        metis_co_4host_imbalance=win["imbalance"],
        metis_co_4host_straggler=win["straggler"],
        hosts1_bit_identical=bool(identical))
    return out


@pytest.mark.parametrize("key", sorted(BENCH["fig_hosts"]))
def test_fig_hosts_key(hosts, key):
    assert hosts[key] == BENCH["fig_hosts"][key]


# -- fig_faults ----------------------------------------------------------------

SCHED_BROWNOUT = FaultSchedule(
    events=(BrownoutEvent(shard=2, start=1, end=9, multiplier=10.0),))
SCHED_CHAOS = FaultSchedule(
    events=(BrownoutEvent(shard=2, start=1, end=9, multiplier=10.0),
            OutageEvent(shard=0, start=4, end=7),
            FlakyReadsEvent(shard=1, start=2, end=12, fail_prob=0.2)),
    seed=3)
FAULT_BATCHES = 48


@pytest.fixture(scope="module")
def faults():
    g = rmat_graph(10_000, 12, 16, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 16)).astype(np.float32)
    kw = dict(batch_size=256, fanouts=(2,), data_plane="gids-merged-sharded",
              cache_lines=512, window_depth=4, n_shards=4,
              placement="degree", seed=7)
    naive = _loader(g, feats, fault_schedule=SCHED_BROWNOUT, **kw)
    hedged = _loader(g, feats, fault_schedule=SCHED_BROWNOUT,
                     replication_factor=2, **kw)
    t_naive = sum(naive.next_batch().exposed_prep_s
                  for _ in range(FAULT_BATCHES))
    t_hedged = sum(hedged.next_batch().exposed_prep_s
                   for _ in range(FAULT_BATCHES))
    clean = _loader(g, feats, **kw)
    chaos = _loader(g, feats, fault_schedule=SCHED_CHAOS,
                    replication_factor=2, **kw)
    identical, never_cheaper, slower = True, True, 0
    for _ in range(FAULT_BATCHES):
        bc, bf = clean.next_batch(), chaos.next_batch()
        identical &= (np.array_equal(bc.blocks.all_nodes,
                                     bf.blocks.all_nodes)
                      and torch.equal(bc.features, bf.features))
        never_cheaper &= bf.prep_time_s >= bc.prep_time_s
        slower += bf.prep_time_s > bc.prep_time_s
    return {
        "hedged_vs_naive_speedup": t_naive / max(t_hedged, 1e-12),
        "naive_prep_us": t_naive * 1e6,
        "hedged_prep_us": t_hedged * 1e6,
        "n_hedged_bursts": hedged.fault_injector.n_hedged_bursts,
        "n_rerouted": hedged.store.tiers[-1].router.n_rerouted,
        "fault_data_identical": bool(identical and never_cheaper
                                     and slower > 0),
        "chaos_n_faulted_bursts": chaos.fault_injector.n_faulted_bursts,
    }


@pytest.fixture(scope="module")
def reference_brownout_hedge():
    """The reference benchmark's own `brownout_hedge()`, run now."""
    sys.path.insert(0, str(ROOT))
    from benchmarks import fig_faults
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fig_faults.brownout_hedge()


@pytest.mark.parametrize("key", ["n_hedged_bursts", "n_rerouted",
                                 "fault_data_identical",
                                 "chaos_n_faulted_bursts"])
def test_fig_faults_key(faults, key):
    assert faults[key] == BENCH["fig_faults"][key]


def test_fig_faults_brownout_hedge_matches_reference_run(
        faults, reference_brownout_hedge):
    ref = reference_brownout_hedge
    assert faults["naive_prep_us"] == ref["naive_prep_s"] * 1e6
    assert faults["hedged_prep_us"] == ref["hedged_prep_s"] * 1e6
    assert faults["hedged_vs_naive_speedup"] == ref["speedup"]
    assert faults["n_hedged_bursts"] == ref["n_hedged_bursts"]
    assert faults["n_rerouted"] == ref["n_rerouted"]


# -- fig_adaptive --------------------------------------------------------------

EPOCHS, ROT_BATCHES, STATIC_BATCHES, TOPO_BATCHES = 4, 64, 24, 32


@pytest.fixture(scope="module")
def adaptive_graph():
    g = rmat_graph(10_000, 12, 16, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 64)).astype(np.float32)
    return g, feats


def _sharded(g, feats, placement, **over):
    kw = dict(batch_size=256, fanouts=(2,), data_plane="gids-merged-sharded",
              cache_lines=512, window_depth=4, n_shards=4,
              placement=placement, seed=7, rebalance_interval=4,
              migration_horizon=64)
    kw.update(over)
    return _loader(g, feats, **kw)


def _drift(g, feats, placement, hot_sets):
    dl = _sharded(g, feats, placement)
    prep = 0.0
    for epoch in range(EPOCHS):
        dl.train_ids = hot_sets[epoch % len(hot_sets)]
        for _ in range(ROT_BATCHES):
            prep += dl.next_batch().exposed_prep_s
    reb = dl.rebalancer
    return prep, (reb.n_migrations if reb else 0), \
        (reb.total_migration_cost_s if reb else 0.0)


@pytest.fixture(scope="module")
def adaptive(adaptive_graph):
    g, feats = adaptive_graph
    out = {}
    table = make_placement("degree", 4, degrees=np.diff(g.indptr)).table
    hot = [np.nonzero(table == s)[0] for s in range(4)]
    deg, _, _ = _drift(g, feats, "degree", hot)
    ada, n_mig, cost = _drift(g, feats, "adaptive", hot)
    out.update(adaptive_vs_degree_speedup=deg / max(ada, 1e-12),
               rotation_n_migrations=n_mig,
               rotation_migration_cost_us=cost * 1e6,
               rotation_degree_prep_us=deg * 1e6,
               rotation_adaptive_prep_us=ada * 1e6)
    runs, migrations = {}, 0
    for pol in ("degree", "adaptive"):
        dl = _sharded(g, feats, pol, cache_lines=2048)
        runs[pol] = [dl.next_batch() for _ in range(STATIC_BATCHES)]
        if pol == "adaptive":
            migrations = dl.rebalancer.n_migrations
    out["static_bit_identical"] = migrations == 0 and all(
        a.prep_time_s == b.prep_time_s and torch.equal(a.features,
                                                       b.features)
        for a, b in zip(runs["degree"], runs["adaptive"], strict=True))
    out["static_n_migrations"] = migrations
    hot = list(np.array_split(np.arange(g.num_nodes), EPOCHS))
    deg, _, _ = _drift(g, feats, "degree", hot)
    ada, n_mig, _ = _drift(g, feats, "adaptive", hot)
    out.update(growth_speedup=deg / max(ada, 1e-12),
               growth_n_migrations=n_mig)
    totals, streams = {}, {}
    for adm in ("degree", "adaptive"):
        dl = _loader(g, feats, batch_size=256, fanouts=(5, 3),
                     data_plane="gids-topo", cache_lines=2048,
                     topo_admission=adm, topo_gpu_fraction=0.05,
                     topo_host_fraction=0.25, seed=7, rebalance_interval=4,
                     migration_horizon=64)
        sample, sig = 0.0, []
        for epoch in range(EPOCHS):
            dl.train_ids = hot[epoch % EPOCHS]
            for _ in range(TOPO_BATCHES):
                b = dl.next_batch()
                sample += b.sample_time_s
                sig.append(int(b.blocks.all_nodes.sum()))
        totals[adm], streams[adm] = sample, sig
    out.update(topo_blocks_identical=streams["degree"] == streams["adaptive"],
               topo_sample_speedup=(totals["degree"]
                                    / max(totals["adaptive"], 1e-12)),
               topo_n_refreshes=dl.topo_refresher.n_refreshes)
    return out


@pytest.mark.parametrize("key", [
    "adaptive_vs_degree_speedup", "rotation_n_migrations",
    "rotation_migration_cost_us", "rotation_degree_prep_us",
    "rotation_adaptive_prep_us", "static_bit_identical",
    "static_n_migrations", "growth_speedup", "growth_n_migrations",
    "topo_sample_speedup", "topo_blocks_identical", "topo_n_refreshes"])
def test_fig_adaptive_key(adaptive, key):
    assert adaptive[key] == BENCH["fig_adaptive"][key]
