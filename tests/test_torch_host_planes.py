"""The host planes of the port on the CPU, side by side with the JAX
package: the numpy window cache, every host-plane preset through the
loader, the device row store that serves the cache's hits, `simulate_burst`
and the dataset registry.  Blocks, tier splits, kernel slots and priced
times must be bit-identical; features must equal `feats[all_nodes]`."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.core import software_cache as jcache  # noqa: E402
from repro.core import storage_sim as jsim  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core import software_cache as tcache  # noqa: E402
from repro_torch.core import storage_sim as tsim  # noqa: E402
from repro_torch.core.tiers import DeviceCacheTier  # noqa: E402
from repro_torch.graph import datasets as tdatasets  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N, DIM = 3000, 16
KW = dict(batch_size=64, fanouts=(4, 3), cache_lines=256, cache_ways=4,
          window_depth=4, cbuf_fraction=0.1)
COMPUTE_S = 3e-5
PRESETS = ("gids", "gids-async", "bam", "mmap", "pinned-host", "gids-merged",
           "gids-merged-async", "gids-topo", "gids-topo-merged")


def _feats(n=N, dim=DIM):
    return np.random.default_rng(0).standard_normal((n, dim)) \
        .astype(np.float32)


def _loaders(plane, **kw):
    feats = _feats()
    cfg = {**KW, **kw}
    ref = JLoader(jrmat(N, 8, DIM, seed=3), feats,
                  JConfig(data_plane=plane, **cfg))
    port = GIDSDataLoader(rmat_graph(N, 8, DIM, seed=3), feats,
                          LoaderConfig(data_plane=plane, **cfg), device="cpu")
    return feats, ref, port


def _assert_cache_equal(a, b):
    np.testing.assert_array_equal(a.tags, b.tags)
    np.testing.assert_array_equal(a.reuse, b.reuse)
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
    assert [w.tolist() for w in a.window] == [w.tolist() for w in b.window]


def _assert_row_store(tier, feats):
    """Every resident line holds its tag's feature row, bit for bit."""
    tags = tier.cache.tags.reshape(-1)
    resident = tags >= 0
    np.testing.assert_array_equal(tier.device_rows().numpy()[resident],
                                  feats[tags[resident]])


# -- the numpy window cache ------------------------------------------------------

def _trace(seed, n_batches=40, id_range=400):
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, id_range, rng.integers(5, 80)))
            for _ in range(n_batches)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("evict", ["random", "first"])
@pytest.mark.parametrize("window_depth", [0, 2, 8])
def test_window_cache_matches_reference(window_depth, evict, seed):
    """run_trace over a random trace under pressure: stats, tags, reuse and
    lookup equal the reference's, and again after reset() and a second
    run (the eviction rng restarts)."""
    trace = _trace(seed)
    probe = np.arange(-1, 420)
    a = jcache.WindowBufferedCache(64, 4, window_depth, seed=seed,
                                   evict=evict)
    b = tcache.WindowBufferedCache(64, 4, window_depth, seed=seed,
                                   evict=evict)
    for _ in range(2):
        sa, sb = jcache.run_trace(a, trace), tcache.run_trace(b, trace)
        assert dataclasses.asdict(sa) == dataclasses.asdict(sb)
        assert sa.evictions > 0
        _assert_cache_equal(a, b)
        np.testing.assert_array_equal(a.lookup(probe), b.lookup(probe))
        assert a.lookup(probe).dtype == b.lookup(probe).dtype
        assert (a.pinned_lines(), a.occupancy()) == (b.pinned_lines(),
                                                     b.occupancy())
        a.reset()
        b.reset()
        _assert_cache_equal(a, b)
        assert b.occupancy() == 0.0


def test_window_cache_counters_with_repeated_ids():
    """The vectorised counter bump equals the reference's loop when a
    window list repeats an id."""
    a = jcache.WindowBufferedCache(16, 2, window_depth=4)
    b = tcache.WindowBufferedCache(16, 2, window_depth=4)
    for c in (a, b):
        c.push_window(np.array([1, 2, 3]))
        c.access(np.array([1, 2, 3]))
        c.push_window(np.array([1, 1, 2, 7]))
        c.push_window(np.array([3, 3, 3]))
    _assert_cache_equal(a, b)
    assert b.reuse.max() == 3


# -- every host-plane preset against the reference --------------------------------

@pytest.mark.parametrize("plane", PRESETS)
def test_preset_matches_reference(plane):
    """10 batches with a fixed compute_s: blocks, tier counts, assignment,
    kernel slots, prep, exposed prep, sampling time and merge depth
    bit-identical; features equal feats[all_nodes]; the cache metadata
    and the prefetch telemetry end equal; every resident line of the row
    store holds its tag's row."""
    feats, ref, port = _loaders(plane)
    for _ in range(10):
        a = ref.next_batch(compute_s=COMPUTE_S)
        b = port.next_batch(compute_s=COMPUTE_S)
        np.testing.assert_array_equal(a.blocks.seeds, b.blocks.seeds)
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        for ha, hb in zip(a.blocks.hop_nodes, b.blocks.hop_nodes,
                          strict=True):
            np.testing.assert_array_equal(ha, hb)
        assert a.report.tier_names == b.report.tier_names
        assert a.report.tier_counts == b.report.tier_counts
        for name in ("prep_time_s", "exposed_prep_s", "sample_time_s",
                     "merge_depth"):
            assert getattr(a, name) == getattr(b, name), name
        jplan, tplan = ref.store.last_plan, port.store.last_plan
        assert tplan.is_partition()
        np.testing.assert_array_equal(jplan.assignment, tplan.assignment)
        if hasattr(jplan.tiers[0], "lookup_slots"):
            np.testing.assert_array_equal(jplan.kernel_slots(0),
                                          tplan.kernel_slots(0))
        assert isinstance(b.features, torch.Tensor)
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
    assert (ref.store.cache is None) == (port.store.cache is None)
    if port.store.cache is not None:
        _assert_cache_equal(ref.store.cache, port.store.cache)
        assert port.store.cache.stats.hits > 0
        _assert_row_store(port.store.tiers[0], feats)
    assert (ref.prefetch is None) == (port.prefetch is None)
    if port.prefetch is not None:
        assert dataclasses.asdict(ref.prefetch.stats) \
            == dataclasses.asdict(port.prefetch.stats)


def test_kernel_slots_feed_tiered_gather():
    """The plan's slots and the tier's resident row store, through
    `ops.tiered_gather` with the batch's rows staged, give feats[ids]: the
    twin of the reference's plan-to-kernel test, with the port's row store
    in place of rows rematerialised from the tags."""
    feats, _, port = _loaders("gids", cache_lines=4096, window_depth=2,
                              cbuf_fraction=0.0, batch_size=32, fanouts=(3,))
    for _ in range(3):
        b = port.next_batch()
    plan = port.store.last_plan
    slots = plan.kernel_slots(0)
    assert (slots[plan.mask(0)] >= 0).all() and plan.mask(0).any()
    assert (slots[~plan.mask(0)] == -1).all()
    rows = port.store.device_rows(0)
    assert rows is port.store.tiers[0].rows      # resident, not a copy
    out = ops.tiered_gather(torch.from_numpy(slots.astype(np.int32)), rows,
                            torch.from_numpy(feats[plan.node_ids]))
    np.testing.assert_array_equal(out.numpy(), feats[plan.node_ids])
    assert b.report.n_hbm_hits == int(plan.mask(0).sum())


# -- the row store that serves the hits --------------------------------------------

@pytest.mark.parametrize("plane", ["gids", "gids-merged", "bam"])
def test_row_store_invariant_after_every_probe(plane, monkeypatch):
    """After every probe of a loader under cache pressure, each resident
    line holds its tag's row and the probe's rows equal feats[ids]."""
    feats, _, port = _loaders(plane, cache_lines=64)
    tier = port.store.tiers[0]
    probe_rows, probes = tier._probe_rows, []

    def checked(node_ids, multiplicity=None, inverses=None):
        hits = probe_rows(node_ids, multiplicity, inverses)
        _assert_row_store(tier, feats)
        if inverses is None:
            np.testing.assert_array_equal(tier.last_rows.numpy(),
                                          feats[node_ids])
        else:
            for rows, inv in zip(tier.last_window_rows, inverses,
                                 strict=True):
                np.testing.assert_array_equal(rows.numpy(),
                                              feats[node_ids[inv]])
        probes.append(tier.last_counts)
        return hits

    monkeypatch.setattr(tier, "_probe_rows", checked)
    for _ in range(10):
        port.next_batch()
    assert probes and sum(p["filled_lines"] for p in probes) > 0
    assert tier.cache.stats.evictions > 0
    for p in probes:
        assert p["staged_rows"] >= p["rows"] - p["hits"]   # + demoted hits
        assert p["needed_bytes"] <= p["h2d_bytes"] == p["rows"] * DIM * 4


def _same_set(cache, n):
    """n node ids that hash into one set of `cache`."""
    ids = np.arange(1, 10_000)
    sets = tcache._hash_ids(ids, cache.num_sets)
    return ids[sets == sets[0]][:n]


def test_row_store_demoted_hit_and_bypass():
    """A hit whose line a later fill of the same probe takes is served from
    its staged row (slot -1); a miss into a set whose ways are all pinned
    bypasses the cache and fills nothing.  The row store stays coherent
    through both."""
    feats = _feats(10_000)
    # one way per set: the second request of the probe evicts the first
    tier = DeviceCacheTier(tcache.WindowBufferedCache(4, 1, evict="first"),
                           feats, device="cpu")
    a, b = _same_set(tier.cache, 2)
    tier.probe(np.array([a]))
    _assert_row_store(tier, feats)
    hits = tier.probe(np.array([a, b]))
    np.testing.assert_array_equal(hits, [True, False])
    assert tier.lookup_slots(np.array([a]))[0] == -1          # demoted
    assert tier.last_counts["staged_rows"] == 2
    np.testing.assert_array_equal(tier.last_rows.numpy(), feats[[a, b]])
    _assert_row_store(tier, feats)

    # window pinning: a's line is pinned by a future reuse when b arrives
    tier = DeviceCacheTier(tcache.WindowBufferedCache(4, 1, window_depth=2,
                                                      evict="first"),
                           feats, device="cpu")
    c = _same_set(tier.cache, 3)[2]
    tier.admit(np.array([a]))
    tier.probe(np.array([a]))
    tier.admit(np.array([c]))
    tier.admit(np.array([a]))
    assert tier.cache.reuse.max() == 1
    hits = tier.probe(np.array([b]))
    assert not hits.any() and tier.cache.stats.bypasses == 1
    assert tier.last_counts["filled_lines"] == 0
    np.testing.assert_array_equal(tier.last_rows.numpy(), feats[[b]])
    assert tier.lookup_slots(np.array([a, b])).tolist()[1] == -1
    _assert_row_store(tier, feats)
    tier.reset()
    assert not tier.device_rows().any() and tier.cache.occupancy() == 0.0


def test_row_store_refuses_repeated_ids():
    """Node ids must be unique within a probe: when a repeated id hits,
    loses its line and is refilled into another way of its set, its first
    request would read that line before the fill; the probe refuses."""
    feats = _feats(100)
    # one set of two ways; x arrives pinned by the window, so the second
    # request for a takes the other way
    tier = DeviceCacheTier(tcache.WindowBufferedCache(2, 2, window_depth=2,
                                                      evict="first"),
                           feats, device="cpu")
    a, c, q, x = 1, 2, 3, 4
    tier.probe(np.array([a, c]))
    tier.admit(np.array([q]))
    tier.admit(np.array([x]))
    with pytest.raises(ValueError, match="unique"):
        tier.probe(np.array([a, x, a]))
    assert tier.cache.tags.tolist() == [[x, a]]


# -- simulate_burst and the dataset registry ---------------------------------------

@pytest.mark.parametrize("args", [
    (jsim.INTEL_OPTANE.name, 64, 1, None, 0),
    (jsim.SAMSUNG_980PRO.name, 1000, 2, None, 1),
    (jsim.INTEL_OPTANE.name, 500, 4, 32, 2),
    (jsim.SAMSUNG_980PRO.name, 3, 4, 1, 3),
])
def test_simulate_burst_matches_reference(args):
    name, n, n_ssd, qd, seed = args
    jspec = {s.name: s for s in (jsim.INTEL_OPTANE, jsim.SAMSUNG_980PRO)}
    tspec = {s.name: s for s in (tsim.INTEL_OPTANE, tsim.SAMSUNG_980PRO)}
    a = jsim.simulate_burst(jspec[name], n, n_ssd, queue_depth=qd, seed=seed)
    b = tsim.simulate_burst(tspec[name], n, n_ssd, queue_depth=qd, seed=seed)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_datasets_registry_matches_reference():
    assert list(jdatasets.REGISTRY) == list(tdatasets.REGISTRY)
    for name, a in jdatasets.REGISTRY.items():
        b = tdatasets.REGISTRY[name]
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.feature_bytes, a.avg_degree) == (b.feature_bytes,
                                                   b.avg_degree)
    spec = dict(name="smoke", num_nodes=20_000, num_edges=240_000,
                feature_dim=64, exec_nodes=2_000)
    ga = jdatasets.DatasetSpec(**spec).materialize(seed=1)
    gb = tdatasets.DatasetSpec(**spec).materialize(seed=1)
    np.testing.assert_array_equal(ga.indptr, gb.indptr)
    np.testing.assert_array_equal(ga.indices, gb.indices)
    assert (ga.name, ga.feature_dim) == (gb.name, gb.feature_dim)
