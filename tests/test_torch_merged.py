"""The port's second slice on the CPU: merged-window execution and the
topology plane on the device store (`gids-device` with `merge_execute`
and/or `topology`), side by side with the JAX package's loader.  Blocks,
reports and priced times must be bit-identical; features must equal
`feats[all_nodes]` (the reference's own rows are not a target: its
`device_gather` serves wrong rows under cache pressure, ROADMAP.md
Queue 3)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.core import accumulator as jacc  # noqa: E402
from repro.core import storage_sim as jsim  # noqa: E402
from repro.core.dataplane import DataPlaneSpec as JSpec  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import cache_device, device_store  # noqa: E402
from repro_torch.core import storage_sim as tsim  # noqa: E402
from repro_torch.core.dataplane import DataPlaneSpec  # noqa: E402
from repro_torch.core.feature_store import CoalescedReport  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.models.gnn import (GNN, GNNConfig, hop_indices,  # noqa: E402
                                    sgd_step)

N, DIM = 5000, 64
KW = dict(batch_size=64, fanouts=(4, 3), cache_lines=512, cache_ways=4,
          window_depth=4, topo_gpu_fraction=0.25, topo_host_fraction=0.5)
PLANES = [(True, True), (True, False), (False, True)]
PLANE_IDS = ["merged+topo", "merged", "topo"]


def _feats():
    return np.random.default_rng(0).standard_normal((N, DIM)) \
        .astype(np.float32)


def _loaders(merge_execute, topology, **kw):
    feats = _feats()
    over = dict(merge_execute=merge_execute, topology=topology)
    cfg = {**KW, **kw}
    ref = JLoader(jrmat(N, 8, DIM, seed=3), feats,
                  JConfig(data_plane=JSpec.preset("gids-device", **over),
                          **cfg))
    port = GIDSDataLoader(
        rmat_graph(N, 8, DIM, seed=3), feats,
        LoaderConfig(data_plane=DataPlaneSpec.preset("gids-device", **over),
                     **cfg), device="cpu")
    return feats, ref, port


def _report_fields(rep) -> dict:
    return {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}


# -- merge_window and the merged pricing ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_window_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lists = [np.unique(rng.integers(0, 500, rng.integers(1, 300)))
             for _ in range(int(rng.integers(1, 9)))]
    a, b = jacc.merge_window(lists), tacc.merge_window(lists)
    for name in ("unique_nodes", "inverse", "offsets"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert getattr(a, name).dtype == getattr(b, name).dtype
    assert (a.n_batches, a.n_requests, a.n_unique, a.n_duplicate) \
        == (b.n_batches, b.n_requests, b.n_unique, b.n_duplicate)
    assert a.dedup_factor == b.dedup_factor
    np.testing.assert_array_equal(a.batch_multiplicity(),
                                  b.batch_multiplicity())
    for i in range(a.n_batches):
        np.testing.assert_array_equal(a.batch_inverse(i), b.batch_inverse(i))


@pytest.mark.parametrize("bpr", [64, 1000, 1024, 4096, 8192, 2049])
def test_coalesce_lines_matches_reference(bpr):
    ids = np.random.default_rng(bpr).integers(0, 100_000, 3000)
    assert tsim.coalesce_lines(ids, bpr) == jsim.coalesce_lines(ids, bpr)
    assert tsim.coalesce_lines(ids[:0], bpr) == 0


@pytest.mark.parametrize("counts", [(0, 0, 0, 0), (100, 40, 10, 7),
                                    (3000, 0, 2500, 700), (5, 900, 0, 0)])
def test_merged_burst_and_topology_hop_prices_match_reference(counts):
    n_storage, n_host, n_hbm, lines = counts
    fields = dict(n_requests=n_storage + n_host + n_hbm, bytes_per_row=4096,
                  tier_names=("d", "h", "s"),
                  tier_classes=("hbm", "host", "storage"),
                  tier_counts=(n_hbm, n_host, n_storage),
                  n_storage_lines=lines)
    from repro.core.feature_store import CoalescedReport as JReport
    for n_ssd in (1, 2):
        a = jsim.StorageTimeline(jsim.INTEL_OPTANE, n_ssd)
        b = tsim.StorageTimeline(tsim.INTEL_OPTANE, n_ssd)
        assert a.price_merged_burst(JReport(**fields)) \
            == b.price_merged_burst(CoalescedReport(**fields))
    from repro.core.topology import TopologyGatherReport as JHop
    from repro_torch.core.topology import TopologyGatherReport as THop
    hop = dict(hop=0, n_frontier=n_hbm, n_edge_reads=n_storage,
               pages_by_tier=(n_hbm, n_host, lines),
               reads_by_tier=(n_hbm, n_host, n_storage))
    assert jsim.StorageTimeline(jsim.INTEL_OPTANE).price_topology_hop(
        JHop(**hop)) == tsim.StorageTimeline(
            tsim.INTEL_OPTANE).price_topology_hop(THop(**hop))
    assert jsim.host_sampling_hop_time(n_storage, n_hbm) \
        == tsim.host_sampling_hop_time(n_storage, n_hbm)


# -- the device store's merged step ---------------------------------------------

def test_device_gather_merged_rows_and_metadata():
    """Over several windows under cache pressure: each batch's expanded rows
    equal features[batch nodes] exactly, and the metadata equals one plain
    `cache_device.access` over the window's unique ids."""
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((400, 8))
                             .astype(np.float32))
    store = device_store.init_store(32, 8, ways=4, device="cpu")
    twin = cache_device.init_cache(32, 4, device="cpu")
    for _ in range(6):
        lists = [np.unique(rng.integers(0, 120, 40)) for _ in range(3)]
        merged = tacc.merge_window(lists)
        ids = torch.from_numpy(merged.unique_nodes.astype(np.int32))
        fc = torch.from_numpy(rng.integers(0, 3, merged.n_unique)
                              .astype(np.int32))
        invs = [torch.from_numpy(merged.batch_inverse(i).astype(np.int32))
                for i in range(merged.n_batches)]
        _, rows, hits = device_store.device_gather_merged(
            store, ids, feats[ids.long()], fc, invs)
        want = cache_device.access(twin, ids, fc)
        assert torch.equal(hits, want.hits)
        for lst, r in zip(lists, rows, strict=True):
            assert torch.equal(r, feats[torch.from_numpy(lst)])
        for field in ("tags", "reuse", "hits", "misses", "bypasses"):
            assert torch.equal(getattr(store.cache, field),
                               getattr(twin, field))
        # the row store holds every resident line's own row
        tags = store.cache.tags.reshape(-1)
        live = tags >= 0
        lines = store.cache.slots.reshape(-1)[live].long()
        assert torch.equal(store.rows[lines], feats[tags[live].long()])
    assert int(store.cache.hits) > 0


# -- the loaders side by side ---------------------------------------------------

@pytest.mark.parametrize("merge_execute,topology", PLANES, ids=PLANE_IDS)
def test_loader_matches_reference(merge_execute, topology):
    """At least 3 merged windows (or 12 batches): blocks, every report
    field, prep_time_s, sample_time_s, hop reports and merge depths
    bit-identical; features equal feats[all_nodes]."""
    feats, ref, port = _loaders(merge_execute, topology)
    n_batches = windows = 0
    while windows < 3:
        a, b = ref.next_batch(), port.next_batch()
        n_batches += 1
        if not merge_execute:
            windows = n_batches // 4
        elif not port._merged_ready:
            windows += 1
        np.testing.assert_array_equal(a.blocks.seeds, b.blocks.seeds)
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        for ha, hb in zip(a.blocks.hop_nodes, b.blocks.hop_nodes,
                          strict=True):
            np.testing.assert_array_equal(ha, hb)
        assert a.blocks.num_requests == b.blocks.num_requests
        assert type(a.report).__name__ == type(b.report).__name__
        ra, rb = _report_fields(a.report), _report_fields(b.report)
        for name, value in rb.items():
            assert ra[name] == value, name
        for name in set(ra) - set(rb):     # the sharded fields: unsharded
            assert not ra[name] or ra[name] == 1, name
        assert a.prep_time_s == b.prep_time_s
        assert a.exposed_prep_s == b.exposed_prep_s
        assert a.sample_time_s == b.sample_time_s
        assert a.merge_depth == b.merge_depth
        if topology:
            assert b.sample_time_s > 0
            assert a.blocks.hop_reports == [
                type(a.blocks.hop_reports[0])(**dataclasses.asdict(r))
                for r in b.blocks.hop_reports]
        assert isinstance(b.features, torch.Tensor)
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
    if merge_execute:
        assert not ref._merged_ready
        jplan, tplan = ref.store.last_plan, port.store.last_plan
        np.testing.assert_array_equal(tplan.assignment, jplan.assignment)
    jc = ref.store.tiers[0].store.cache
    tc = port.store.tiers[0].store.cache
    for name in ("tags", "reuse", "hits", "misses", "bypasses"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)),
                                      getattr(tc, name).numpy())
    assert int(tc.hits) > 0


def test_reference_device_gather_fault_shows_on_merged_plane():
    """The reference's `device_gather` fault (ROADMAP.md Queue 3) on these
    planes, 16 batches of this file's configuration: rows that differ from
    feats[all_nodes] — the reference's against the port's, which has
    none."""
    wrong = {}
    for plane in ((True, True), (True, False), (False, False)):
        feats, ref, port = _loaders(*plane)
        counts = [0, 0, 0]
        for _ in range(16):
            a, b = ref.next_batch(), port.next_batch()
            want = feats[a.blocks.all_nodes]
            counts[0] += int((np.asarray(a.features) != want)
                             .any(axis=1).sum())
            counts[1] += int((b.features.numpy() != want).any(axis=1).sum())
            counts[2] += len(want)
        wrong[plane] = tuple(counts)
    assert wrong == {(True, True): (156, 0, 7397), (True, False): (156, 0, 7397),
                     (False, False): (391, 0, 7397)}


def test_merged_sgd_steps_match_reference():
    """Three SGD steps on the merged topology plane's batches: the port's
    GNN from the reference's initial parameters against a reference GNN
    fed feats[all_nodes], per-step losses and final parameters within
    1e-5 (f32)."""
    feats, _, port = _loaders(True, True)
    labels_all = np.random.default_rng(1).integers(0, 5, N).astype(np.int32)
    cfg_kw = dict(model="sage", in_dim=DIM, hidden_dim=32, num_classes=5,
                  fanouts=(4, 3))
    jm = jgnn.GNN(jgnn.GNNConfig(**cfg_kw))
    params = jm.init(jax.random.PRNGKey(0))
    tm = GNN(GNNConfig(**cfg_kw), device="cpu")
    tm.load_reference_params(jax.tree.map(np.asarray, params))
    lr = 0.1
    for _ in range(3):
        b = port.next_batch()
        hi = hop_indices(b.blocks)
        y = labels_all[b.blocks.seeds]
        j_loss, grads = jax.value_and_grad(jm.loss)(
            params, jnp.asarray(feats[b.blocks.all_nodes]),
            [jnp.asarray(i) for i in hi], jnp.asarray(y))
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        t_loss = sgd_step(tm, b.features, [torch.from_numpy(i) for i in hi],
                          torch.from_numpy(y), lr)
        np.testing.assert_allclose(t_loss.item(), float(j_loss),
                                   rtol=1e-5, atol=1e-5)
    for l in range(tm.L):
        for k, p in tm.layer[l].items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[f"layer{l}"][k]),
                                       rtol=1e-5, atol=1e-5)


def test_merged_plane_needs_device_store_on_top():
    """A merged plane with the constant buffer on top and no device tier
    (no longer refused): blocks, reports and priced prep bit-identical to
    the reference, and each batch's rows, expanded on the device from the
    staged unique rows, equal feats[all_nodes].  A merged plane still
    needs overlapped pricing."""
    tiers = DataPlaneSpec.preset("gids-merged").tiers[1:]
    assert [t.kind for t in tiers] == ["constant_buffer", "storage"]
    feats = _feats()
    cfg = {**KW, "window_depth": 0}
    ref = JLoader(jrmat(N, 8, DIM, seed=3), feats, JConfig(
        data_plane=JSpec.preset("gids-merged").with_(
            tiers=JSpec.preset("gids-merged").tiers[1:]), **cfg))
    port = GIDSDataLoader(rmat_graph(N, 8, DIM, seed=3), feats, LoaderConfig(
        data_plane=DataPlaneSpec.preset("gids-merged").with_(tiers=tiers),
        **cfg), device="cpu")
    for _ in range(12):
        a, b = ref.next_batch(), port.next_batch()
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        ra, rb = _report_fields(a.report), _report_fields(b.report)
        for name, value in rb.items():
            assert ra[name] == value, name
        assert (a.prep_time_s, a.merge_depth) == (b.prep_time_s,
                                                  b.merge_depth)
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
    np.testing.assert_array_equal(ref.store.last_plan.assignment,
                                  port.store.last_plan.assignment)
    with pytest.raises(ValueError, match="overlapped"):
        DataPlaneSpec.preset("gids-device", merge_execute=True,
                             pricing="page_fault")
