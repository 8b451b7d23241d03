"""Loader state on every ported plane, beside the JAX package: the port's
`GIDSDataLoader.state_dict()` equals the reference's after a JSON round
trip, a state of either package resumes a fresh loader of the other, and
the resumed batches equal the reference's resumed loader's in blocks,
reports and priced prep, bit for bit.  Then the port's twins of the
reference's resume tests."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.core.dataplane import DataPlaneSpec as JSpec  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core.dataplane import DataPlaneSpec  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402

N, DIM = 3000, 16
KW = dict(batch_size=64, fanouts=(4, 3), cache_lines=256, cache_ways=4,
          window_depth=4, cbuf_fraction=0.1, seed=9)
COMPUTE_S = 3e-5
#: every ported plane: name -> preset overrides
PLANES = {
    "gids": {}, "gids-async": {}, "bam": {}, "mmap": {}, "pinned-host": {},
    "gids-merged": {}, "gids-merged-async": {}, "gids-topo": {},
    "gids-topo-merged": {}, "gids-device": {},
    "gids-device+merge": dict(merge_execute=True),
    "gids-device+merge+topo": dict(merge_execute=True, topology=True),
}


def _feats():
    return np.random.default_rng(0).standard_normal((N, DIM)) \
        .astype(np.float32)


def _spec(spec_cls, plane):
    name = plane.split("+")[0]
    return spec_cls.preset(name, **PLANES[plane]) if PLANES[plane] else name


def _ref(plane, feats, **kw):
    return JLoader(jrmat(N, 8, DIM, seed=3), feats,
                   JConfig(data_plane=_spec(JSpec, plane), **{**KW, **kw}))


def _port(plane, feats, **kw):
    return GIDSDataLoader(rmat_graph(N, 8, DIM, seed=3), feats,
                          LoaderConfig(data_plane=_spec(DataPlaneSpec, plane),
                                       **{**KW, **kw}), device="cpu")


def _json(state: dict) -> dict:
    return json.loads(json.dumps(state))


def _report(r) -> dict:
    """The port report's fields, read from either package's report."""
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


def _assert_same_batch(want, got, feats):
    """`want` from the reference, `got` from either package: blocks,
    reports, priced prep bit for bit; features are `feats[all_nodes]`."""
    np.testing.assert_array_equal(want.blocks.seeds, got.blocks.seeds)
    for a, b in zip(want.blocks.hop_nodes, got.blocks.hop_nodes,
                    strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want.blocks.all_nodes, got.blocks.all_nodes)
    for name in ("prep_time_s", "exposed_prep_s", "sample_time_s",
                 "merge_depth"):
        assert getattr(want, name) == getattr(got, name), name
    if isinstance(got.features, torch.Tensor):
        assert _report(got.report) == {k: getattr(want.report, k)
                                       for k in _report(got.report)}
        np.testing.assert_array_equal(got.features.numpy(),
                                      feats[got.blocks.all_nodes])
    else:
        assert got.report == want.report
    hr_a = getattr(want.blocks, "hop_reports", [])
    hr_b = getattr(got.blocks, "hop_reports", [])
    assert [(r.pages_by_tier, r.time_s) for r in hr_a] \
        == [(r.pages_by_tier, r.time_s) for r in hr_b]


@pytest.mark.parametrize("plane", PLANES)
def test_states_equal_and_cross_load(plane):
    feats = _feats()
    ref, port = _ref(plane, feats), _port(plane, feats)
    for _ in range(5):      # mid-window on a merged plane (window >= 4)
        a = ref.next_batch(compute_s=COMPUTE_S)
        b = port.next_batch(compute_s=COMPUTE_S)
        _assert_same_batch(a, b, feats)
    j_state, t_state = _json(ref.state_dict()), _json(port.state_dict())
    assert t_state == j_state
    assert set(t_state) == {"rng", "requests_per_iter"}

    ref_resumed = _ref(plane, feats)
    ref_resumed.load_state_dict(j_state)
    port_from_ref = _port(plane, feats)
    port_from_ref.load_state_dict(j_state)
    ref_from_port = _ref(plane, feats)
    ref_from_port.load_state_dict(t_state)
    for _ in range(6):
        want = ref_resumed.next_batch(compute_s=COMPUTE_S)
        _assert_same_batch(want, port_from_ref.next_batch(
            compute_s=COMPUTE_S), feats)
        _assert_same_batch(want, ref_from_port.next_batch(
            compute_s=COMPUTE_S), feats)
    assert _json(port_from_ref.state_dict()) \
        == _json(ref_resumed.state_dict())


def test_state_restores_the_built_row_store_and_cache():
    """Resuming in place drops the cache's metadata, its row store on the
    device, the window, the staged batches and every telemetry EMA back to
    the built state; the next batches rebuild them as a fresh loader
    does."""
    feats = _feats()
    a = _port("gids-async", feats)
    for _ in range(6):
        a.next_batch(compute_s=COMPUTE_S)
    tier = a.store.tiers[0]
    assert tier.rows.abs().sum() > 0 and len(a.prefetch) > 0
    st = a.state_dict()
    a.load_state_dict(st)
    assert tier.rows.abs().sum() == 0
    assert (tier.cache.tags == -1).all() and len(tier.cache.window) == 0
    assert a.store.cache.stats.accesses == 0
    assert len(a.prefetch) == 0 and a.prefetch.stats.staged_batches == 0
    assert a.accumulator.redirect_rate == 0.0
    b = _port("gids-async", feats)
    b.load_state_dict(st)
    for _ in range(4):
        x, y = a.next_batch(compute_s=COMPUTE_S), \
            b.next_batch(compute_s=COMPUTE_S)
        np.testing.assert_array_equal(x.blocks.all_nodes, y.blocks.all_nodes)
        assert torch.equal(x.features, y.features)
        assert torch.equal(tier.rows, b.store.tiers[0].rows)


def test_fault_state_is_refused():
    """A plane without a fault schedule refuses a checkpoint that carries
    fault-plane state, with the reference's error."""
    feats = _feats()
    port = _port("gids", feats)
    st = port.state_dict()
    with pytest.raises(ValueError, match="no fault_schedule"):
        port.load_state_dict({**st, "fault_state": {"injector": {}}})


def test_tier_state_for_a_missing_tier_is_refused():
    feats = _feats()
    port = _port("gids", feats)
    assert port.store.state_dict() == {}
    with pytest.raises(ValueError, match="plane/checkpoint mismatch"):
        port.load_state_dict({**port.state_dict(),
                              "tier_state": {"storage-sharded": {}}})


# -- twins of the reference's resume tests -------------------------------------------

@pytest.fixture(scope="module")
def graph_and_feats():
    g = rmat_graph(20_000, 12, 32, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 32)).astype(np.float32)
    return g, feats


def _mk(g, feats, plane, **kw):
    cfg = dict(batch_size=128, fanouts=(4, 4), data_plane=plane,
               cache_lines=2048, window_depth=4, seed=3)
    return GIDSDataLoader(g, feats, LoaderConfig(**{**cfg, **kw}),
                          device="cpu")


def _assert_batches_identical(a, b):
    np.testing.assert_array_equal(a.blocks.seeds, b.blocks.seeds)
    np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
    assert torch.equal(a.features, b.features)
    assert a.report == b.report
    assert a.prep_time_s == b.prep_time_s


def test_loader_state_resume(graph_and_feats):
    g, feats = graph_and_feats
    kw = dict(batch_size=64, fanouts=(4,), cache_lines=1024, window_depth=2,
              seed=9)
    a = _mk(g, feats, "gids", **kw)
    for _ in range(4):
        a.next_batch()
    st = a.state_dict()
    nxt_a = a.next_batch()
    b = _mk(g, feats, "gids", **kw)
    b.load_state_dict(st)
    nxt_b = b.next_batch()
    np.testing.assert_array_equal(nxt_a.blocks.seeds, nxt_b.blocks.seeds)


def test_resume_resets_telemetry_bit_reproducible(graph_and_feats):
    g, feats = graph_and_feats
    kw = dict(batch_size=64, fanouts=(4,), cache_lines=1024, window_depth=2,
              seed=11)
    a = _mk(g, feats, "gids", **kw)
    for _ in range(6):
        a.next_batch()
    assert a.accumulator.redirect_rate > 0
    st = a.state_dict()
    a.load_state_dict(st)                      # resume in place
    assert a.accumulator.redirect_rate == 0.0
    assert a.store.cache.stats.accesses == 0   # tier state dropped too
    b = _mk(g, feats, "gids", **kw)            # resume on a fresh loader
    b.load_state_dict(st)
    for _ in range(3):
        ba, bb = a.next_batch(), b.next_batch()
        np.testing.assert_array_equal(ba.blocks.seeds, bb.blocks.seeds)
        assert ba.report == bb.report
        assert ba.prep_time_s == bb.prep_time_s


def test_async_resume_bit_identical(graph_and_feats):
    """state_dict taken mid-stream (with batches staged) resumes both a
    fresh async loader and a fresh sync loader to identical sequences."""
    g, feats = graph_and_feats
    src = _mk(g, feats, "gids-async")
    for _ in range(5):
        src.next_batch(compute_s=1e-3)
    st = src.state_dict()
    cont = [src.next_batch() for _ in range(4)]
    fresh_async = _mk(g, feats, "gids-async")
    fresh_async.load_state_dict(st)
    fresh_sync = _mk(g, feats, "gids")
    fresh_sync.load_state_dict(st)
    for expect in cont:
        ra = fresh_async.next_batch()
        rs = fresh_sync.next_batch()
        _assert_batches_identical(ra, rs)
        np.testing.assert_array_equal(expect.blocks.seeds, ra.blocks.seeds)
    # resume drops staged work: a second load from the same state replays
    # the same sequence again (idempotent restore)
    fresh_async.load_state_dict(st)
    assert len(fresh_async.prefetch) == 0
    np.testing.assert_array_equal(fresh_async.next_batch().blocks.seeds,
                                  cont[0].blocks.seeds)


@pytest.mark.parametrize("source", ["gids-merged", "gids-device+merge"])
def test_merged_resume_mid_window(graph_and_feats, source):
    """A checkpoint taken with executed-but-unconsumed batches staged
    resumes bit-identically on merged, per-batch, and async-merged
    loaders (and on the device store's merged plane)."""
    g, feats = graph_and_feats
    src = _mk(g, feats, _spec(DataPlaneSpec, source))
    for _ in range(3):                      # stops mid-window (window >= 4)
        src.next_batch()
    assert len(src._merged_ready) > 0
    st = src.state_dict()
    cont = [src.next_batch() for _ in range(6)]
    for plane in ("gids-merged", "gids", "gids-merged-async", source):
        fresh = _mk(g, feats, _spec(DataPlaneSpec, plane))
        fresh.load_state_dict(st)
        for exp in cont:
            got = fresh.next_batch()
            np.testing.assert_array_equal(exp.blocks.seeds, got.blocks.seeds)
            assert torch.equal(exp.features, got.features)


def test_topo_checkpoint_resume_mid_lookahead(graph_and_feats):
    """A checkpoint taken while sampled-ahead batches sit in the lookahead
    deque resumes with bit-identical blocks, features, and hop reports."""
    g, feats = graph_and_feats
    kw = dict(batch_size=128, fanouts=(5, 5), cache_lines=2048,
              window_depth=4, seed=11)
    a = _mk(g, feats, "gids-topo", **kw)
    for _ in range(4):
        a.next_batch()
    state = a.state_dict()
    assert len(a._lookahead) > 0
    nxt_a = a.next_batch()
    b = _mk(g, feats, "gids-topo", **kw)
    b.load_state_dict(state)
    nxt_b = b.next_batch()
    np.testing.assert_array_equal(nxt_a.blocks.seeds, nxt_b.blocks.seeds)
    np.testing.assert_array_equal(nxt_a.blocks.all_nodes,
                                  nxt_b.blocks.all_nodes)
    assert torch.equal(nxt_a.features, nxt_b.features)
    ra, rb = nxt_a.blocks.hop_reports, nxt_b.blocks.hop_reports
    assert [r.pages_by_tier for r in ra] == [r.pages_by_tier for r in rb]
    assert nxt_a.sample_time_s == nxt_b.sample_time_s


def test_checkpointed_loader_resumes_through_the_checkpoint(tmp_path,
                                                            graph_and_feats):
    """The example's pattern: parameters plus `loader.state_dict()` through
    `train.checkpoint`, restored into a fresh loader: the uninterrupted
    run's blocks and features come next (its warm cache priced them
    differently), and the priced batches of a loader resumed in place."""
    from repro_torch.train import checkpoint as ckpt
    g, feats = graph_and_feats
    a = _mk(g, feats, "gids-async")
    for _ in range(5):
        a.next_batch(compute_s=1e-3)
    ckpt.save(tmp_path, 5, {"w": torch.ones(3)}, {"loader": a.state_dict()})
    cont = [a.next_batch(compute_s=1e-3) for _ in range(3)]
    b = _mk(g, feats, "gids-async")
    _, extra = ckpt.restore(tmp_path, 5, {"w": torch.zeros(3)})
    b.load_state_dict(extra["loader"])
    a.load_state_dict(extra["loader"])
    for exp in cont:
        got = b.next_batch(compute_s=1e-3)
        np.testing.assert_array_equal(exp.blocks.seeds, got.blocks.seeds)
        np.testing.assert_array_equal(exp.blocks.all_nodes,
                                      got.blocks.all_nodes)
        assert torch.equal(exp.features, got.features)
        _assert_batches_identical(a.next_batch(compute_s=1e-3), got)
