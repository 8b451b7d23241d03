"""The port's prefetch engine on the CPU, side by side with the JAX
package's: an async plane delivers the synchronous plane's batches bit for
bit except `exposed_prep_s`, which is max(0, prep - compute); its
telemetry and resume snapshots equal the reference's; a merged async plane
stages whole windows, and every staged batch keeps its own rows."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402

N, DIM = 3000, 16
KW = dict(batch_size=64, fanouts=(4, 3), cache_lines=256, cache_ways=4,
          window_depth=4, cbuf_fraction=0.1)
PAIRS = [("gids", "gids-async"), ("gids-merged", "gids-merged-async")]


def _feats():
    return np.random.default_rng(0).standard_normal((N, DIM)) \
        .astype(np.float32)


def _port(plane, feats):
    return GIDSDataLoader(rmat_graph(N, 8, DIM, seed=3), feats,
                          LoaderConfig(data_plane=plane, **KW), device="cpu")


def _ref(plane, feats):
    return JLoader(jrmat(N, 8, DIM, seed=3), feats,
                   JConfig(data_plane=plane, **KW))


@pytest.mark.parametrize("sync_plane,async_plane", PAIRS)
def test_async_matches_sync_except_exposed(sync_plane, async_plane):
    feats = _feats()
    sync, fast = _port(sync_plane, feats), _port(async_plane, feats)
    compute = 2e-5
    for _ in range(12):
        a, b = sync.next_batch(compute_s=compute), \
            fast.next_batch(compute_s=compute)
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert a.report == b.report
        assert (a.prep_time_s, a.sample_time_s, a.merge_depth) \
            == (b.prep_time_s, b.sample_time_s, b.merge_depth)
        assert a.exposed_prep_s == a.prep_time_s
        assert b.exposed_prep_s == max(0.0, b.prep_time_s - compute)
        assert torch.equal(a.features, b.features)


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0, 2.0])
def test_exposed_is_prep_minus_compute(ratio):
    """The same exposed prep as the reference's at compute = ratio x the
    synchronous plane's steady prep: max(0, prep - compute)."""
    feats = _feats()
    sync = _port("gids", feats)
    prep = float(np.mean([sync.next_batch().prep_time_s
                          for _ in range(6)][2:]))
    compute = ratio * prep
    ref, port = _ref("gids-async", feats), _port("gids-async", feats)
    for _ in range(8):
        a, b = ref.next_batch(compute_s=compute), \
            port.next_batch(compute_s=compute)
        assert b.exposed_prep_s == max(0.0, b.prep_time_s - compute)
        assert (a.prep_time_s, a.exposed_prep_s) == (b.prep_time_s,
                                                     b.exposed_prep_s)
    if ratio >= 2.0:
        assert port.prefetch.stats.hidden_fraction > 0.5


@pytest.mark.parametrize("plane", ["gids-async", "gids-merged-async"])
def test_stats_and_snapshots_match_reference(plane):
    """PrefetchStats, the staged queue length and oldest_snapshot() equal
    the reference's after every batch."""
    feats = _feats()
    ref, port = _ref(plane, feats), _port(plane, feats)
    assert port.prefetch.oldest_snapshot() is None
    for i in range(12):
        ref.next_batch(compute_s=1e-5 * i)
        port.next_batch(compute_s=1e-5 * i)
        assert dataclasses.asdict(ref.prefetch.stats) \
            == dataclasses.asdict(port.prefetch.stats)
        assert len(ref.prefetch) == len(port.prefetch)
        assert ref.prefetch.oldest_snapshot() \
            == port.prefetch.oldest_snapshot()
    assert port.prefetch.stats.hidden_fraction \
        == ref.prefetch.stats.hidden_fraction
    port.prefetch.reset()
    assert len(port.prefetch) == 0 and port.prefetch.stats.staged_batches == 0


def test_merged_async_stages_whole_windows():
    """The first batch stages a whole merged window; each staged batch
    keeps its own rows while later batches are staged and their fills land
    in the row store."""
    feats = _feats()
    loader = _port("gids-merged-async", feats)
    first = loader.next_batch()
    window = first.merge_depth
    assert window > loader.prefetch.depth
    assert loader.prefetch.stats.staged_batches == window
    assert len(loader.prefetch) == window - 1
    batches = [first]
    while loader.prefetch.stats.staged_batches < 3 * window:
        batches.append(loader.next_batch())
    assert loader.prefetch.stats.staged_batches == 3 * window
    for b in batches:
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
