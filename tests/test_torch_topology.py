"""The port's topology plane (repro_torch.core.topology, sampling/tiered.py)
against the JAX package's on the CPU: admission, page slots and scores,
per-hop reports and priced times, the tiered sampler's blocks, and the
device data path `frontier_gather` (plain version on CPU tensors) against
`graph.indices[pos]` and the Pallas kernel in interpret mode."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import topology as jtopo  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro.sampling.tiered import tiered_sample_blocks as jtiered  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.sampling.neighbor import host_sample_blocks  # noqa: E402
from repro_torch.sampling.tiered import tiered_sample_blocks  # noqa: E402

ADMISSIONS = ["degree", "range", "random"]
BUDGETS = [(0.25, 0.5), (0.3, 0.3), (0.0, 0.5), (1.0, 0.0)]


@pytest.fixture(scope="module")
def graphs():
    return jrmat(20_000, 12, 32, seed=1), rmat_graph(20_000, 12, 32, seed=1)


def _stores(graphs, admission, gpu, host, seed=0):
    jg, tg = graphs
    kw = dict(admission=admission, gpu_fraction=gpu, host_fraction=host,
              seed=seed)
    return (jtopo.TieredTopologyStore.from_graph(jg, **kw),
            ttopo.TieredTopologyStore.from_graph(tg, device="cpu", **kw))


@pytest.mark.parametrize("gpu,host", BUDGETS)
@pytest.mark.parametrize("admission", ADMISSIONS)
def test_from_graph_matches_reference(graphs, admission, gpu, host):
    a, b = _stores(graphs, admission, gpu, host, seed=7)
    np.testing.assert_array_equal(a.assignment, b.assignment)
    np.testing.assert_array_equal(a.page_slot, b.page_slot)
    assert (a.page_words, a.n_pages) == (b.page_words, b.n_pages)
    assert a.tier_pages() == b.tier_pages()
    assert a.tier_bytes() == b.tier_bytes()
    assert jtopo.admission_names() == tuple(
        sorted((*ttopo.admission_names(), "adaptive")))


def test_page_scores_match_reference(graphs):
    jg, tg = graphs
    for words in (1024, 512, 7):
        np.testing.assert_array_equal(
            jtopo.page_scores(jg.indptr, jg.indices, words),
            ttopo.page_scores(tg.indptr, tg.indices, words))


@pytest.mark.parametrize("admission", ADMISSIONS)
def test_hop_report_matches_reference(graphs, admission):
    """Every field, the priced time_s included, bit for bit, on empty,
    small and large hops."""
    a, b = _stores(graphs, admission, 0.25, 0.5)
    rng = np.random.default_rng(5)
    E = graphs[0].num_edges
    for n in (0, 1, 37, 3000, 15000):
        pos = rng.integers(0, E, n)
        ra = a.hop_report(pos, hop=n % 2, n_frontier=n // 3)
        rb = b.hop_report(pos, hop=n % 2, n_frontier=n // 3)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
        assert (ra.n_pages, ra.n_storage_ios, ra.coalesce_factor) \
            == (rb.n_pages, rb.n_storage_ios, rb.coalesce_factor)
    assert jtopo.host_sampling_time([ra]) == ttopo.host_sampling_time([rb])


@pytest.mark.parametrize("gpu,host", BUDGETS)
def test_frontier_gather_equals_adjacency(graphs, gpu, host):
    """The CPU data path equals graph.indices[pos] exactly, for any budget
    (zero-budget stores included) and any position shape, and equals the
    reference's Pallas path; a CPU store launches no kernel."""
    a, b = _stores(graphs, "degree", gpu, host)
    tg = graphs[1]
    pos = np.random.default_rng(6).integers(0, tg.num_edges, 4096)
    before = dict(_build.LAUNCHES)
    out = b.frontier_gather(pos)
    assert out.dtype == tg.indices.dtype
    np.testing.assert_array_equal(out, tg.indices[pos])
    np.testing.assert_array_equal(out, a.frontier_gather(pos))
    grid = pos[:600].reshape(30, 20)
    np.testing.assert_array_equal(b.frontier_gather(grid), tg.indices[grid])
    assert b.frontier_gather(pos[:0]).shape == (0,)
    assert _build.LAUNCHES == before
    hot = b.hot_pages()
    assert hot.shape == (max(b.tier_pages()[0], 1), b.page_words)
    assert hot is b.hot_pages()                       # uploaded once


@pytest.mark.parametrize("admission", ADMISSIONS)
def test_tiered_sample_blocks_match_reference(graphs, admission):
    """Blocks, hop reports and sample_time_s bit-identical to the
    reference's tiered sampler, and blocks to the port's host sampler, with
    the RNG streams in lockstep."""
    a, b = _stores(graphs, admission, 0.25, 0.5)
    jg, tg = graphs
    for fanouts in ((5, 3), (10, 5), (2, 2, 2)):
        seeds = np.random.default_rng(3).choice(tg.num_nodes, 256,
                                                replace=False)
        rngs = [np.random.default_rng(9) for _ in range(3)]
        ba = jtiered(jg, a, seeds, fanouts, rngs[0])
        bb = tiered_sample_blocks(tg, b, seeds, fanouts, rngs[1])
        bh = host_sample_blocks(tg, seeds, fanouts, rngs[2])
        for ref in (ba, bh):
            for x, y in zip(ref.hop_nodes, bb.hop_nodes, strict=True):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(ref.all_nodes, bb.all_nodes)
            assert ref.num_requests == bb.num_requests
        assert [dataclasses.asdict(r) for r in ba.hop_reports] \
            == [dataclasses.asdict(r) for r in bb.hop_reports]
        assert ba.sample_time_s == bb.sample_time_s > 0
        assert rngs[0].bit_generator.state == rngs[1].bit_generator.state \
            == rngs[2].bit_generator.state


def test_unported_topology_options_raise(graphs):
    tg = graphs[1]
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        ttopo.TieredTopologyStore.from_graph(tg, admission="adaptive",
                                             device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        ttopo.TieredTopologyStore.from_graph(tg, n_shards=2, device="cpu")
    with pytest.raises(KeyError):
        ttopo.make_admission("no-such-policy", 4, gpu_pages=1, host_pages=1)
