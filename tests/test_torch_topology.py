"""The port's topology plane (repro_torch.core.topology, sampling/tiered.py)
against the JAX package's on the CPU: admission, page slots and scores,
per-hop reports and priced times, the tiered sampler's blocks, and the
device data path `frontier_gather` (plain version on CPU tensors) against
`graph.indices[pos]` and the Pallas kernel in interpret mode."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import topology as jtopo  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.sampling.tiered import tiered_sample_blocks as jtiered  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.sampling.neighbor import host_sample_blocks  # noqa: E402
from repro_torch.sampling.tiered import tiered_sample_blocks  # noqa: E402

ADMISSIONS = ["degree", "range", "random", "adaptive"]
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
    assert jtopo.admission_names() == ttopo.admission_names()


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
    (zero-budget stores included) and any position shape, the last edge
    position included, and equals the reference's Pallas path; a CPU store
    launches no kernel and pins nothing."""
    a, b = _stores(graphs, "degree", gpu, host)
    tg = graphs[1]
    pos = np.random.default_rng(6).integers(0, tg.num_edges, 4096)
    pos[-1] = tg.num_edges - 1
    before = dict(_build.LAUNCHES)
    out = b.frontier_gather(pos)
    assert out.dtype == tg.indices.dtype
    np.testing.assert_array_equal(out, tg.indices[pos])
    np.testing.assert_array_equal(out, a.frontier_gather(pos))
    grid = pos[:600].reshape(30, 20)
    np.testing.assert_array_equal(b.frontier_gather(grid), tg.indices[grid])
    assert b.frontier_gather(pos[:0]).shape == (0,)
    with pytest.raises(IndexError):
        b.frontier_gather(np.array([tg.num_edges]))
    assert _build.LAUNCHES == before
    assert not b.host_words().is_pinned() and b._io == ()
    hot = b.hot_pages()
    assert hot.shape == (max(b.tier_pages()[0], 1), b.page_words)
    assert hot is b.hot_pages()                       # uploaded once


@pytest.mark.parametrize("gpu,host", BUDGETS)
def test_page_table_and_cold_mirror_match_reference(graphs, gpu, host):
    """The page table is the reference's page slots (-1 off the hot tier),
    the hot pages are the reference's, and cold words are read from the
    adjacency itself, so every non-resident page's words sit at their own
    positions."""
    a, b = _stores(graphs, "degree", gpu, host)
    np.testing.assert_array_equal(b.page_table.numpy(), a.page_slot)
    np.testing.assert_array_equal(b.hot_pages().numpy(),
                                  np.asarray(a.hot_pages()))
    cold = np.nonzero(a.page_slot < 0)[0]
    words = b.host_words().numpy()
    np.testing.assert_array_equal(words, graphs[1].indices)
    if len(cold):
        np.testing.assert_array_equal(
            words[np.minimum(cold[:, None] * b.page_words
                             + np.arange(b.page_words), len(words) - 1)],
            a._page_rows(cold))


@pytest.mark.parametrize("words,page_bytes", [(np.int32, 4096),
                                              (np.int64, 4096),
                                              (np.int32, 2048)])
@pytest.mark.parametrize("gpu,host", [(0.25, 0.5), (1.0, 0.0), (0.0, 0.5)])
def test_frontier_read_ref_matches_reference_store(graphs, gpu, host, words,
                                                   page_bytes):
    """`ref.frontier_read_ref` over the port store's page table, hot pages
    and host adjacency is exact against the JAX package's
    `ops.tiered_frontier_gather` (Pallas in interpret mode, and its oracle)
    fed the slots, staged pages, inverse and offsets the reference store
    builds from the same seeded positions: int32 and int64 words, 1024- and
    512-word pages, mixed, all-hot and zero-budget stores, the last edge
    position (tail page) and an empty input."""
    jg, tg = (dataclasses.replace(g, indices=g.indices.astype(words))
              for g in graphs)
    kw = dict(gpu_fraction=gpu, host_fraction=host, page_bytes=page_bytes)
    a = jtopo.TieredTopologyStore.from_graph(jg, **kw)
    b = ttopo.TieredTopologyStore.from_graph(tg, device="cpu", **kw)
    pos = np.random.default_rng(8).integers(0, tg.num_edges, 1500)
    pos[-1] = tg.num_edges - 1
    W = a.page_words
    pages, inverse = np.unique(pos // W, return_inverse=True)
    slots = a.page_slot[pages]
    staged = np.zeros((len(pages), W), jg.indices.dtype)
    staged[slots < 0] = a._page_rows(pages[slots < 0])
    jargs = (jnp.asarray(slots), a.hot_pages(), jnp.asarray(staged),
             jnp.asarray(inverse.astype(np.int32)),
             jnp.asarray((pos % W).astype(np.int32)))
    args = (b.page_table, b.hot_pages(), b.host_words())
    out = ref.frontier_read_ref(torch.from_numpy(pos), *args)
    assert out.dtype == torch.from_numpy(tg.indices[:0]).dtype
    np.testing.assert_array_equal(out.numpy(), tg.indices[pos])
    for use_pallas in (True, False):
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jops.tiered_frontier_gather(
                *jargs, use_pallas=use_pallas)))
    assert ref.frontier_read_ref(torch.zeros(0, dtype=torch.int64),
                                 *args).shape == (0,)


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
    """The adaptive admission and the sharded page queues are ported: both
    build the reference's store (with its touch table and page shards);
    an unknown admission still raises."""
    jg, tg = graphs
    for kw in (dict(admission="adaptive"), dict(n_shards=2),
               dict(admission="adaptive", n_shards=3, placement="degree")):
        a = jtopo.TieredTopologyStore.from_graph(jg, **kw)
        b = ttopo.TieredTopologyStore.from_graph(tg, device="cpu", **kw)
        np.testing.assert_array_equal(a.assignment, b.assignment)
        np.testing.assert_array_equal(a.page_shard, b.page_shard)
        assert a.n_shards == b.n_shards
        assert (a.touches is None) == (b.touches is None)
    with pytest.raises(KeyError):
        ttopo.make_admission("no-such-policy", 4, gpu_pages=1, host_pages=1)
