"""The port's host-side graph, PageRank, constant-buffer and neighbour
sampling code against the JAX package's: all numpy, so bit-identical."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.constant_buffer import ConstantBuffer as JBuffer  # noqa: E402
from repro.graph import pagerank as jpr  # noqa: E402
from repro.graph import synthetic as jsyn  # noqa: E402
from repro.sampling import neighbor as jnb  # noqa: E402
from repro_torch.core.constant_buffer import ConstantBuffer  # noqa: E402
from repro_torch.graph import pagerank, synthetic  # noqa: E402
from repro_torch.graph.csr import from_edge_list, index_dtype  # noqa: E402
from repro_torch.models.gnn import hop_indices  # noqa: E402
from repro_torch.sampling import neighbor  # noqa: E402


@pytest.mark.parametrize("n,deg,seed", [(1000, 8, 2), (3000, 12, 0)])
def test_rmat_graph_and_hot_nodes_identical(n, deg, seed):
    g = synthetic.rmat_graph(n, deg, 16, seed=seed)
    r = jsyn.rmat_graph(n, deg, 16, seed=seed)
    np.testing.assert_array_equal(g.indptr, r.indptr)
    np.testing.assert_array_equal(g.indices, r.indices)
    assert g.indices.dtype == r.indices.dtype
    rev, jrev = g.reverse(), r.reverse()
    np.testing.assert_array_equal(rev.indptr, jrev.indptr)
    np.testing.assert_array_equal(rev.indices, jrev.indices)
    np.testing.assert_array_equal(pagerank.reverse_pagerank(g),
                                  jpr.reverse_pagerank(r))
    np.testing.assert_array_equal(pagerank.hot_nodes(g, 0.1),
                                  jpr.hot_nodes(r, 0.1))


@pytest.mark.parametrize("selection", ["pagerank", "degree", "random"])
def test_constant_buffer_identical(selection):
    g = synthetic.rmat_graph(2000, 8, 4, seed=4)
    r = jsyn.rmat_graph(2000, 8, 4, seed=4)
    port = ConstantBuffer.from_graph(g, 0.1, selection=selection, seed=3)
    ref = JBuffer.from_graph(r, 0.1, selection=selection, seed=3)
    np.testing.assert_array_equal(port.membership, ref.membership)
    ids = np.arange(2000)
    np.testing.assert_array_equal(port.redirect_mask(ids),
                                  ref.redirect_mask(ids))


def test_from_edge_list_dedups_and_sorts():
    src = np.array([2, 0, 2, 1, 0])
    dst = np.array([1, 2, 1, 0, 1])
    g = from_edge_list(src, dst, 3)
    np.testing.assert_array_equal(g.indptr, [0, 2, 3, 4])
    np.testing.assert_array_equal(g.indices, [1, 2, 0, 1])
    assert index_dtype(2 ** 31 - 1) is np.int32
    assert index_dtype(2 ** 31) is np.int64


@pytest.mark.parametrize("fanouts", [(3, 2), (10, 5), (4, 3, 2)])
def test_host_sample_blocks_identical(fanouts):
    g = synthetic.rmat_graph(3000, 8, 4, seed=3)
    r = jsyn.rmat_graph(3000, 8, 4, seed=3)
    rng_p, rng_r = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        seeds = rng_p.integers(0, 3000, 64)
        np.testing.assert_array_equal(seeds, rng_r.integers(0, 3000, 64))
        bp = neighbor.host_sample_blocks(g, seeds, fanouts, rng_p)
        br = jnb.host_sample_blocks(r, seeds, fanouts, rng_r)
        np.testing.assert_array_equal(bp.all_nodes, br.all_nodes)
        assert bp.num_requests == br.num_requests \
            == neighbor.subgraph_sizes(64, fanouts) \
            == jnb.subgraph_sizes(64, fanouts)
        for hp, hr in zip(bp.hop_nodes, br.hop_nodes, strict=True):
            np.testing.assert_array_equal(hp, hr)


def test_hop_indices_roundtrip():
    """Port of test_gnn_e2e.py::test_hop_indices_roundtrip."""
    g = synthetic.rmat_graph(1000, 8, 8, seed=2)
    rng = np.random.default_rng(0)
    blocks = neighbor.host_sample_blocks(g, rng.integers(0, 1000, 16),
                                         (3, 2), rng)
    hi = hop_indices(blocks)
    assert all(h.dtype == np.int32 for h in hi)
    np.testing.assert_array_equal(blocks.all_nodes[hi[0]], blocks.seeds)
    for level, hop in enumerate(blocks.hop_nodes, start=1):
        np.testing.assert_array_equal(blocks.all_nodes[hi[level]], hop)


def test_unported_entry_points_raise():
    """The device CSR and the device sampler, once refused, now run: on
    the CPU when asked for it, and on the card by default, which raises
    here without one instead of falling back."""
    g = synthetic.rmat_graph(100, 4, 4, seed=0)
    d = g.to_device(device="cpu")
    np.testing.assert_array_equal(d.indices.numpy(), g.indices)
    hops, flat = neighbor.device_sample_blocks(
        d, np.arange(4), (2,), torch.Generator().manual_seed(0))
    assert flat.shape == (neighbor.subgraph_sizes(4, (2,)),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            g.to_device()
