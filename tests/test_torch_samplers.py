"""The port's other samplers beside the JAX package's: LADIES bit for bit
(alone and through the loader), `uniform_graph`, the device sampler held
by property and, fed the reference the port's own uniform draws (a torch
generator's, which `jax.random` cannot make), bit for bit; and the fig7
priced headline keys of BENCH_pr10.json recomputed through the port's
topology store."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.graph import csr as jcsr  # noqa: E402
from repro.graph import synthetic as jsynthetic  # noqa: E402
from repro.sampling import ladies as jladies  # noqa: E402
from repro.sampling import neighbor as jneighbor  # noqa: E402
from repro_torch.core import (INTEL_OPTANE, GIDSDataLoader,  # noqa: E402
                              LoaderConfig, TieredTopologyStore,
                              host_sampling_time)
from repro_torch.graph import csr, synthetic  # noqa: E402
from repro_torch.sampling import ladies, neighbor  # noqa: E402

BENCH = json.loads((Path(__file__).resolve().parents[1]
                    / "BENCH_pr10.json").read_text())


def _assert_blocks_equal(a, b):
    np.testing.assert_array_equal(a.seeds, b.seeds)
    assert len(a.hop_nodes) == len(b.hop_nodes)
    for ha, hb in zip(a.hop_nodes, b.hop_nodes):
        assert ha.dtype == hb.dtype
        np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(a.all_nodes, b.all_nodes)
    assert a.num_requests == b.num_requests


# -- LADIES -----------------------------------------------------------------------

def _islands(n=60):
    """Nodes 0-9 have no out-edges; 10-19 point only at 20-22 (three
    candidates); the rest form an RMAT-ish tangle."""
    rng = np.random.default_rng(4)
    src = [np.repeat(np.arange(10, 20), 3), rng.integers(20, n, 300)]
    dst = [np.tile(np.arange(20, 23), 10), rng.integers(0, n, 300)]
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    return (jcsr.from_edge_list(src[keep], dst[keep], n),
            csr.from_edge_list(src[keep], dst[keep], n))


@pytest.mark.parametrize("case", [
    "rmat", "rmat-repeated-seeds", "degree-0-frontier",
    "fewer-candidates", "uniform"])
def test_ladies_blocks_identical(case):
    """Same graph, seeds and RNG state: the same blocks and the same RNG
    state after, bit for bit, including an isolated frontier (uniform
    fall-back) and fewer candidates than the layer size (take all, pad)."""
    sizes = (64, 32)
    if case in ("degree-0-frontier", "fewer-candidates"):
        jg, tg = _islands()
        seeds = (np.arange(10) if case == "degree-0-frontier"
                 else np.arange(10, 20))
        sizes = (8, 5)
    elif case == "uniform":
        jg = jsynthetic.uniform_graph(800, 5, 0, seed=2)
        tg = synthetic.uniform_graph(800, 5, 0, seed=2)
        seeds = np.random.default_rng(1).integers(0, 800, 24)
    else:
        jg = jsynthetic.rmat_graph(2000, 8, 0, seed=3)
        tg = synthetic.rmat_graph(2000, 8, 0, seed=3)
        seeds = np.random.default_rng(1).choice(2000, 24, replace=False)
        if case == "rmat-repeated-seeds":
            seeds = np.concatenate([seeds, seeds[:8]])
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    a = jladies.ladies_sample_blocks(jg, seeds, sizes, ra)
    b = ladies.ladies_sample_blocks(tg, seeds, sizes, rb)
    _assert_blocks_equal(a, b)
    assert ra.bit_generator.state == rb.bit_generator.state
    assert b.num_requests == len(seeds) + sum(sizes)
    if case == "fewer-candidates":
        np.testing.assert_array_equal(b.hop_nodes[0][:3], [20, 21, 22])


def test_ladies_counts_a_repeated_neighbour_once_per_row():
    """A node listed twice in one adjacency row gets one 1/deg^2 share, as
    in the reference's buffered `probs[nbrs] += ...`."""
    g = csr.CSRGraph(indptr=np.array([0, 3, 3, 3], np.int64),
                     indices=np.array([1, 1, 2], np.int32), num_nodes=3)
    seen = set()
    for s in range(40):
        b = ladies.ladies_sample_blocks(g, np.array([0]), (1,),
                                        np.random.default_rng(s))
        seen.add(int(b.hop_nodes[0][0]))
        jb = jladies.ladies_sample_blocks(g, np.array([0]), (1,),
                                          np.random.default_rng(s))
        np.testing.assert_array_equal(b.hop_nodes[0], jb.hop_nodes[0])
    assert seen == {1, 2}


@pytest.mark.parametrize("plane", ["gids", "gids-async", "gids-merged",
                                   "gids-device"])
def test_ladies_sampler_end_to_end_parity(plane):
    """sampler="ladies" through the port's loader: the first batch is
    exactly the reference's `ladies_sample_blocks` on the loader's own RNG
    stream, features are `feats[all_nodes]`, telemetry partitions the
    requests, and later batches equal the reference loader's in blocks,
    tier counts and priced prep."""
    n, dim = 3000, 8
    feats = np.random.default_rng(0).standard_normal((n, dim)) \
        .astype(np.float32)
    kw = dict(batch_size=32, sampler="ladies", ladies_layer_sizes=(64, 32),
              data_plane=plane, cache_lines=1024, window_depth=2, seed=5)
    port = GIDSDataLoader(synthetic.rmat_graph(n, 8, dim, seed=1), feats,
                          LoaderConfig(**kw), device="cpu")
    ref = JLoader(jsynthetic.rmat_graph(n, 8, dim, seed=1), feats,
                  JConfig(**kw))
    b = port.next_batch(compute_s=1e-5)
    rng = np.random.default_rng(5)
    seeds = rng.choice(np.arange(n), size=32, replace=False)
    want = jladies.ladies_sample_blocks(port.graph, seeds, (64, 32), rng)
    _assert_blocks_equal(b.blocks, want)
    np.testing.assert_array_equal(b.features.numpy(), feats[want.all_nodes])
    assert b.blocks.num_requests == 32 + 64 + 32
    r = b.report
    assert r.n_hbm_hits + r.n_host_hits + r.n_storage == r.n_requests
    assert b.prep_time_s > 0
    a = ref.next_batch(compute_s=1e-5)
    for _ in range(4):
        a, b = ref.next_batch(compute_s=1e-5), port.next_batch(compute_s=1e-5)
        _assert_blocks_equal(a.blocks, b.blocks)
        assert a.report.tier_counts == b.report.tier_counts
        assert (a.prep_time_s, a.exposed_prep_s) == (b.prep_time_s,
                                                     b.exposed_prep_s)
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])


def test_ladies_on_a_topology_plane_is_refused_as_in_the_reference():
    """A topology plane prices page-local adjacency reads, which LADIES
    does not make: both packages refuse the pair when the loader is built,
    with the same message."""
    n = 500
    feats = np.zeros((n, 4), np.float32)
    for plane in ("gids-topo", "gids-topo-merged"):
        kw = dict(batch_size=16, sampler="ladies", ladies_layer_sizes=(32,),
                  data_plane=plane, cache_lines=256, window_depth=2)
        with pytest.raises(ValueError) as ref_err:
            JLoader(jsynthetic.rmat_graph(n, 8, 4, seed=1), feats,
                    JConfig(**kw))
        with pytest.raises(ValueError) as port_err:
            GIDSDataLoader(synthetic.rmat_graph(n, 8, 4, seed=1), feats,
                           LoaderConfig(**kw), device="cpu")
        assert str(port_err.value) == str(ref_err.value)
        assert "requires the 'neighbor' sampler" in str(port_err.value)


def test_loader_config_matches_the_reference():
    assert LoaderConfig().ladies_layer_sizes == JConfig().ladies_layer_sizes
    with pytest.raises(ValueError, match="unknown sampler"):
        LoaderConfig(sampler="graphsaint")
    assert LoaderConfig().data_plane == "gids"
    assert LoaderConfig(sampler="ladies").sampler == "ladies"


# -- uniform_graph ----------------------------------------------------------------

@pytest.mark.parametrize("n,deg,seed", [(500, 4, 0), (3000, 12, 1)])
def test_uniform_graph_identical(n, deg, seed):
    a = jsynthetic.uniform_graph(n, deg, 16, seed=seed)
    b = synthetic.uniform_graph(n, deg, 16, seed=seed)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indices.dtype == b.indices.dtype
    assert (a.num_nodes, a.feature_dim, a.name) == (b.num_nodes,
                                                    b.feature_dim, b.name)


# -- the device sampler, by property ------------------------------------------------

def _edge_keys(g):
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees())
    return np.sort(src * g.num_nodes + g.indices.astype(np.int64))


def _assert_neighbour_or_self(g, seeds, fanouts, hops):
    """Every sampled id is an out-neighbour of its destination, or the
    destination itself where its degree is 0."""
    keys = _edge_keys(g)
    deg = g.degrees()
    frontier = np.asarray(seeds, np.int64)
    for f, hop in zip(fanouts, hops):
        nbr = np.asarray(hop, np.int64)
        dst = np.repeat(frontier, f)
        key = dst * g.num_nodes + nbr
        pos = np.minimum(np.searchsorted(keys, key), len(keys) - 1)
        is_edge = keys[pos] == key
        ok = np.where(deg[dst] > 0, is_edge, nbr == dst)
        assert ok.all(), int((~ok).sum())
        frontier = nbr


@pytest.mark.parametrize("fanouts", [(3,), (10, 5), (4, 3, 2)])
def test_device_sampler_properties(fanouts):
    g = synthetic.rmat_graph(3000, 6, 0, seed=2)
    assert (g.degrees() == 0).any()          # self-loops get exercised
    dcsr = g.to_device(device="cpu")
    assert dcsr.indptr.dtype == dcsr.indices.dtype == torch.int32
    seeds = np.random.default_rng(0).integers(0, g.num_nodes, 64)
    gen = torch.Generator(device="cpu").manual_seed(0)
    hops, flat = neighbor.device_sample_blocks(dcsr, seeds, fanouts, gen)
    n = 64
    for f, hop in zip(fanouts, hops):
        n *= f
        assert hop.shape == (n,) and hop.dtype == torch.int32
    assert flat.shape == (neighbor.subgraph_sizes(64, fanouts),)
    assert flat.dtype == torch.int32
    np.testing.assert_array_equal(flat[:64].numpy(), seeds)
    np.testing.assert_array_equal(flat[64:].numpy(),
                                  torch.cat(hops).numpy())
    _assert_neighbour_or_self(g, seeds, fanouts, [h.numpy() for h in hops])
    # the reference's sampler makes the same shapes and dtypes, and holds
    # the same property, on the same graph and seeds
    jhops, jflat = jneighbor.device_sample_blocks(
        jcsr.CSRGraph(g.indptr, g.indices, g.num_nodes).to_device(),
        jnp.asarray(seeds, jnp.int32), fanouts, jax.random.PRNGKey(0))
    assert [h.shape for h in jhops] == [tuple(h.shape) for h in hops]
    assert jflat.shape == tuple(flat.shape)
    assert str(jflat.dtype) == "int32"
    _assert_neighbour_or_self(g, seeds, fanouts,
                              [np.asarray(h) for h in jhops])


@pytest.mark.parametrize("fanouts,seed", [((3,), 0), ((10, 5), 1),
                                           ((4, 3, 2), 2)])
def test_device_sampler_matches_reference_given_the_same_draws(
        monkeypatch, fanouts, seed):
    """The reference's arithmetic, fed the port's uniform draws in place of
    `jax.random.uniform`'s, samples the port's hops and flat ids bit for
    bit, self-loops of degree-0 nodes included."""
    g = synthetic.rmat_graph(3000, 6, 0, seed=2)
    assert (g.degrees() == 0).any()
    seeds = np.random.default_rng(seed).integers(0, g.num_nodes, 64)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    hops, flat = neighbor.device_sample_blocks(
        g.to_device(device="cpu"), seeds, fanouts, gen)
    # the same draws again: one torch.rand per hop from the same seed
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n, draws = 64, []
    for f in fanouts:
        draws.append(torch.rand((n, f), generator=gen).numpy())
        n *= f

    def uniform(key, shape):
        r = draws.pop(0)
        assert tuple(shape) == r.shape
        return jnp.asarray(r)

    monkeypatch.setattr(jneighbor.jax.random, "uniform", uniform)
    jhops, jflat = jneighbor.device_sample_blocks(
        jcsr.CSRGraph(g.indptr, g.indices, g.num_nodes).to_device(),
        jnp.asarray(seeds, jnp.int32), fanouts, jax.random.PRNGKey(0))
    assert not draws
    for h, jh in zip(hops, jhops, strict=True):
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))


def test_device_sampler_draws_depend_only_on_the_seed():
    g = synthetic.rmat_graph(2000, 8, 0, seed=1)
    dcsr = g.to_device(device="cpu")
    seeds = torch.arange(0, 2000, 37)

    def run(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return neighbor.device_sample_blocks(dcsr, seeds, (5, 3), gen)[1]

    a = run(11)
    torch.manual_seed(123)                   # the global RNG plays no part
    torch.rand(1000)
    np.random.default_rng(5).random(10)
    assert torch.equal(run(11), a)
    assert not torch.equal(run(12), a)
    # one generator, two calls: the offset advances, the draws differ
    gen = torch.Generator(device="cpu").manual_seed(11)
    first = neighbor.device_sample_blocks(dcsr, seeds, (5, 3), gen)[1]
    second = neighbor.device_sample_blocks(dcsr, seeds, (5, 3), gen)[1]
    assert torch.equal(first, a) and not torch.equal(second, a)


def test_device_index_dtype_and_to_device():
    assert csr.device_index_dtype(100, 2 ** 31 - 1) is torch.int32
    assert csr.device_index_dtype(2 ** 31, 10) is torch.int64
    assert csr.device_index_dtype(10, 2 ** 31) is torch.int64
    g = synthetic.rmat_graph(300, 4, 0, seed=0)
    d = g.to_device(device="cpu")
    assert isinstance(d, csr.DeviceCSR) and d.num_nodes == 300
    np.testing.assert_array_equal(d.indptr.numpy(), g.indptr)
    np.testing.assert_array_equal(d.indices.numpy(), g.indices)
    j = jcsr.CSRGraph(g.indptr, g.indices, g.num_nodes).to_device()
    assert str(j.indptr.dtype) == str(d.indptr.dtype).removeprefix("torch.")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            g.to_device()


def test_device_sampler_int64_graph_ids():
    """A DeviceCSR handed int64 tensors samples the same ids as the int32
    one: the ids take `device_index_dtype` of the graph's size, whatever
    the dtype of the tensors."""
    g = synthetic.rmat_graph(500, 6, 0, seed=3)
    d32 = g.to_device(device="cpu")
    d64 = csr.DeviceCSR(d32.indptr.long(), d32.indices.long(), g.num_nodes)
    seeds = torch.arange(40)
    gen = torch.Generator().manual_seed(1)
    h32, f32 = neighbor.device_sample_blocks(d32, seeds, (4, 2), gen)
    gen = torch.Generator().manual_seed(1)
    h64, f64 = neighbor.device_sample_blocks(d64, seeds, (4, 2), gen)
    # the dtype follows the graph's size, not the tensors handed in
    assert f32.dtype == f64.dtype == torch.int32
    assert torch.equal(f32, f64)


# -- fig7's priced headline keys --------------------------------------------------

GPU_BUDGET_SWEEP = (0.0, 0.1, 0.25, 0.5, 1.0)


def _sample_hops(g, batch, fanouts, seed=0):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, g.num_nodes, batch)
    hops = []
    neighbor.run_sample_hops(g, seeds, fanouts, rng,
                             hop_cb=lambda hop, pos, nf: hops.append((pos,
                                                                      nf)))
    return hops


def _price(g, hops, gpu_fraction):
    topo = TieredTopologyStore.from_graph(
        g, admission="degree", gpu_fraction=gpu_fraction, host_fraction=0.5,
        ssd=INTEL_OPTANE, device="cpu")
    return [topo.hop_report(pos, hop=i, n_frontier=nf)
            for i, (pos, nf) in enumerate(hops)]


@pytest.fixture(scope="module")
def fig7():
    """benchmarks/fig7_sampling.py `headline()` through the port."""
    out = {}
    skewed_g = synthetic.rmat_graph(50_000, 12, 0, seed=1)
    uniform_g = synthetic.uniform_graph(50_000, 12, 0, seed=1)
    skewed_hops = _sample_hops(skewed_g, 4096, (10, 5))
    for tag, g, hops in (
            ("skewed", skewed_g, skewed_hops),
            ("uniform", uniform_g, _sample_hops(uniform_g, 4096, (10, 5)))):
        reports = _price(g, hops, 0.25)
        t_host = host_sampling_time(reports)
        t_tiered = sum(r.time_s for r in reports)
        out[f"{tag}_host_sample_us"] = t_host * 1e6
        out[f"{tag}_tiered_sample_us"] = t_tiered * 1e6
        out[f"{tag}_sample_speedup_tiered_vs_host"] = t_host / t_tiered
        last = reports[-1]
        out[f"{tag}_last_hop_pages_hbm"] = last.pages_by_tier[0]
        out[f"{tag}_last_hop_pages_host"] = last.pages_by_tier[1]
        out[f"{tag}_last_hop_pages_storage"] = last.pages_by_tier[2]
        out[f"{tag}_last_hop_coalesce_factor"] = last.coalesce_factor
    for f in GPU_BUDGET_SWEEP:
        out[f"tiered_sample_us_gpu{f:g}"] = sum(
            r.time_s for r in _price(skewed_g, skewed_hops, f)) * 1e6
    out["sample_speedup_tiered_vs_host"] = \
        out["skewed_sample_speedup_tiered_vs_host"]
    return out


@pytest.mark.parametrize("key", sorted(BENCH["fig7_sampling"]))
def test_fig7_headline_key(fig7, key):
    assert fig7[key] == BENCH["fig7_sampling"][key]


def test_fig7_budget_sweep_is_monotone(fig7):
    times = [fig7[f"tiered_sample_us_gpu{f:g}"] for f in GPU_BUDGET_SWEEP]
    assert all(b <= a * 1.0001 + 1e-12 for a, b in zip(times, times[1:]))
