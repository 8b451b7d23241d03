"""The port's device-resident cache (repro_torch.core.cache_device) and row
store (repro_torch.core.device_store) against the JAX package's cache_jax
and device_store, on CPU tensors: the metadata bit for bit, the rows equal
to the features of the requested ids."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cache_jax  # noqa: E402
from repro.core import device_store as jds  # noqa: E402
from repro_torch.core import cache_device  # noqa: E402
from repro_torch.core import device_store as tds  # noqa: E402


def _state_equal(jstate, tstate):
    for name in ("tags", "reuse", "slots", "hits", "misses", "bypasses"):
        np.testing.assert_array_equal(np.asarray(getattr(jstate, name)),
                                      getattr(tstate, name).numpy(),
                                      err_msg=name)


def test_set_hash_matches_uint32_wrapping_multiply():
    """The int64 split multiply equals the reference's uint32 arithmetic,
    for -1 pads and for ids at and past 2^31."""
    ids = np.array([-1, 0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
                    2 ** 40 + 12345, 987654321], np.int64)
    for num_sets in (1, 3, 2048, 4096):
        with np.errstate(over="ignore"):
            h = (ids.astype(np.uint32) * np.uint32(0x9E3779B9)) \
                >> np.uint32(8)
        want = (h % np.uint32(num_sets)).astype(np.int32)
        got = cache_device._set_of(torch.from_numpy(ids), num_sets).numpy()
        np.testing.assert_array_equal(got, want)
        small = ids[(ids >= -1) & (ids < 2 ** 31)].astype(np.int32)
        np.testing.assert_array_equal(
            cache_device._set_of(torch.from_numpy(small), num_sets).numpy(),
            np.asarray(cache_jax._set_of(jnp.asarray(small), num_sets)))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ways,num_sets", [(1, 4), (2, 8), (4, 4), (8, 2)])
def test_access_and_push_window_bit_exact(ways, num_sets, seed):
    """A seeded run of push_window and access calls with duplicate ids, -1
    pads and future counts: hits, slots, tags, reuse and the three counters
    equal cache_jax's after every call."""
    rng = np.random.default_rng(seed * 31 + ways)
    lines = ways * num_sets
    jstate = cache_jax.init_cache(lines, ways)
    tstate = cache_device.init_cache(lines, ways, device="cpu")
    pool = 3 * lines
    B = 3 * lines        # one shape per geometry: cache_jax compiles once
    for _ in range(5):
        window = np.full(2 * lines, -1, np.int32)
        uniq = np.unique(rng.integers(0, pool, rng.integers(1, 2 * lines)))
        window[:len(uniq)] = uniq
        jstate = cache_jax.push_window(jstate, jnp.asarray(window))
        cache_device.push_window(tstate, torch.from_numpy(window))
        _state_equal(jstate, tstate)

        ids = rng.integers(0, pool, B).astype(np.int32)      # duplicates
        ids[rng.random(B) < 0.15] = -1                       # padding
        fc = rng.integers(0, 4, B).astype(np.int32)
        jstate, jhits, jslots = cache_jax.access(jstate, jnp.asarray(ids),
                                                 jnp.asarray(fc))
        res = cache_device.access(tstate, torch.from_numpy(ids),
                                  torch.from_numpy(fc))
        np.testing.assert_array_equal(res.hits.numpy(), np.asarray(jhits))
        np.testing.assert_array_equal(res.slots.numpy(), np.asarray(jslots))
        _state_equal(jstate, tstate)


def _check_rows(store, feats):
    """Row-store invariant: every resident line holds its tag's row."""
    tags = store.cache.tags.numpy().reshape(-1)
    slots = store.cache.slots.numpy().reshape(-1)
    resident = tags >= 0
    np.testing.assert_array_equal(store.rows.numpy()[slots[resident]],
                                  feats[tags[resident]])


@pytest.mark.parametrize("seed", range(4))
def test_device_gather_rows_and_metadata(seed):
    """Under cache pressure the port serves features[ids] exactly, keeps
    the row-store invariant after every call, and its metadata equals the
    reference device_store's."""
    rng = np.random.default_rng(seed)
    N, D, lines, ways = 64, 8, 16, 4
    feats = rng.standard_normal((N, D)).astype(np.float32)
    jstore = jds.init_store(lines, D, ways)
    tstore = tds.init_store(lines, D, ways, device="cpu")
    for _ in range(6):
        ids = rng.integers(0, N, 24).astype(np.int32)
        fc = rng.integers(0, 2, 24).astype(np.int32)
        jstore, _, jhits = jds.device_gather(jstore, jnp.asarray(ids),
                                             jnp.asarray(feats[ids]),
                                             jnp.asarray(fc))
        tstore, rows, hits = tds.device_gather(
            tstore, torch.from_numpy(ids), torch.from_numpy(feats[ids]),
            torch.from_numpy(fc))
        np.testing.assert_array_equal(rows.numpy(), feats[ids])
        np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
        _state_equal(jstore.cache, tstore.cache)
        _check_rows(tstore, feats)


def test_reference_device_gather_fault_is_not_copied():
    """The reference fills the row store before it gathers, so a hit on a
    line that a later miss of the same call evicts and refills is served
    the later request's row.  The port returns feats[[1, 3]] with the same
    metadata."""
    feats = np.arange(16, dtype=np.float32).reshape(4, 4) * 10
    jstore = jds.init_store(num_lines=2, dim=4, ways=2)
    tstore = tds.init_store(num_lines=2, dim=4, ways=2, device="cpu")
    zeros = np.zeros(2, np.int32)
    for ids in ([1, 2], [1, 3]):
        ids = np.asarray(ids, np.int32)
        jstore, jrows, jhits = jds.device_gather(
            jstore, jnp.asarray(ids), jnp.asarray(feats[ids]),
            jnp.asarray(zeros))
        tstore, trows, thits = tds.device_gather(
            tstore, torch.from_numpy(ids), torch.from_numpy(feats[ids]),
            torch.from_numpy(zeros))
    np.testing.assert_array_equal(np.asarray(jhits), [True, False])
    np.testing.assert_array_equal(np.asarray(jrows), feats[[3, 3]])
    np.testing.assert_array_equal(thits.numpy(), [True, False])
    np.testing.assert_array_equal(trows.numpy(), feats[[1, 3]])
    _state_equal(jstore.cache, tstore.cache)
    _check_rows(tstore, feats)


def test_line_filled_twice_keeps_last_filler():
    """One set, one way, three misses in one call: the line ends with the
    tag that stands, its last filler's row, and every request gets its own
    row."""
    feats = np.arange(24, dtype=np.float32).reshape(6, 4)
    store = tds.init_store(num_lines=1, dim=4, ways=1, device="cpu")
    ids = np.array([2, 5, 4], np.int32)
    _, rows, hits = tds.device_gather(
        store, torch.from_numpy(ids), torch.from_numpy(feats[ids]),
        torch.zeros(3, dtype=torch.int32))
    assert not hits.any()
    np.testing.assert_array_equal(rows.numpy(), feats[ids])
    assert store.cache.tags.item() == 4
    _check_rows(store, feats)


def test_window_pinning_survives_conflicting_storm():
    """Port of test_device_store.py::test_device_gather_window_pinning: a
    line the window announced cannot be evicted by a storm of ids in its
    set, and the hit is served from the row store (garbage staged row)."""
    rng = np.random.default_rng(1)
    N, D = 200, 32
    feats = rng.standard_normal((N, D)).astype(np.float32)
    store = tds.init_store(num_lines=16, dim=D, ways=4, device="cpu")
    hot = np.array([7], np.int32)
    one = torch.zeros(1, dtype=torch.int32)
    tds.device_gather(store, torch.from_numpy(hot),
                      torch.from_numpy(feats[hot]), one)
    tds.push_window(store.cache, torch.from_numpy(hot))
    for i in range(6):
        ids = (hot + 16 * (i + 1)).astype(np.int32)
        tds.device_gather(store, torch.from_numpy(ids),
                          torch.from_numpy(feats[ids]), one)
    _, rows, hits = tds.device_gather(store, torch.from_numpy(hot),
                                      torch.zeros((1, D)), one)
    assert bool(hits[0]), "pinned hot line was evicted"
    np.testing.assert_array_equal(rows.numpy(), feats[hot])


def test_count_in_window_matches_reference():
    rng = np.random.default_rng(5)
    nodes = rng.integers(-1, 20, 30).astype(np.int32)
    window = rng.integers(-1, 20, (3, 10)).astype(np.int32)
    np.testing.assert_array_equal(
        cache_device.count_in_window(torch.from_numpy(nodes),
                                     torch.from_numpy(window)).numpy(),
        np.asarray(cache_jax.count_in_window(jnp.asarray(nodes),
                                             jnp.asarray(window))))


def test_init_cache_rejects_bad_geometry():
    with pytest.raises(ValueError):
        cache_device.init_cache(10, 4, device="cpu")
    with pytest.raises(ValueError):
        cache_device.init_cache(128, 128, device="cpu")


def _skewed_ids(rng, num_sets, hot_sets, B, pool=4096):
    """B ids (duplicates, ~10% -1 pads) that hash into `hot_sets` of the
    num_sets sets only."""
    cand = np.arange(pool, dtype=np.int32)
    sets = cache_device._set_of(torch.from_numpy(cand), num_sets).numpy()
    hot = cand[np.isin(sets, hot_sets)]
    ids = rng.choice(hot[:40], B).astype(np.int32)
    ids[rng.random(B) < 0.1] = -1
    return ids


@pytest.mark.parametrize("seed", range(4))
def test_access_set_by_set_in_bucketed_order_matches_reference(seed):
    """The kernel's decomposition: bucket the requests by set in stable
    order, then apply access_ref set by set to each bucket.  On skewed ids
    (a few hot sets, duplicates, pads) the state, hits and slots equal
    cache_jax.access bit for bit, and serve / last_filler equal one
    access_ref call over the whole batch."""
    rng = np.random.default_rng(seed)
    ways, num_sets = 4, 8
    lines, B = ways * num_sets, 96
    jstate = cache_jax.init_cache(lines, ways)
    whole = cache_device.init_cache(lines, ways, device="cpu")
    split = cache_device.init_cache(lines, ways, device="cpu")
    for _ in range(4):
        ids = _skewed_ids(rng, num_sets, [1, 5, 6], B)
        fc = rng.integers(0, 3, B).astype(np.int32)
        jstate, jhits, jslots = cache_jax.access(jstate, jnp.asarray(ids),
                                                 jnp.asarray(fc))
        want = cache_device.access(whole, torch.from_numpy(ids),
                                   torch.from_numpy(fc))
        order, start = cache_device.bucket_by_set_ref(torch.from_numpy(ids),
                                                      num_sets)
        hits = np.zeros(B, bool)
        slots = np.full(B, -1, np.int32)
        serve = np.full(B, -1, np.int32)
        last_filler = np.full(lines, -1, np.int32)
        for s in range(num_sets):
            idx = order[start[s]:start[s + 1]].numpy()
            assert (idx[1:] > idx[:-1]).all()        # request order
            res = cache_device.access_ref(split, torch.from_numpy(ids[idx]),
                                          torch.from_numpy(fc[idx]))
            hits[idx] = res.hits.numpy()
            slots[idx] = res.slots.numpy()
            serve[idx] = res.serve_slots.numpy()
            filled = res.last_filler.numpy() >= 0
            last_filler[filled] = idx[res.last_filler.numpy()[filled]]
        pads = order[start[num_sets]:].numpy()
        assert (ids[pads] < 0).all() and (ids[order[:start[num_sets]]] >= 0).all()
        np.testing.assert_array_equal(hits, np.asarray(jhits))
        np.testing.assert_array_equal(slots, np.asarray(jslots))
        np.testing.assert_array_equal(serve, want.serve_slots.numpy())
        np.testing.assert_array_equal(last_filler, want.last_filler.numpy())
        _state_equal(jstate, split)
    assert int(split.hits) > 0 and int(split.bypasses) > 0


def _tiled_counting_sort(keys: np.ndarray, n_keys: int, tile: int):
    """cache_bucket's three passes in numpy: per-tile histograms and ranks
    from earlier keys of the same tile, key totals scanned into starts,
    then each request placed at start + earlier tiles' count + rank."""
    B = len(keys)
    tiles = -(-B // tile)
    counts = np.zeros((tiles, n_keys), np.int64)
    rank = np.zeros(B, np.int64)
    for t in range(tiles):
        ks = keys[t * tile:(t + 1) * tile]
        for k, key in enumerate(ks):
            rank[t * tile + k] = int((ks[:k] == key).sum())
        counts[t] = np.bincount(ks, minlength=n_keys)
    start = np.concatenate([[0], np.cumsum(counts.sum(0))])
    order = np.empty(B, np.int64)
    for i, key in enumerate(keys):
        t = i // tile
        order[start[key] + counts[:t, key].sum() + rank[i]] = i
    return order, start            # start[n_keys] = B


@pytest.mark.parametrize("tile", [7, 32, 1024])
@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "hot"])
def test_bucket_by_set_equals_tiled_counting_sort(skew, tile):
    """bucket_by_set (the plain version of cache_bucket) is the stable
    argsort of the set, padding last, and equals the kernel's tiled
    counting sort; start has num_sets + 2 entries ending at B."""
    rng = np.random.default_rng(11)
    num_sets, B = 16, 300
    if skew:
        ids = _skewed_ids(rng, num_sets, [3], B)
    else:
        ids = rng.integers(-1, 500, B).astype(np.int32)
    ids_t = torch.from_numpy(ids)
    order, start = cache_device.bucket_by_set(ids_t, num_sets)
    assert order.dtype == torch.int32 and start.dtype == torch.int32
    assert start.shape == (num_sets + 2,) and int(start[-1]) == B
    sets = cache_device._set_of(ids_t, num_sets).numpy()
    keys = np.where(ids >= 0, sets, num_sets)
    want_order, want_start = _tiled_counting_sort(keys, num_sets + 1, tile)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(start.numpy(), want_start)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(keys, kind="stable"))


def test_bucket_wrapper_refuses_cpu_tensors_and_counts_no_launch():
    """CPU ids take the plain version; the kernel wrapper raises on them
    and counts nothing."""
    from repro_torch.kernels import _build
    ids = torch.tensor([3, -1, 7], dtype=torch.int32)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cache_device._bucket_cuda(ids, 4)
    order, start = cache_device.bucket_by_set(ids, 4)
    assert _build.LAUNCHES == before and "cache_bucket" in _build.LAUNCHES
    assert int(start[-1]) == 3 and int(order[-1]) == 1      # the pad last
