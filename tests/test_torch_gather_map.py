"""The row kernels with a compacted staged buffer: `tiered_gather`,
`tiered_gather_unique` and `store_fill` given a `staged_map`, against the
same kernels given the full buffer the map expands to (one staged row per
request; rows never read hold NaN).  On the CPU the entry points take the
plain versions; the card's cases run the CUDA kernels and skip without a
card.  This file imports no JAX, so the card runs it: `python3 -m pytest -m
chip tests/test_torch_gather_map.py`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

L = 32
#: requests, row width, dtype and which requests the row store serves
CASES = {
    "ragged": (13, 100, torch.float32, "some"),
    "wide": (64, 1024, torch.float32, "some"),
    "bf16": (37, 129, torch.bfloat16, "some"),
    "odd_bytes": (9, 3, torch.bfloat16, "some"),
    "all_hits": (16, 36, torch.float32, "all"),
    "all_misses": (16, 36, torch.float32, "none"),
}


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.chip)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(request.param)


def _case(name: str):
    """(slots, cache, staged, staged_map, staged_full) for `name`: each
    request with slot -1 has a row in the compacted `staged`, in request
    order; `staged_full` holds it at the request's own index and NaN
    elsewhere."""
    B, D, dtype, served = CASES[name]
    rng = np.random.default_rng(B * 1000 + D)
    slots = rng.integers(-1, L, B).astype(np.int32)
    if served == "all":
        slots = rng.integers(0, L, B).astype(np.int32)
    elif served == "none":
        slots[:] = -1
    else:
        slots[:3] = [-1, 0, -1]              # both branches, whatever the draw
    need = slots < 0
    cache = torch.from_numpy(rng.standard_normal((L, D)).astype(np.float32))
    staged = torch.from_numpy(
        rng.standard_normal((int(need.sum()), D)).astype(np.float32))
    staged_map = np.full(B, -1, np.int32)
    staged_map[need] = np.arange(need.sum())
    full = torch.full((B, D), float("nan"))
    full[torch.from_numpy(need)] = staged
    return (torch.from_numpy(slots), cache.to(dtype), staged.to(dtype),
            torch.from_numpy(staged_map), full.to(dtype))


def _on(device, *tensors):
    return [t.to(device) for t in tensors]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiered_gather_with_a_staged_map(name, device):
    slots, cache, staged, staged_map, full = _case(name)
    want = ref.tiered_gather_ref(slots, cache, full)
    got = ops.tiered_gather(*_on(device, slots, cache, staged, staged_map))
    assert got.dtype == cache.dtype and got.shape == full.shape
    assert torch.equal(got.cpu(), want)
    assert not want.isnan().any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiered_gather_unique_with_a_staged_map(name, device):
    slots, cache, staged, staged_map, full = _case(name)
    U = len(slots)
    inverse = torch.from_numpy(np.random.default_rng(U).integers(
        0, U, 3 * U + 1).astype(np.int32))
    want = ref.tiered_gather_unique_ref(slots, cache, full, inverse)
    got = ops.tiered_gather_unique(
        *_on(device, slots, cache, staged, inverse, staged_map))
    assert got.shape == (len(inverse), full.shape[1])
    assert torch.equal(got.cpu(), want)
    assert not want.isnan().any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_store_fill_with_a_staged_map(name, device):
    """Each filled line takes the staged row of a request read from the
    staged buffer (a filler is always one); the other lines keep theirs."""
    slots, cache, staged, staged_map, full = _case(name)
    rng = np.random.default_rng(len(slots) + 1)
    fillers = np.flatnonzero(slots.numpy() < 0).astype(np.int32)
    last_filler = np.full(L, -1, np.int32)
    lines = rng.choice(L, size=min(L, len(fillers)), replace=False)
    last_filler[lines] = rng.permutation(fillers)[:len(lines)]
    last_filler = torch.from_numpy(last_filler)
    want = cache.clone()
    ref.store_fill_ref(want, last_filler, full)
    rows = cache.clone().to(device)
    ops.store_fill(rows, *_on(device, last_filler, staged, staged_map))
    assert torch.equal(rows.cpu(), want)
    assert not want.isnan().any()
    assert torch.equal(want[last_filler < 0], cache[last_filler < 0])


@pytest.mark.chip
def test_device_tier_stages_only_the_misses_on_the_card():
    """A `DeviceStoreTier` on the card over a windowed run of skewed
    batches: every probe stages and copies exactly its misses, its rows
    equal `features[ids]` bit for bit, and its split keeps the seven keys,
    each a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.tiers import DeviceStoreTier

    rng = np.random.default_rng(12)
    feats = rng.standard_normal((5000, 1024)).astype(np.float32)
    host = torch.from_numpy(feats)
    tier = DeviceStoreTier(feats, num_lines=512, ways=8, window_depth=4,
                           device="cuda")
    batches = [np.unique(np.concatenate([rng.integers(0, 300, 400),
                                         rng.integers(0, 5000, 400)]))
               for _ in range(12)]
    for b in batches[:4]:
        tier.admit(b)
    compacted = 0
    for i, ids in enumerate(batches):
        hits = tier.probe(ids)
        if i + 4 < len(batches):
            tier.admit(batches[i + 4])
        assert torch.equal(tier.last_rows.cpu(), host[ids])
        misses = len(ids) - int(hits.sum())
        assert tier.last_counts["staged_rows"] == misses
        assert tier.last_counts["needed_bytes"] == misses * 1024 * 4
        compacted += 0 < misses < len(ids)
        split = tier.last_split_ms
        assert set(split) == {"future_counts", "stage_host", "h2d",
                              "cache_access", "gather", "fill", "probe_wait"}
        assert all(v >= 0.0 for v in split.values())
    assert compacted >= 6
