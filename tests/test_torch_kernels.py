"""The port's kernel entry points (repro_torch.kernels) against the JAX
package's oracles and its Pallas kernels in interpret mode, on the shape and
dtype sweeps of test_kernels.py.  On CPU tensors every entry point takes its
plain PyTorch version; the CUDA kernels are held to the same plain versions
on the card by chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import segment_mean as tsm  # noqa: E402
from repro_torch.kernels import tiered_gather as ttg  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array (bf16 rounds to nearest
    even in both)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,L,D", [(8, 32, 128), (64, 256, 512),
                                   (16, 8, 1024), (128, 1024, 256),
                                   (13, 32, 100), (5, 32, 36), (16, 32, 129),
                                   (7, 32, 512)])
def test_tiered_gather_matches_reference(B, L, D, dtype):
    """Exact against the JAX oracle and the Pallas kernel, ragged B and D
    included."""
    rng = np.random.default_rng(B * 1000 + D)
    slots = rng.integers(-1, L, B).astype(np.int32)
    cache_j, cache_t = _pair(rng.standard_normal((L, D)).astype(np.float32),
                             dtype)
    staged_j, staged_t = _pair(rng.standard_normal((B, D)).astype(np.float32),
                               dtype)
    out = ops.tiered_gather(torch.from_numpy(slots), cache_t, staged_t)
    assert out.dtype == cache_t.dtype and out.shape == (B, D)
    np.testing.assert_array_equal(
        _np(out), _np(jref.tiered_gather_ref(jnp.asarray(slots), cache_j,
                                             staged_j)))
    np.testing.assert_array_equal(
        _np(out), _np(jops.tiered_gather(jnp.asarray(slots), cache_j,
                                         staged_j)))


def test_tiered_gather_all_hits_all_misses():
    rng = np.random.default_rng(1)
    cache = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32))
    staged = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    hit = torch.from_numpy(rng.integers(0, 16, 8).astype(np.int32))
    assert torch.equal(ops.tiered_gather(hit, cache, staged), cache[hit.long()])
    miss = torch.full((8,), -1, dtype=torch.int32)
    assert torch.equal(ops.tiered_gather(miss, cache, staged), staged)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("U,L,D,N,block_b",
                         [(16, 32, 128, 40, 1), (16, 32, 128, 40, 8),
                          (7, 8, 200, 19, 1), (7, 8, 200, 19, 4),
                          (64, 256, 1000, 255, 8)])
def test_tiered_gather_unique_matches_reference(U, L, D, N, block_b, dtype):
    """Exact against the JAX oracle and the Pallas kernel in interpret mode
    on both of its layouts (the sweep of test_kernels.py plus a ragged
    1000-wide case), and against the expanded plain gather."""
    from repro.kernels.tiered_gather import tiered_gather_unique_cpu
    rng = np.random.default_rng(U * 1000 + N)
    slots = rng.integers(-1, L, U).astype(np.int32)
    inverse = rng.integers(0, U, N).astype(np.int32)
    cache_j, cache_t = _pair(rng.standard_normal((L, D)).astype(np.float32),
                             dtype)
    staged_j, staged_t = _pair(rng.standard_normal((U, D)).astype(np.float32),
                               dtype)
    out = ops.tiered_gather_unique(torch.from_numpy(slots), cache_t,
                                   staged_t, torch.from_numpy(inverse))
    assert out.dtype == cache_t.dtype and out.shape == (N, D)
    js, ji = jnp.asarray(slots), jnp.asarray(inverse)
    for exp in (jops.tiered_gather_unique(js, cache_j, staged_j, ji),
                jops.tiered_gather_unique(js, cache_j, staged_j, ji,
                                          use_pallas=False),
                tiered_gather_unique_cpu(js, cache_j, staged_j, ji,
                                         block_b=block_b)):
        np.testing.assert_array_equal(_np(out), _np(exp))
    inv = torch.from_numpy(inverse).long()
    assert torch.equal(out, ref.tiered_gather_ref(
        torch.from_numpy(slots)[inv], cache_t, staged_t[inv]))


def test_tiered_gather_unique_all_misses_and_all_hits():
    rng = np.random.default_rng(11)
    cache = torch.from_numpy(rng.standard_normal((16, 96)).astype(np.float32))
    staged = torch.from_numpy(rng.standard_normal((5, 96)).astype(np.float32))
    inverse = torch.from_numpy(rng.integers(0, 5, 23).astype(np.int32))
    miss = torch.full((5,), -1, dtype=torch.int32)
    assert torch.equal(ops.tiered_gather_unique(miss, cache, staged, inverse),
                       staged[inverse.long()])
    hit = torch.from_numpy(rng.integers(0, 16, 5).astype(np.int32))
    assert torch.equal(ops.tiered_gather_unique(hit, cache, staged, inverse),
                       cache[hit.long()][inverse.long()])


@pytest.mark.parametrize("H,W,P,N", [(8, 1024, 20, 500), (1, 1024, 7, 64),
                                     (30, 512, 64, 3000), (5, 33, 9, 101)])
def test_frontier_gather_matches_reference(H, W, P, N):
    """Exact against `ops.tiered_frontier_gather` of the JAX package (its
    Pallas path in interpret mode and its oracle), int32 words; H = 1 with
    every slot -1 is the zero-budget store's dummy row."""
    rng = np.random.default_rng(H * 100 + P)
    hot = rng.integers(0, 1 << 30, (H, W)).astype(np.int32)
    staged = rng.integers(0, 1 << 30, (P, W)).astype(np.int32)
    slots = (np.full(P, -1, np.int32) if H == 1
             else rng.integers(-1, H, P).astype(np.int32))
    inverse = rng.integers(0, P, N).astype(np.int32)
    offsets = rng.integers(0, W, N).astype(np.int32)
    args = [torch.from_numpy(x) for x in (slots, hot, staged, inverse,
                                          offsets)]
    out = ops.tiered_frontier_gather(*args)
    assert out.dtype == torch.int32 and out.shape == (N,)
    jargs = [jnp.asarray(x) for x in (slots, hot, staged, inverse, offsets)]
    for use_pallas in (True, False):
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jops.tiered_frontier_gather(
                *jargs, use_pallas=use_pallas)))
    want = np.where(slots[inverse] >= 0,
                    hot[np.maximum(slots[inverse], 0), offsets],
                    staged[inverse, offsets])
    np.testing.assert_array_equal(out.numpy(), want)
    wide = ops.tiered_frontier_gather(args[0], args[1].long(),
                                      args[2].long(), args[3], args[4])
    assert wide.dtype == torch.int64
    np.testing.assert_array_equal(wide.numpy(), want)


def _paged(indices: np.ndarray, W: int, hot_pages: np.ndarray):
    """A paged adjacency as the topology store lays it out: the (n_pages,)
    page table (hot row, -1 off the hot tier) and the hot pages (tail page
    padded by clamping, one dummy row for an empty tier); cold words are
    read from `indices` itself."""
    n_pages = -(-len(indices) // W)
    hot_pages = np.sort(hot_pages)
    table = np.full(n_pages, -1, np.int32)
    table[hot_pages] = np.arange(len(hot_pages))

    def rows(pages):
        if len(pages) == 0:
            return np.zeros((1, W), indices.dtype)
        idx = pages[:, None] * W + np.arange(W)[None, :]
        return indices[np.minimum(idx, len(indices) - 1)]
    return table, rows(hot_pages), rows


@pytest.mark.parametrize("words", [np.int32, np.int64])
@pytest.mark.parametrize("W", [1024, 512, 1000])
@pytest.mark.parametrize("hot_share", [0.3, 1.0, 0.0])
def test_frontier_read_matches_reference(W, words, hot_share):
    """`ops.frontier_read` on CPU tensors (the plain version) is exact
    against `ops.tiered_frontier_gather` of the JAX package, its Pallas path
    in interpret mode and its oracle, fed the unique pages, slots, staged
    non-resident pages, inverse and offsets of the same positions; mixed,
    all-hot and all-cold (zero-budget) stores, the last edge position of
    the tail page included, and an empty input."""
    rng = np.random.default_rng(W + int(hot_share * 10))
    E = 23 * W + W // 3                           # a ragged tail page
    indices = rng.integers(0, 1 << 30, E).astype(words)
    n_pages = -(-E // W)
    hot = rng.permutation(n_pages)[:round(hot_share * n_pages)]
    table, hot_rows, rows = _paged(indices, W, hot)
    pos = np.concatenate([rng.integers(0, E, 600), [E - 1, 0]])
    out = ops.frontier_read(torch.from_numpy(pos), torch.from_numpy(table),
                            torch.from_numpy(hot_rows),
                            torch.from_numpy(indices))
    assert out.dtype == torch.from_numpy(indices[:0]).dtype
    np.testing.assert_array_equal(out.numpy(), indices[pos])
    pages, inverse = np.unique(pos // W, return_inverse=True)
    slots = table[pages]
    staged = np.zeros((len(pages), W), words)
    staged[slots < 0] = rows(pages[slots < 0])
    jargs = [jnp.asarray(x) for x in (slots, hot_rows, staged,
                                      inverse.astype(np.int32),
                                      (pos % W).astype(np.int32))]
    for use_pallas in (True, False):
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jops.tiered_frontier_gather(
                *jargs, use_pallas=use_pallas)))
    empty = ops.frontier_read(torch.zeros(0, dtype=torch.int64),
                              torch.from_numpy(table),
                              torch.from_numpy(hot_rows),
                              torch.from_numpy(indices))
    assert empty.shape == (0,) and empty.dtype == out.dtype


def test_frontier_read_fills_out_in_place():
    indices = np.arange(3000, dtype=np.int32) * 7
    table, hot, _ = _paged(indices, 1024, np.array([1]))
    pos = torch.tensor([0, 1500, 2999, 1024], dtype=torch.int64)
    out = torch.full((4,), -5, dtype=torch.int32)
    got = ops.frontier_read(pos, torch.from_numpy(table),
                            torch.from_numpy(hot), torch.from_numpy(indices),
                            out=out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), indices[pos.numpy()])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,F,N,D", [(16, 5, 100, 128), (64, 10, 1000, 256),
                                     (8, 25, 64, 512), (7, 3, 50, 100),
                                     (9, 1, 40, 64), (6, 33, 70, 512)])
def test_segment_mean_matches_reference(B, F, N, D, dtype):
    """Allclose against the JAX oracle and the Pallas kernel, with the
    tolerances of test_kernels.py (1e-6 f32, 2e-2 bf16): the Pallas kernel
    adds x/F per step, the oracles take a mean."""
    rng = np.random.default_rng(B * 100 + F)
    idx = rng.integers(0, N, (B, F)).astype(np.int32)
    feats_j, feats_t = _pair(rng.standard_normal((N, D)).astype(np.float32),
                             dtype)
    out = ops.segment_mean(torch.from_numpy(idx), feats_t)
    assert out.dtype == feats_t.dtype and out.shape == (B, D)
    tol = 1e-6 if dtype == "f32" else 2e-2
    for exp in (jref.segment_mean_ref(jnp.asarray(idx), feats_j),
                jops.segment_mean(jnp.asarray(idx), feats_j)):
        np.testing.assert_allclose(_np(out), _np(exp), rtol=tol, atol=tol)


def test_store_fill_ref_writes_last_fillers_in_place():
    rng = np.random.default_rng(2)
    rows = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    before = rows.clone()
    staged = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    last_filler = torch.tensor([-1, 3, -1, 0, 2, -1], dtype=torch.int32)
    ops.store_fill(rows, last_filler, staged)
    for line, filler in enumerate(last_filler.tolist()):
        want = before[line] if filler < 0 else staged[filler]
        assert torch.equal(rows[line], want)


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 20, (4, 3)).astype(np.int32))
    feats = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32))
    slots = torch.tensor([0, -1, 5, -1], dtype=torch.int32)
    staged = torch.zeros((4, 16))
    before = dict(_build.LAUNCHES)
    assert torch.equal(ops.segment_mean(idx, feats),
                       ref.segment_mean_ref(idx, feats))
    assert torch.equal(ops.tiered_gather(slots, feats, staged),
                       ref.tiered_gather_ref(slots, feats, staged))
    ops.store_fill(feats.clone(), torch.full((20,), -1, dtype=torch.int32),
                   staged)
    inverse = torch.tensor([3, 0, 0, 2, 1], dtype=torch.int32)
    ops.tiered_gather_unique(slots, feats, staged, inverse)
    pages = feats.to(torch.int32)
    ops.tiered_frontier_gather(slots, pages, torch.zeros((4, 16),
                                                         dtype=torch.int32),
                               inverse, inverse)
    table = torch.tensor([0, -1, -1], dtype=torch.int32)
    ops.frontier_read(torch.tensor([0, 17, 40], dtype=torch.int64), table,
                      pages, torch.arange(48, dtype=torch.int32))
    assert _build.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never falls back to the plain version: it takes
    CUDA tensors or raises."""
    idx = torch.zeros((2, 2), dtype=torch.int32)
    feats = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tsm.segment_mean(idx, feats)
    with pytest.raises(ValueError, match="CUDA"):
        ttg.tiered_gather(torch.zeros(2, dtype=torch.int32), feats,
                          torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        ttg.store_fill(feats, torch.zeros(4, dtype=torch.int32), feats)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ttg.tiered_gather_unique(i32, feats, torch.zeros((2, 8)), i32)
    with pytest.raises(ValueError, match="CUDA"):
        ttg.frontier_gather(i32, torch.zeros((4, 8), dtype=torch.int32),
                            torch.zeros((2, 8), dtype=torch.int32), i32, i32)
    with pytest.raises(ValueError, match="CUDA"):
        ttg.frontier_read(torch.zeros(2, dtype=torch.int64), i32,
                          torch.zeros((4, 8), dtype=torch.int32),
                          torch.zeros(32, dtype=torch.int32))


def test_cold_mirror_must_be_pinned():
    """The kernel reads cold words in place from the host adjacency through
    its device mapping: a pageable host tensor is refused before any
    build, with no staging fallback."""
    with pytest.raises(ValueError, match="pinned"):
        ttg.mapped_pointer(torch.zeros(32, dtype=torch.int32))
    assert _build._libs == {}


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_is_lazy():
    """Importing the kernel modules builds and loads nothing."""
    assert _build._libs == {}
