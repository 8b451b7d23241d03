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
@pytest.mark.parametrize("B,F,N,D", [(16, 5, 100, 128), (64, 10, 1000, 256),
                                     (8, 25, 64, 512), (7, 3, 50, 100)])
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


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_is_lazy():
    """Importing the kernel modules builds and loads nothing."""
    assert _build._libs == {}
