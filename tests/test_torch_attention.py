"""The port's attention (`repro_torch.kernels.ref.attention_ref`, the CPU
path of `ops.flash_attention`) against the JAX package: its oracle on the
sweep of test_kernels.py, its Pallas kernel in interpret mode, and its
einsum attention over a KV cache at per-slot offsets.  The CUDA kernel is
held to `attention_ref` on the card by chip_smoke.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.common import ModelConfig as JConfig  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.common import ModelConfig as TConfig  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 3e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}

# the sweep of tests/test_kernels.py::test_flash_attention_sweep
SWEEP = [(2, 4, 4, 128, 128, 64, True, None),     # MHA causal
         (2, 8, 2, 128, 128, 64, True, None),     # GQA
         (1, 4, 1, 256, 256, 128, True, None),    # MQA
         (2, 4, 2, 128, 128, 64, True, 32),       # sliding window
         (2, 4, 4, 100, 164, 64, False, None),    # cross-ish, padded blocks
         (1, 2, 2, 64, 512, 64, True, None)]      # long kv (decode-like)
SWEEP_IDS = ["mha", "gqa", "mqa", "window", "padded", "long_kv"]


def _inputs(case, dtype, seed):
    B, H, KV, Sq, Sk, hd = case[:6]
    rng = np.random.default_rng(seed)
    jd, td, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", SWEEP, ids=SWEEP_IDS)
def test_attention_ref_matches_reference_oracle(case, dtype):
    causal, window = case[6], case[7]
    (qj, kj, vj), (qt, kt, vt) = _inputs(case, dtype, seed=sum(case[:6]))
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    want = jref.attention_ref(qj, kj, vj, causal=causal, window=window)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", [SWEEP[1], SWEEP[3], SWEEP[4]],
                         ids=["gqa", "window", "padded"])
def test_attention_ref_matches_pallas_interpret(case, dtype):
    """Against the reference's Pallas kernel as its own tests run it on
    the CPU (interpret mode), at the sweep's tolerance."""
    causal, window = case[6], case[7]
    (qj, kj, vj), (qt, kt, vt) = _inputs(case, dtype, seed=7 + case[4])
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


# head dim 256 (recurrentgemma-2b: H 10, MQA, a local window), small S:
# the reference's Pallas kernel takes whole-hd blocks of any size
HD256 = [(1, 10, 1, 96, 96, 256, True, 32),
         (2, 4, 2, 40, 72, 256, False, None)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", HD256, ids=["mqa_window", "padded"])
def test_attention_ref_hd256_matches_reference(case, dtype):
    """attention_ref at hd 256 against the reference's oracle and its
    Pallas kernel in interpret mode, at the sweep's tolerance."""
    causal, window = case[6], case[7]
    (qj, kj, vj), (qt, kt, vt) = _inputs(case, dtype, seed=256 + case[3])
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    tol = DTYPES[dtype][2]
    for want in (jref.attention_ref(qj, kj, vj, causal=causal, window=window),
                 jops.flash_attention(qj, kj, vj, causal=causal,
                                      window=window)):
        np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window"])
@pytest.mark.parametrize("Sq", [1, 5])
def test_q_offset_equals_reference_with_leading_queries(Sq, window):
    """Query i at position q_offset[b] + i: the reference oracle gives the
    same rows when the offset is spelled out as leading queries."""
    B, H, KV, Sk, hd = 3, 4, 2, 64, 16
    rng = np.random.default_rng(Sq)
    offsets = np.array([0, 17, Sk - Sq], np.int32)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window,
                              q_offset=torch.from_numpy(offsets))
    for b, o in enumerate(offsets):
        qpad = np.concatenate([np.zeros((1, H, o, hd), np.float32),
                               q[b:b + 1]], axis=2)
        want = jref.attention_ref(jnp.asarray(qpad), jnp.asarray(k[b:b + 1]),
                                  jnp.asarray(v[b:b + 1]), causal=True,
                                  window=window)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(want)[0, :, o:],
                                   rtol=1e-5, atol=1e-5)


def test_fully_masked_rows_give_zero():
    """Rows that see no key (the window has passed every cache row) are 0,
    as in the Pallas kernel and the reference oracle."""
    q = torch.randn(2, 4, 3, 16)
    k = torch.randn(2, 2, 8, 16)
    out = ops.flash_attention(q, k, k, causal=True, window=4,
                              q_offset=torch.tensor([20, 0], dtype=torch.int32))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert out[1].abs().sum() > 0


def _cfgs(**kw):
    base = dict(name="t", family="dense", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                qkv_bias=True, **kw)
    return (JConfig(**base, param_dtype=jnp.float32,
                    compute_dtype=jnp.float32),
            TConfig(**base, param_dtype=torch.float32,
                    compute_dtype=torch.float32, attn_impl="flash"))


@pytest.mark.parametrize("window", [None, 6], ids=["causal", "window"])
def test_flash_layer_over_cache_matches_reference_einsum(window):
    """The port's flash attention layer (attention_ref with the cache's
    per-slot offsets) against the reference's einsum layer: a prefill into
    a cache at 0, then a decode step at per-slot positions."""
    jcfg, tcfg = _cfgs(attn_window=window)
    params = j_init(JL.attention_defs(jcfg), jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    rng = np.random.default_rng(3)
    B, S, Sc = 3, 9, 16
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    jcache = (jnp.zeros((B, Sc, 2, 16)), jnp.zeros((B, Sc, 2, 16)))
    tcache = (torch.zeros(B, Sc, 2, 16), torch.zeros(B, Sc, 2, 16))
    jo, jcache = JL.attention(params, jnp.asarray(x), jcfg, kv_cache=jcache,
                              cache_index=jnp.int32(0), window=window)
    to, tcache = TL.attention(tp, torch.from_numpy(x), tcfg,
                              kv_cache=tcache, cache_index=0, window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    idx = np.array([S, 4, 12], np.int32)       # slots at different positions
    xd = rng.standard_normal((B, 1, 64)).astype(np.float32)
    jo, jcache = JL.attention(params, jnp.asarray(xd), jcfg, kv_cache=jcache,
                              cache_index=jnp.asarray(idx), window=window)
    to, tcache = TL.attention(tp, torch.from_numpy(xd), tcfg,
                              kv_cache=tcache,
                              cache_index=torch.from_numpy(idx),
                              window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    for t, j in zip(tcache, jcache):        # rope rounds differently
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_attention_layer_without_cache_matches_reference(impl):
    """No cache: the offset is 0, exactly the reference kernel's function,
    and the einsum path is the reference's einsum path."""
    jcfg, tcfg = _cfgs(qk_norm=True)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    params = j_init(JL.attention_defs(jcfg), jax.random.PRNGKey(1))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    x = np.random.default_rng(4).standard_normal((2, 12, 64)).astype(
        np.float32)
    jo, _ = JL.attention(params, jnp.asarray(x), jcfg)
    to, _ = TL.attention(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_no_launch():
    q = torch.randn(1, 2, 4, 16)
    k = torch.randn(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, k)
    before = _build.LAUNCHES["flash_attention"]
    ops.flash_attention(q, k, k)
    assert _build.LAUNCHES["flash_attention"] == before
    assert "flash_attention" in _build.SOURCES
    assert tfa.HEAD_DIMS == (16, 32, 64, 80, 128, 256)


# split-KV: (B, H, KV, Sq, Sk, hd, window, offsets); offsets 0 (one visible
# row) and Sk - Sq leave most splits empty; the last case's first sequence
# sees no key at all
SPLIT_CASES = [(3, 12, 2, 1, 300, 32, None, (0, 150, 299)),
               (2, 8, 2, 4, 200, 16, 24, (0, 196)),
               (1, 4, 1, 2, 130, 64, None, (128,)),
               (2, 4, 2, 1, 64, 16, 4, (100, 10)),
               (2, 10, 1, 1, 300, 256, 48, (100, 290))]
SPLIT_IDS = ["decode", "window_group4", "b1", "unseen", "hd256_window"]


def _reference_at_offsets(q, k, v, offsets, window):
    """The JAX oracle at per-sequence offsets: each sequence's queries
    after `offset` leading zero queries, which the causal mask counts."""
    B, H, Sq, hd = q.shape
    outs = []
    for b, o in enumerate(offsets):
        qpad = np.concatenate([np.zeros((1, H, o, hd), np.float32),
                               q[b:b + 1]], axis=2)
        want = jref.attention_ref(jnp.asarray(qpad), jnp.asarray(k[b:b + 1]),
                                  jnp.asarray(v[b:b + 1]), causal=True,
                                  window=window)
        outs.append(np.asarray(want)[0, :, o:])
    return np.stack(outs)


@pytest.mark.parametrize("plan", ["launcher", "one_tile"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
def test_split_and_combine_match_reference_oracle(case, plan):
    """The kernel's split-KV arithmetic in plain torch: partials (m, l,
    acc) per kv chunk with NEG_INF = -1e30, merged by log-sum-exp, against
    the JAX oracle within 1e-6 in f32, rows with nothing visible 0."""
    B, H, KV, Sq, Sk, hd, window, offsets = case
    rng = np.random.default_rng(Sk + hd)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    if plan == "launcher":
        splits, chunk = tfa.split_plan(Sk, B, KV, sms=132)
    else:
        chunk = tfa.SPLIT_TILE
        splits = -(-Sk // chunk)
    off = torch.tensor(offsets, dtype=torch.int32)
    ml, acc = ref.flash_split_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), splits, chunk,
                                  causal=True, window=window, q_offset=off)
    assert ml.shape == (B, KV, splits, tfa.SPLIT_ROWS, 2)
    assert acc.shape == (B, KV, splits, tfa.SPLIT_ROWS, hd)
    out = ref.flash_combine_ref(ml, acc, H, Sq, torch.float32)
    want = _reference_at_offsets(q, k, v, offsets, window)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    # a split past a sequence's band holds the neutral partial
    empty = ml[..., 1] == 0
    assert empty.any()
    assert bool((ml[..., 0][empty] == ref.NEG_INF).all())
    assert bool((acc[empty] == 0).all())
    if plan == "one_tile" and window is not None and offsets[0] - window >= Sk:
        assert torch.equal(out[0], torch.zeros_like(out[0]))


def _split_inputs(case, seed):
    B, H, KV, Sq, Sk, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


def _plan(plan, Sk, B, KV):
    if plan == "launcher":
        return tfa.split_plan(Sk, B, KV, sms=132)
    return -(-Sk // tfa.SPLIT_TILE), tfa.SPLIT_TILE


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("plan", ["launcher", "one_tile"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
def test_live_splits_mirror_the_band_and_dead_splits_are_neutral(case, plan,
                                                                 seed):
    """ref.live_splits at random offsets (some past the cache) and random
    windows: every split it calls dead holds exactly the neutral partial
    (NEG_INF, 0, 0) in every row of ref.flash_split_ref, padding rows too,
    and every split it calls live saw a key in some row, so the fused
    kernel's merge, which reads only live splits, loses nothing."""
    B, _, KV, Sq, Sk, hd = case[:6]
    rng = np.random.default_rng(100 * seed + Sk + hd)
    windows = [None, int(rng.integers(1, 2 * tfa.SPLIT_TILE)),
               int(rng.integers(1, Sk + 1))]
    q, k, v = _split_inputs(case, seed)
    splits, chunk = _plan(plan, Sk, B, KV)
    for window in windows:
        off = torch.from_numpy(rng.integers(0, Sk + 16, B).astype(np.int32))
        live = ref.live_splits(off, Sq, Sk, chunk, splits, True, window)
        assert live.shape == (B, splits) and live.dtype == torch.bool
        ml, acc = ref.flash_split_ref(q, k, v, splits, chunk, causal=True,
                                      window=window, q_offset=off)
        dead = ~live
        assert bool((ml[..., 0].transpose(1, 2)[dead] == ref.NEG_INF).all())
        assert bool((ml[..., 1].transpose(1, 2)[dead] == 0).all())
        assert bool((acc.transpose(1, 2)[dead] == 0).all())
        seen = (ml[..., 1] > 0).any(dim=(1, 3))              # (B, splits)
        assert torch.equal(seen, live)


@pytest.mark.parametrize("plan", ["launcher", "one_tile"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
def test_combine_over_live_splits_alone_equals_the_full_merge(case, plan):
    """The fused kernel's merge reads only the live splits, in split order:
    ref.flash_combine_ref given `live`, with the dead splits' scratch
    overwritten by NaN, equals the merge over every split bit for bit (a
    dead split adds an exact 0), and the JAX oracle within 1e-6."""
    B, H, KV, Sq, Sk, hd, window, offsets = case
    q, k, v = _split_inputs(case, Sk + hd)
    splits, chunk = _plan(plan, Sk, B, KV)
    off = torch.tensor(offsets, dtype=torch.int32)
    ml, acc = ref.flash_split_ref(q, k, v, splits, chunk, causal=True,
                                  window=window, q_offset=off)
    live = ref.live_splits(off, Sq, Sk, chunk, splits, True, window)
    full = ref.flash_combine_ref(ml, acc, H, Sq, torch.float32)
    poisoned_ml, poisoned_acc = ml.clone(), acc.clone()
    dead = (~live)[:, None, :]
    poisoned_ml[dead.expand(B, KV, splits)] = float("nan")
    poisoned_acc[dead.expand(B, KV, splits)] = float("nan")
    alone = ref.flash_combine_ref(poisoned_ml, poisoned_acc, H, Sq,
                                  torch.float32, live=live)
    assert torch.equal(alone, full)
    want = _reference_at_offsets(q.numpy(), k.numpy(), v.numpy(), offsets,
                                 window)
    np.testing.assert_allclose(alone.numpy(), want, rtol=1e-6, atol=1e-6)


def test_arrival_counters_are_zeroed_once_reused_and_grown(monkeypatch):
    """The launcher's arrival counters: one int32 tensor per device, zeroed
    by torch.zeros when made, handed out again as it stands (the kernel,
    not the launcher, sets each counter back to 0), and replaced by a
    larger zeroed one when B * KV outgrows it."""
    monkeypatch.setattr(tfa, "_arrivals", {})
    cpu = torch.device("cpu")
    first = tfa._arrival_counters(cpu, 6)
    assert first.dtype == torch.int32 and first.shape == (6,)
    assert first.device == cpu and not bool(first.any())
    first[3] = 5                      # a count left over: never re-zeroed
    again = tfa._arrival_counters(cpu, 4)
    assert again is first and int(again[3]) == 5
    grown = tfa._arrival_counters(cpu, 16)
    assert grown is not first and grown.shape == (16,)
    assert not bool(grown.any())
    assert tfa._arrival_counters(cpu, 16) is grown
    assert tfa._arrivals == {cpu: grown}


def test_split_decode_paths_refuse_cpu_tensors_and_count_no_launch():
    """The private split-KV entry (the fused launch and the two-launch path
    it replaced, for chip_smoke.py) launches on CUDA tensors or raises,
    before it counts anything; it refuses a call that is not split-KV."""
    q = torch.randn(1, 4, 1, 16)
    k = torch.randn(1, 2, 64, 16)
    before = dict(_build.LAUNCHES)
    for merge in (True, False):
        with pytest.raises(ValueError, match="CUDA"):
            tfa._flash_decode(q, k, k, merge=merge)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("Sk", [1, 63, 64, 65, 300, 2048, 8192])
@pytest.mark.parametrize("B,KV", [(1, 1), (1, 2), (8, 2), (4, 8), (64, 8)])
def test_split_plan_covers_kv_range_once(Sk, B, KV):
    """split_plan is a pure function of static shapes: its chunks tile
    [0, Sk) exactly once, each a multiple of the kv tile, no split empty
    of rows, at most MAX_SPLITS, and about SPLIT_FILL blocks per SM."""
    sms = 132
    splits, chunk = tfa.split_plan(Sk, B, KV, sms)
    assert (splits, chunk) == tfa.split_plan(Sk, B, KV, sms)
    assert 1 <= splits <= tfa.MAX_SPLITS and chunk % tfa.SPLIT_TILE == 0
    covered = np.zeros(Sk, np.int64)
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, Sk)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    tiles = -(-Sk // tfa.SPLIT_TILE)
    if splits < min(tiles, tfa.MAX_SPLITS):
        assert B * KV * splits >= tfa.SPLIT_FILL * sms * 0.5


def test_flash_combine_ref_of_one_split_is_the_normalised_partial():
    """With one split the merge is acc / l, and a row whose split saw no
    key (l = 0) is 0."""
    B, KV, H, Sq, hd = 1, 2, 4, 1, 16
    ml = torch.zeros(B, KV, 1, tfa.SPLIT_ROWS, 2)
    ml[..., 0] = 0.5
    ml[..., 1] = 2.0
    ml[0, 1, 0, 1] = torch.tensor([ref.NEG_INF, 0.0])
    acc = torch.randn(B, KV, 1, tfa.SPLIT_ROWS, hd)
    acc[0, 1, 0, 1] = 0.0
    out = ref.flash_combine_ref(ml, acc, H, Sq, torch.float32)
    assert torch.allclose(out[0, 0, 0], acc[0, 0, 0, 0] / 2.0)
    assert torch.equal(out[0, 3, 0], torch.zeros(hd))          # head 2 * 1 + 1


def test_combine_wrapper_refuses_cpu_tensors_and_counts_no_launch():
    """flash_combine launches on CUDA tensors or raises; it has its own
    launch count."""
    ml = torch.zeros(1, 2, 1, tfa.SPLIT_ROWS, 2)
    acc = torch.zeros(1, 2, 1, tfa.SPLIT_ROWS, 16)
    out = torch.empty(1, 4, 1, 16)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_combine(ml, acc, out)
    assert _build.LAUNCHES == before
    assert "flash_combine" in _build.LAUNCHES
