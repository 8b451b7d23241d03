"""The port's other LM families (`repro_torch.models.transformer.LM` with
the moe, hybrid, ssm, encdec and vlm plans, `models.recurrent`, the MoE
and cross-attention layers, the six configs) against the JAX package on
the reduced configs in f32 on the CPU: the same parameters (the
reference's, carried over by `load_reference_params`) and the same numpy
inputs go through both.  On the CPU the port's flash path runs
`attention_ref`; the reference runs its einsum path.  The parity class is
allclose: the recurrences' scans and the chunked SSD sum in another order.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.models.common import param_count as j_param_count  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

NEW = ["llama4_maverick_400b_a17b", "arctic_480b", "recurrentgemma_2b",
       "mamba2_1_3b", "whisper_small", "internvl2_1b"]
#: the reference's own decode cases (tests/test_decode_consistency.py): MoE
#: at a lossless capacity factor
EXTRA = {"llama4_maverick_400b_a17b": {"moe_capacity_factor": 100.0},
         "arctic_480b": {"moe_capacity_factor": 100.0}}
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _models(arch, impl="einsum", seed=42, **extra):
    """The reference's model and f32 params, and the port's model with the
    same params carried over."""
    extra = {**EXTRA.get(arch, {}), **extra}
    jcfg = dataclasses.replace(jconfigs.get(arch, reduced=True),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32, **extra)
    tcfg = dataclasses.replace(tconfigs.get(arch, reduced=True),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32, attn_impl=impl,
                               **extra)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = LM(tcfg, device="cpu")
    tp = tm.load_reference_params(jax.tree.map(np.asarray, params))
    return jm, params, tm, tp


def _batch(cfg, B, S, seed=0):
    """numpy tokens, and an encdec's frames or a vlm's patches."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = (rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_matches_reference(arch):
    """configs.get returns all ten configs, full and reduced, equal to the
    reference's field for field (dtypes as their torch twins), the launch
    slice's `moe_2d_dispatch` included."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for reduced in (False, True):
        want = dataclasses.asdict(jconfigs.get(arch, reduced=reduced))
        got = dataclasses.asdict(tconfigs.get(arch, reduced=reduced))
        for name in ("param_dtype", "compute_dtype"):
            want[name] = DTYPES[want[name]]
        assert got == want
    assert tconfigs.all_configs(reduced=True).keys() == set(
        jconfigs.ARCH_IDS)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("arch", NEW)
def test_forward_matches_reference(arch, impl):
    """Teacher-forced logits within 1e-4 of the reference's einsum path,
    with whisper's frames and the vlm's patches from default_rng."""
    jm, params, tm, tp = _models(arch, impl=impl, seed=3)
    batch = _batch(jm.cfg, 2, 24, seed=4)
    want = np.asarray(jm.forward(params, _j(batch)))
    got = tm.forward(tp, _t(batch))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("arch", NEW)
def test_decode_matches_reference_teacher_forcing(arch, impl):
    """The twin of test_decode_consistency.py for the families: the port's
    prefill plus incremental decode (KV cache, RG-LRU and SSD states, the
    cross-attention memory) against the reference's teacher-forced logits,
    below 1e-3; a vlm's cache rows start after its patches."""
    jm, params, tm, tp = _models(arch, impl=impl)
    B, S, E = 2, 16, 4
    batch = _batch(jm.cfg, B, S + E, seed=1)
    toks = batch["tokens"]
    tf_logits = np.asarray(jm.forward(params, _j(batch)))
    P = jm.cfg.frontend_tokens if jm.cfg.frontend == "vision_stub" else 0
    pre = dict(batch, tokens=toks[:, :S])
    cache = tm.init_cache(B, P + S + E)
    lg, cache = tm.prefill(tp, _t(pre), cache)
    errs = [np.abs(lg[:, -1].numpy() - tf_logits[:, P + S - 1]).max()]
    for t in range(E):
        index = torch.full((B,), P + S + t, dtype=torch.int32)
        lg, cache = tm.decode_step(
            tp, torch.from_numpy(toks[:, S + t:S + t + 1]), cache, index)
        errs.append(np.abs(lg[:, 0].numpy() - tf_logits[:, P + S + t]).max())
    assert max(errs) < 1e-3, errs


def test_local_window_masks_in_prefill_and_decode():
    """recurrentgemma reduced (window 16) over 40 tokens on the flash path,
    so the local window masks in prefill and decode: decode at scalar and
    per-slot indices against the reference's teacher forcing."""
    jm, params, tm, tp = _models("recurrentgemma_2b", impl="flash", seed=5)
    B, S, E = 2, 36, 4
    toks = _batch(jm.cfg, B, S + E, seed=6)["tokens"]
    tf_logits = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    cache = tm.init_cache(B, S + E)
    lg, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                           cache)
    errs = [np.abs(lg[:, -1].numpy() - tf_logits[:, S - 1]).max()]
    for t in range(E):
        index = S + t if t % 2 else torch.full((B,), S + t,
                                               dtype=torch.int32)
        lg, cache = tm.decode_step(
            tp, torch.from_numpy(toks[:, S + t:S + t + 1]), cache, index)
        errs.append(np.abs(lg[:, 0].numpy() - tf_logits[:, S + t]).max())
    assert max(errs) < 1e-3, errs


def _count_flash(monkeypatch):
    calls = []
    real = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_small",
                                  "llama4_maverick_400b_a17b", "mamba2_1_3b"])
def test_flash_calls_per_step(arch, monkeypatch):
    """With attn_impl="flash", a prefill calls ops.flash_attention once per
    self-attention layer (and whisper's encoder layers, non-causal), a
    decode step once per self-attention layer and, non-causal over the
    encoded memory, once per cross-attention layer, as the reference's
    flash branch does; cross-attention's prefill and the recurrent layers
    never do.  chip_smoke.py phase 5b holds the kernel's launch counts to
    the same numbers."""
    _, _, tm, tp = _models(arch, impl="flash")
    cfg = tm.cfg
    layers = tm.attention_layers()
    assert layers == {"recurrentgemma_2b": 1, "whisper_small": 2,
                      "llama4_maverick_400b_a17b": 4, "mamba2_1_3b": 0}[arch]
    calls = _count_flash(monkeypatch)
    batch = _t(_batch(cfg, 2, 6))
    cache = tm.init_cache(2, 10)
    tm.prefill(tp, batch, cache)
    enc = cfg.encoder_layers
    assert len(calls) == layers + enc
    assert [c[2] for c in calls] == [False] * enc + [True] * layers
    del calls[:]
    tm.decode_step(tp, batch["tokens"][:, :1], cache,
                   torch.full((2,), 6, dtype=torch.int32))
    cross = tm.cross_attention_layers()
    assert cross == {"whisper_small": 2}.get(arch, 0)
    assert len(calls) == layers + cross
    assert all(c[0][2] == 1 for c in calls)
    # each dec layer: self-attention over the cache, then cross-attention
    # over the encoder_seq rows of the memory
    want = [(10, True)] * layers if not cross else \
        [(10, True), (cfg.encoder_seq, False)] * cross
    assert [(c[1][2], c[2]) for c in calls] == want


@pytest.mark.parametrize("arch", NEW)
def test_full_width_param_defs_match_reference(arch):
    """The port's parameter tree at the full published width is the
    reference's, leaf for leaf in shape, dtype class and init (nothing is
    materialised), with the parameter counts of the full-width models."""
    cfg = tconfigs.get(arch)
    jcfg = jconfigs.get(arch)
    if cfg.moe_experts:         # the depth the card holds at full width
        layers = 2 if cfg.moe_interleave == 2 else 1
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    defs = LM(cfg, device="cpu").param_defs()
    jdefs = JLM(jcfg).param_defs()
    want = {"recurrentgemma_2b": 2_894_574_080, "mamba2_1_3b": 1_345_625_088,
            "whisper_small": 307_064_832, "internvl2_1b": 496_326_528,
            "llama4_maverick_400b_a17b": 18_560_476_160,
            "arctic_480b": 14_080_955_392}[arch]
    assert param_count(defs) == j_param_count(jdefs) == want

    def leaves(tree, path=""):
        if hasattr(tree, "init"):
            return [(path, tree.shape, tree.init, tree.scale, tree.axes)]
        items = (enumerate(tree) if isinstance(tree, (list, tuple))
                 else sorted(tree.items()))
        return [x for k, v in items for x in leaves(v, f"{path}/{k}")]

    assert leaves(defs) == leaves(jdefs)


@pytest.mark.parametrize("S", [5, 13])
def test_rglru_block_matches_reference(S):
    """RG-LRU over S steps (S < 3 leaves no full conv tail; 13 is odd for
    the doubling scan): the sequence output and the prefill state, then one
    decode step from that state, against the reference's."""
    jm, params, tm, tp = _models("recurrentgemma_2b")
    cfg, jcfg = tm.cfg, jm.cfg
    jp = jax.tree.map(np.asarray, params)["stacks"][0]["b0"]["rec"]
    jp = {k: v[0] for k, v in jp.items()}
    tp_ = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy, jst = JR.rglru_block(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, tst = TR.rglru_block(tp_, torch.from_numpy(x), cfg,
                             return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    jy1, _ = JR.rglru_block(jp, jnp.asarray(x1), jcfg, jst)
    ty1, _ = TR.rglru_block(tp_, torch.from_numpy(x1), cfg, tst)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S", [2, 8, 21])
def test_ssd_block_matches_reference(S):
    """Mamba-2 SSD over S steps (chunk 8: shorter than one chunk, one
    chunk, padded to three with dt = 0): the output, the final state, and
    one decode step from it, against the reference's."""
    jm, params, tm, tp = _models("mamba2_1_3b")
    cfg, jcfg = tm.cfg, jm.cfg
    jp = jax.tree.map(np.asarray, params)["stacks"][0]["b0"]["ssm"]
    jp = {k: v[0] for k, v in jp.items()}
    tp_ = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy, jst = JR.ssd_block(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, tst = TR.ssd_block(tp_, torch.from_numpy(x), cfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    jy1, _ = JR.ssd_block(jp, jnp.asarray(x1), jcfg, jst)
    ty1, _ = TR.ssd_block(tp_, torch.from_numpy(x1), cfg, tst)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_linear_scan_is_the_sequential_recurrence(n):
    """The doubling scan equals h_t = a_t h_{t-1} + b_t run step by step,
    with a broadcast over b's trailing axes as the SSD chunk states use."""
    gen = torch.Generator().manual_seed(n)
    a = torch.rand(3, n, 4, generator=gen, dtype=torch.float64)
    b = torch.randn(3, n, 4, 5, generator=gen, dtype=torch.float64)
    h = torch.zeros(3, 4, 5, dtype=torch.float64)
    want = []
    for t in range(n):
        h = a[:, t, :, None] * h + b[:, t]
        want.append(h)
    got = TR._linear_scan(a, b, dim=1)
    assert torch.allclose(got, torch.stack(want, dim=1), rtol=1e-12,
                          atol=1e-12)


def test_init_draws_large_leaves_in_chunks(monkeypatch):
    """A leaf of more than INIT_CHUNK elements is drawn chunk by chunk into
    its own dtype (no whole-size f32 temporary): the same values from the
    same seed, the chunk's std, and a smaller leaf, drawn in one chunk,
    equal to one whole-tensor draw."""
    monkeypatch.setattr(TC, "INIT_CHUNK", 1000)
    big = TC.ParamDef((3, 50, 40), ("expert", None, None), torch.bfloat16,
                      init="lecun")
    small = TC.ParamDef((10, 40), (None, None), torch.bfloat16, init="lecun")
    a = big.initializer(torch.Generator().manual_seed(0))
    b = big.initializer(torch.Generator().manual_seed(0))
    assert a.dtype == torch.bfloat16 and a.shape == (3, 50, 40)
    assert torch.equal(a, b)
    assert abs(a.float().std().item() - (1 / 50) ** 0.5) < 0.01
    gen = torch.Generator().manual_seed(1)
    want = (torch.randn((10, 40), generator=gen) * (1 / 10) ** 0.5
            ).to(torch.bfloat16)
    assert torch.equal(small.initializer(torch.Generator().manual_seed(1)),
                       want)


def test_mamba2_has_no_attention_params():
    """The twin of test_arch_smoke.py's: the ssm plan has no attention
    leaf and no head dim is read (num_heads is 0)."""
    cfg = tconfigs.get("mamba2_1_3b", reduced=True)
    model = LM(cfg, device="cpu")
    defs = model.param_defs()

    def names(tree, path=""):
        if hasattr(tree, "init"):
            return [path]
        items = (enumerate(tree) if isinstance(tree, list)
                 else tree.items())
        return [n for k, v in items for n in names(v, f"{path}/{k}")]

    leaves = names(defs)
    assert not any("attn" in n for n in leaves)
    assert any("ssm" in n for n in leaves)
    assert model.attention_layers() == 0
    cache = model.init_cache(2, 8)
    assert sorted(cache[0]["b0"]) == ["conv", "h"]
    j_leaves = jax.tree.leaves(j_init(JLM(jconfigs.get(
        "mamba2_1_3b", reduced=True)).param_defs(), jax.random.PRNGKey(0)))
    assert len(leaves) == len(j_leaves)
