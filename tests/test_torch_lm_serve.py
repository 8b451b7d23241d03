"""The port's LM serving slice (`repro_torch.models.transformer.LM`,
`repro_torch.serve.ServeEngine`) against the JAX package on the reduced
dense configs, in f32 on the CPU: the same parameters (the reference's,
carried over) and the same numpy tokens go through both.  On the CPU the
port's flash path runs `attention_ref`; the reference's runs its Pallas
kernel in interpret mode."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.common import ModelConfig as JConfig  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.models.common import param_count as j_param_count  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.core.dataplane import DataPlaneSpec  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve import (EngineConfig, EngineNotDrained,  # noqa: E402
                               KVSlotTier, Request, ServeEngine)

DENSE = ["qwen3_14b", "qwen2_1_5b", "minicpm_2b", "h2o_danube_1_8b"]


def _models(arch, impl="einsum", seed=42, f32=True):
    """The reference's model and params, and the port's model with the same
    params carried over."""
    jcfg = jconfigs.get(arch, reduced=True)
    tcfg = tconfigs.get(arch, reduced=True)
    if f32:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                   compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.float32,
                                   compute_dtype=torch.float32)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = LM(dataclasses.replace(tcfg, attn_impl=impl), device="cpu")
    tp = tm.load_reference_params(jax.tree.map(np.asarray, params))
    return jm, params, tm, tp


@pytest.mark.parametrize("norm_type,act", [("rms", "silu_gated"),
                                            ("layernorm", "gelu")])
def test_norm_mlp_and_rope_match_reference(norm_type, act):
    """The layers no reduced dense config reaches in full: layer norm, the
    gelu MLP, and rope at per-sequence positions."""
    kw = dict(name="t", family="dense", num_layers=1, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=64,
              norm_type=norm_type, act=act)
    jcfg = JConfig(**kw, param_dtype=jnp.float32, compute_dtype=jnp.float32)
    tcfg = ModelConfig(**kw, param_dtype=torch.float32,
                       compute_dtype=torch.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    for j_defs, t_apply, j_apply in (
            (JL.norm_defs(jcfg), TL.apply_norm, JL.apply_norm),
            (JL.mlp_defs(jcfg), TL.mlp, JL.mlp)):
        params = jax.tree.map(
            lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(
                np.float32), jax.tree.map(np.asarray,
                                          j_init(j_defs, jax.random.PRNGKey(0))))
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        want = j_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                       jcfg)
        got = t_apply(tp, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    xh = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(xh), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(JL.rope(jnp.asarray(xh), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "h2o_danube_1_8b"])
def test_forward_flash_matches_reference_flash(arch):
    """The twin of test_kernels.py::test_model_forward_flash_equals_einsum:
    teacher-forced logits through the flash path of both packages (danube
    reduced has window 16 < 32 tokens)."""
    jm, params, tm, tp = _models(arch, impl="flash", seed=3)
    jm = JLM(dataclasses.replace(jm.cfg, attn_impl="flash"))
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, (2, 32)).astype(np.int32)
    want = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, jm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_reference_teacher_forcing(arch, impl):
    """The twin of test_decode_consistency.py: the port's prefill plus
    incremental decode against the reference's einsum teacher-forced
    logits, below 1e-3."""
    jm, params, tm, tp = _models(arch, impl=impl)
    B, S, E = 2, 16, 4
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (B, S + E)).astype(np.int32)
    tf_logits = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    cache = tm.init_cache(B, S + E)
    lg, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                           cache)
    errs = [np.abs(lg[:, -1].numpy() - tf_logits[:, S - 1]).max()]
    for t in range(E):
        index = torch.full((B,), S + t, dtype=torch.int32)
        lg, cache = tm.decode_step(
            tp, torch.from_numpy(toks[:, S + t:S + t + 1]), cache, index)
        errs.append(np.abs(lg[:, 0].numpy() - tf_logits[:, S + t]).max())
    assert max(errs) < 1e-3, errs


def _greedy_logits(model, params, prompt, steps, max_seq):
    """Single-request greedy decoding through the port: the logits of each
    decode step, each step fed the previous step's greedy token."""
    cache = model.init_cache(1, max_seq)
    lg, cache = model.prefill(
        params, {"tokens": torch.from_numpy(prompt[None, :])}, cache)
    out = []
    for pos in range(len(prompt), len(prompt) + steps):
        tok = int(lg[0, -1].argmax())
        lg, cache = model.decode_step(
            params, torch.tensor([[tok]], dtype=torch.int32), cache,
            torch.tensor([pos], dtype=torch.int32))
        out.append(lg[0, -1].numpy())
    return np.stack(out)


def _fault_logits(model, params, prompt, feed, torch_side):
    """Logits of a 7-token prompt's prefill, a decode step at the scalar
    index 7 and one at the per-slot index [8], fed the tokens `feed`."""
    if torch_side:
        tokens = torch.from_numpy(prompt[None, :])
        tok = lambda t: torch.tensor([[t]], dtype=torch.int32)  # noqa: E731
        indices = (7, torch.tensor([8], dtype=torch.int32))
    else:
        tokens = jnp.asarray(prompt[None, :])
        tok = lambda t: jnp.asarray([[t]], jnp.int32)  # noqa: E731
        indices = (jnp.int32(7), jnp.asarray([8], jnp.int32))
    cache = model.init_cache(1, 64)
    lg, cache = model.prefill(params, {"tokens": tokens}, cache)
    out = [np.asarray(lg[0, -1], np.float32)]
    for t, index in zip(feed, indices):
        lg, cache = model.decode_step(params, tok(t), cache, index)
        out.append(np.asarray(lg[0, -1], np.float32))
    return out


def test_reference_flash_decode_fault_is_not_copied():
    """The reference's flash branch passes the whole cache with no query
    offset, so a decode step sees only cache row 0: with the same tokens
    fed, its decode logits miss its einsum path's by more than 0.5 at the
    scalar index 7 and at the per-slot index [8] (prefill agrees).  The
    port's flash path passes the cache offsets and agrees with the
    reference's einsum path at every step."""
    jm, params, tm, tp = _models("qwen2_1_5b", impl="flash", seed=0)
    jm_flash = JLM(dataclasses.replace(jm.cfg, attn_impl="flash"))
    prompt = np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, 7).astype(np.int32)
    c = jm.init_cache(1, 64)
    lg, c = jm.prefill(params, {"tokens": jnp.asarray(prompt[None])}, c)
    feed = [int(np.asarray(lg[0, -1]).argmax())]
    lg, c = jm.decode_step(params, jnp.asarray([[feed[0]]], jnp.int32), c,
                           jnp.int32(7))
    feed.append(int(np.asarray(lg[0, -1]).argmax()))
    einsum = _fault_logits(jm, params, prompt, feed, torch_side=False)
    ref_flash = _fault_logits(jm_flash, params, prompt, feed,
                              torch_side=False)
    port_flash = _fault_logits(tm, tp, prompt, feed, torch_side=True)
    ref_err = [np.abs(a - b).max() for a, b in zip(ref_flash, einsum)]
    port_err = [np.abs(a - b).max() for a, b in zip(port_flash, einsum)]
    assert ref_err[0] < 1e-6 and min(ref_err[1:]) > 0.5, ref_err
    assert max(port_err) < 1e-5, port_err


def _run_engine(engine_cls, req_cls, model, params, cfg, prompts, n):
    engine = engine_cls(model, params, cfg)
    for i, p in enumerate(prompts):
        engine.submit(req_cls(rid=i, prompt=p, max_new_tokens=n))
    done = engine.run_until_drained()
    return engine, {r.rid: r.generated for r in done}


def test_engine_matches_reference_engine_and_greedy_decoding():
    """The twin of test_serve_engine.py::test_engine_matches_single_request
    _decoding: 3 prompts through 2 slots give the reference engine's tokens,
    and those of single-request greedy decoding through the port."""
    jm, params, tm, tp = _models("qwen2_1_5b", impl="flash", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 11, 5)]          # heterogeneous lengths
    N = 6
    _, want = _run_engine(JServeEngine, JRequest, jm, params,
                          JEngineConfig(slots=2, max_seq=64), prompts, N)
    engine, got = _run_engine(
        lambda m, p, c: ServeEngine(m, p, c, device="cpu"), Request, tm, tp,
        EngineConfig(slots=2, max_seq=64), prompts, N)
    assert got == want
    assert engine.kv_slots.occupancy == 0.0
    for rid, toks in got.items():
        logits = _greedy_logits(tm, tp, prompts[rid], N - 1, 64)
        assert toks[1:] == [int(x) for x in logits.argmax(-1)], rid


def test_engine_overlap_pricing_matches_reference():
    """The twin of test_serve_engine.py::test_engine_overlap_pricing on
    qwen2: the priced admission overlap is the reference's exactly."""
    jm, params, tm, tp = _models("qwen2_1_5b", seed=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jm.cfg.vocab_size, 4).astype(np.int32)
               for _ in range(2)]
    for admit, decode in ((1e-3, 4e-4), (1e-4, 5e-4)):
        stats = []
        for side in ("reference", "port"):
            if side == "reference":
                engine = JServeEngine(jm, params, JEngineConfig(
                    slots=2, max_seq=48, admit_cost_s=admit,
                    decode_cost_s=decode))
                mk = JRequest
            else:
                engine = ServeEngine(tm, tp, EngineConfig(
                    slots=2, max_seq=48, admit_cost_s=admit,
                    decode_cost_s=decode), device="cpu")
                mk = Request
            engine.submit(mk(rid=0, prompt=prompts[0], max_new_tokens=4))
            engine.step()             # cold start: no in-flight decode
            engine.submit(mk(rid=1, prompt=prompts[1], max_new_tokens=4))
            engine.step()             # admitted behind r0's decode
            engine.run_until_drained()
            st = engine.overlap_stats
            stats.append((st.staged_batches, st.consumed_batches,
                          st.prep_s_total, st.exposed_s_total,
                          st.hidden_s_total, st.hidden_fraction))
        assert stats[0] == stats[1]
        assert stats[1][0] == 2


def test_slot_recycling_and_reference_params_round_trip():
    """qwen2 reduced in its own dtypes: the reference's bf16 parameters
    carry over bit for bit; 3 requests through 1 slot retire and free it;
    a one-token request finishes at prefill and never holds a slot."""
    jm, params, tm, tp = _models("qwen2_1_5b", seed=1, f32=False)
    leaves = jax.tree.leaves(params)
    port_leaves = [tp["embed"], tp["final_norm"]["scale"]]
    stack = tp["stacks"][0]["b0"]
    for group in ("attn", "ln1", "ln2", "mlp"):
        port_leaves += [stack[group][k] for k in sorted(stack[group])]
    assert len(leaves) == len(port_leaves)
    for want, got in zip(leaves, port_leaves):
        assert got.float().numpy().tobytes() == \
            np.asarray(want, np.float32).tobytes()
    assert tp["embed"].dtype == torch.bfloat16
    assert stack["attn"]["bq"].dtype == torch.float32   # biases stay f32

    engine = ServeEngine(tm, tp, EngineConfig(slots=1, max_seq=48),
                         device="cpu")
    assert isinstance(engine.kv_slots, KVSlotTier)
    rng = np.random.default_rng(1)
    for i in range(3):
        engine.submit(Request(rid=i, prompt=rng.integers(
            0, tm.cfg.vocab_size, 4).astype(np.int32), max_new_tokens=3))
    done = engine.run_until_drained()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.generated) == 3 for r in done)
    assert engine.kv_slots.occupancy == 0.0
    engine.submit(Request(rid=9, prompt=rng.integers(
        0, tm.cfg.vocab_size, 4).astype(np.int32), max_new_tokens=1))
    (one,) = engine.run_until_drained()
    assert one.done and len(one.generated) == 1


def test_kv_slot_tier_matches_reference():
    """The slot pool's tier protocol step for step against the reference's:
    slots handed out, hits, occupancy, bulk admission past capacity,
    recycling order and reset."""
    from repro.core import KVSlotTier as JKVSlotTier
    sides = [JKVSlotTier(3, bytes_per_slot=7), KVSlotTier(3, bytes_per_slot=7)]
    ops = [("acquire", 5), ("acquire", 9), ("acquire", 5), ("probe", [5, 1, 9]),
           ("release", 5), ("admit", [2, 4, 6]), ("acquire", 2), ("acquire", 4),
           ("probe", [2, 4, 6, 9]),
           ("acquire", 8), ("release", 9), ("acquire", 8), ("reset", None),
           ("probe", [2, 4, 8]), ("acquire", 1)]
    for op, arg in ops:
        outs = []
        for tier in sides:
            fn = getattr(tier, op)
            out = fn() if arg is None else fn(
                np.asarray(arg) if isinstance(arg, list) else arg)
            outs.append((None if out is None else np.asarray(out).tolist(),
                         tier.occupancy, tier.capacity_bytes))
        assert outs[0] == outs[1], (op, arg, outs)


def test_run_until_drained_raises_on_tick_exhaustion():
    _, _, tm, tp = _models("qwen2_1_5b", seed=1)
    engine = ServeEngine(tm, tp, EngineConfig(slots=1, max_seq=48),
                         device="cpu")
    rng = np.random.default_rng(3)
    for i in range(3):
        engine.submit(Request(rid=i, prompt=rng.integers(
            0, tm.cfg.vocab_size, 4).astype(np.int32), max_new_tokens=6))
    with pytest.raises(EngineNotDrained) as exc:
        engine.run_until_drained(max_ticks=2)
    err = exc.value
    assert err.unfinished >= 1 and err.unfinished + len(err.retired) == 3
    rest = engine.run_until_drained()
    assert len(err.retired) + len(rest) == 3
    assert not engine.queue and all(r is None for r in engine.active)


def test_full_width_qwen2_param_count_and_defs():
    """The port's parameter tree at the full published width of qwen2-1.5b
    is the reference's, leaf for leaf (nothing is materialised)."""
    cfg = tconfigs.get("qwen2_1_5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.d_ff, cfg.padded_vocab) == (28, 1536, 12, 2, 128,
                                                     8960, 153600)
    defs = LM(cfg, device="cpu").param_defs()
    jdefs = JLM(jconfigs.get("qwen2_1_5b")).param_defs()
    assert param_count(defs) == j_param_count(jdefs) == 1_546_270_208
    jleaves = jax.tree.leaves(jdefs, is_leaf=lambda d: hasattr(d, "init"))
    stack = defs["stacks"][0]["b0"]
    leaves = [defs["embed"], defs["final_norm"]["scale"]] + [
        stack[g][k] for g in ("attn", "ln1", "ln2", "mlp")
        for k in sorted(stack[g])]
    assert [(d.shape, d.init) for d in leaves] == \
        [(d.shape, d.init) for d in jleaves]


def test_entry_points_default_to_the_card(monkeypatch):
    cfg = tconfigs.get("qwen2_1_5b", reduced=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    model = LM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, None, EngineConfig())


def test_unported_families_configs_and_options_raise():
    for arch in ("arctic_480b", "llama4_maverick_400b_a17b", "mamba2_1_3b",
                 "recurrentgemma_2b", "whisper_small", "internvl2_1b"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue 1 item 10"):
            tconfigs.get(arch)
    moe = ModelConfig(name="m", family="moe", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                      moe_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 10"):
        LM(moe, device="cpu")
    cfg = tconfigs.get("qwen2_1_5b", reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11"):
        LM(dataclasses.replace(cfg, attn_impl="flash_stub"), device="cpu")
    (tier,) = DataPlaneSpec.preset("serve-kv").build_stack(slots=3,
                                                           bytes_per_slot=10)
    assert isinstance(tier, KVSlotTier) and tier.capacity_bytes == 30
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        DataPlaneSpec.preset("serve-gnn")
