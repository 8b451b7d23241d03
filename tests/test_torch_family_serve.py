"""The port's LM families on the serving path and in their property tests,
against the JAX package on the CPU: `ServeEngine` over the reduced hybrid,
ssm and moe configs against the reference engine (tokens and priced
overlap), the twins of test_moe_properties.py (the capacity dispatch,
held against the reference's `moe_block` too) and of test_arch_smoke.py's
config tests, and examples/serve_decode_torch.py run without JAX."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro.models.transformer import LM as JLM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVED = ["recurrentgemma_2b", "mamba2_1_3b", "llama4_maverick_400b_a17b"]


def _models(arch, seed=0, impl="flash"):
    jcfg = dataclasses.replace(jconfigs.get(arch, reduced=True),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get(arch, reduced=True),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32, attn_impl=impl)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = LM(tcfg, device="cpu")
    return jm, params, tm, tm.load_reference_params(
        jax.tree.map(np.asarray, params))


def _run_engine(engine, req_cls, prompts, n):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(rid=i, prompt=p, max_new_tokens=n))
    done = engine.run_until_drained()
    return {r.rid: r.generated for r in done}


@pytest.mark.parametrize("arch", SERVED)
def test_engine_matches_reference_engine(arch):
    """The hybrid, ssm and moe families through 2 slots: 3 prompts of
    heterogeneous lengths give the reference engine's tokens, and the slot
    pool's price per slot counts the RG-LRU / SSD states as the
    reference's does."""
    jm, params, tm, tp = _models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 19, 5)]
    jengine = JServeEngine(jm, params, JEngineConfig(slots=2, max_seq=64))
    want = _run_engine(jengine, JRequest, prompts, 6)
    engine = ServeEngine(tm, tp, EngineConfig(slots=2, max_seq=64),
                         device="cpu")
    got = _run_engine(engine, Request, prompts, 6)
    assert got == want
    assert engine.kv_slots.occupancy == 0.0
    assert engine.kv_slots.capacity_bytes == jengine.kv_slots.capacity_bytes


@pytest.mark.parametrize("arch", SERVED)
def test_engine_overlap_pricing_matches_reference(arch):
    """The twin of test_serve_engine.py::test_engine_overlap_pricing (which
    runs on mamba2): the priced admission overlap is the reference's
    exactly."""
    jm, params, tm, tp = _models(arch, seed=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jm.cfg.vocab_size, 4).astype(np.int32)
               for _ in range(2)]
    for admit, decode in ((1e-3, 4e-4), (1e-4, 5e-4)):
        stats = []
        for engine, mk in (
                (JServeEngine(jm, params, JEngineConfig(
                    slots=2, max_seq=48, admit_cost_s=admit,
                    decode_cost_s=decode)), JRequest),
                (ServeEngine(tm, tp, EngineConfig(
                    slots=2, max_seq=48, admit_cost_s=admit,
                    decode_cost_s=decode), device="cpu"), Request)):
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


def test_engine_serves_vlm_text_and_refuses_encdec():
    """internvl2 through the engine with text-only requests (as the
    reference's `_admit` passes only tokens) gives the reference engine's
    tokens; an encoder-decoder is refused, its requests carry no frames."""
    jm, params, tm, tp = _models("internvl2_1b")
    prompts = [np.arange(n, dtype=np.int32) * 7 % jm.cfg.vocab_size
               for n in (6, 9)]
    want = _run_engine(JServeEngine(jm, params, JEngineConfig(
        slots=2, max_seq=32)), JRequest, prompts, 4)
    got = _run_engine(ServeEngine(tm, tp, EngineConfig(slots=2, max_seq=32),
                                  device="cpu"), Request, prompts, 4)
    assert got == want
    _, _, wm, wp = _models("whisper_small")
    with pytest.raises(ValueError, match="frames"):
        ServeEngine(wm, wp, EngineConfig(slots=2, max_seq=32), device="cpu")


def _moe_cfgs(E, k, cf, D=16, Fd=32):
    kw = dict(name="t", family="moe", num_layers=1, d_model=D, num_heads=2,
              num_kv_heads=2, d_ff=Fd, vocab_size=64, moe_experts=E,
              moe_top_k=k, moe_capacity_factor=cf)
    return (JConfig(**kw, param_dtype=jnp.float32, compute_dtype=jnp.float32),
            ModelConfig(**kw, param_dtype=torch.float32,
                        compute_dtype=torch.float32))


def _moe_params(jcfg, seed):
    jp = jax.tree.map(np.asarray, j_init(JL.moe_defs(jcfg),
                                         jax.random.PRNGKey(seed)))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _dense_reference(p, x, cfg):
    """Ground truth: route every token to its top-k experts, no capacity
    (test_moe_properties.py's, in torch)."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    gates, sel = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(cfg.moe_experts):
        h = torch.nn.functional.silu(xf @ p["w1"][e]) * (xf @ p["w3"][e])
        w = (gates * (sel == e)).sum(-1)[:, None]
        out = out + w * (h @ p["w2"][e])
    return out.reshape(B, S, D)


@pytest.mark.parametrize("seed,E,k", [(0, 2, 1), (11, 4, 2), (27, 8, 1),
                                      (53, 8, 2)])
def test_lossless_capacity_matches_dense_routing(seed, E, k):
    """The twin of test_moe_properties.py's (hypothesis there, fixed draws
    here): capacity >> tokens drops nothing, so the dispatch equals dense
    top-k routing; and the port's moe_block equals the reference's."""
    jcfg, tcfg = _moe_cfgs(E, k, cf=1000.0)
    jp, tp = _moe_params(jcfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal((2, 8, 16)
                                                       ).astype(np.float32)
    got = TL.moe_block(tp, torch.from_numpy(x), tcfg)
    want = _dense_reference(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    ref = JL.moe_block(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 17, 42])
def test_dropped_tokens_output_zero_not_garbage(seed):
    """256 tokens into 2 experts of 8 slots: every token's output is its
    dense-routing value (kept) or exactly zero (dropped), at most 16 are
    kept, and the port drops exactly the tokens the reference drops."""
    jcfg, tcfg = _moe_cfgs(E=2, k=1, cf=1e-9)
    jp, tp = _moe_params(jcfg, seed)
    x = np.random.default_rng(seed + 2).standard_normal((8, 32, 16)
                                                       ).astype(np.float32)
    out = TL.moe_block(tp, torch.from_numpy(x), tcfg).numpy().reshape(-1, 16)
    dense = _dense_reference(tp, torch.from_numpy(x), tcfg
                             ).numpy().reshape(-1, 16)
    kept = np.abs(out).sum(-1) > 1e-9
    np.testing.assert_allclose(out[kept], dense[kept], rtol=2e-4, atol=2e-4)
    assert kept.sum() <= 2 * 8 + 1
    assert (~kept).any()
    ref = np.asarray(JL.moe_block(jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(x), jcfg)).reshape(-1, 16)
    assert ((np.abs(ref).sum(-1) > 1e-9) == kept).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_aux_loss_balanced_router_is_minimal():
    """The twin of test_moe_properties.py's: a zero router gives the
    balanced floor 1.0; a random one the reference's loss."""
    jcfg, tcfg = _moe_cfgs(E=4, k=1, cf=1.25)
    jp, tp = _moe_params(jcfg, 0)
    x = np.random.default_rng(1).standard_normal((4, 32, 16)
                                                 ).astype(np.float32)
    aux = TL.moe_aux_loss(tp, torch.from_numpy(x), tcfg)
    want = JL.moe_aux_loss(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                           jcfg)
    assert abs(aux.item() - float(want)) < 1e-5
    tp["router"] = torch.zeros_like(tp["router"])
    assert TL.moe_aux_loss(tp, torch.from_numpy(x), tcfg).item() >= 1.0 - 1e-3


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_full_config_matches_assignment(arch):
    """The twin of test_arch_smoke.py's: the full (published) configs carry
    the exact assigned dimensions."""
    expected = {
        "llama4_maverick_400b_a17b": (48, 5120, 40, 8, 8192, 202048),
        "arctic_480b": (35, 7168, 56, 8, 4864, 32000),
        "minicpm_2b": (40, 2304, 36, 36, 5760, 122753),
        "h2o_danube_1_8b": (24, 2560, 32, 8, 6912, 32000),
        "qwen3_14b": (40, 5120, 40, 8, 17408, 151936),
        "qwen2_1_5b": (28, 1536, 12, 2, 8960, 151936),
        "internvl2_1b": (24, 896, 14, 2, 4864, 151655),
        "whisper_small": (12, 768, 12, 12, 3072, 51865),
        "recurrentgemma_2b": (26, 2560, 10, 1, 7680, 256000),
        "mamba2_1_3b": (48, 2048, 0, 0, 0, 50280),
    }[arch]
    cfg = tconfigs.get(arch)
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size)
    assert got == expected
    LM(cfg, device="cpu").param_defs()       # every family builds


def test_moe_active_param_fraction():
    """The twin of test_arch_smoke.py's: llama4 ~400B total, ~17B active
    (routed experts count top_k / E, as the reference's
    `active_param_count`)."""
    cfg = tconfigs.get("llama4_maverick_400b_a17b")
    defs = LM(cfg, device="cpu").param_defs()

    def active(tree):
        if hasattr(tree, "init"):
            n = param_count(tree)
            if "expert" in tree.axes:
                n = n * cfg.moe_top_k // cfg.moe_experts
            return n
        items = tree if isinstance(tree, list) else tree.values()
        return sum(active(t) for t in items)

    total = param_count(defs)
    assert 3.5e11 < total < 4.5e11, total
    assert 1.2e10 < active(defs) < 2.2e10, active(defs)


def test_vlm_decode_starts_after_the_patches():
    """A vlm prompt's cache holds its patches first, so decoding continues
    at patches + prompt: there the reference's own decode step meets its
    teacher-forced logits (and the port's does too), while at the prompt's
    length, where examples/serve_decode.py decodes, it overwrites a
    prefilled row and misses by far more (ROADMAP.md Queue 3)."""
    jm, params, tm, tp = _models("internvl2_1b", impl="einsum")
    cfg = jm.cfg
    rng = np.random.default_rng(0)
    B, S, P = 2, 16, cfg.frontend_tokens
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    patches = (rng.standard_normal((B, P, cfg.d_model)) * 0.1
               ).astype(np.float32)
    tf = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks),
                                        "patches": jnp.asarray(patches)}))
    errs = {}
    for idx in (S, P + S):
        c = jm.init_cache(B, S + P + 8)
        _, c = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S]),
                                   "patches": jnp.asarray(patches)}, c)
        lg, _ = jm.decode_step(params, jnp.asarray(toks[:, S:]), c,
                               jnp.int32(idx))
        errs[idx] = np.abs(np.asarray(lg[:, 0]) - tf[:, P + S]).max()
    assert errs[P + S] < 1e-4 and errs[S] > 1e-2, errs
    cache = tm.init_cache(B, S + P + 8)
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S]),
                               "patches": torch.from_numpy(patches)}, cache)
    lg, _ = tm.decode_step(tp, torch.from_numpy(toks[:, S:]), cache, P + S)
    assert np.abs(lg[:, 0].numpy() - tf[:, P + S]).max() < 1e-4


@pytest.mark.parametrize("arch", ["whisper_small", "internvl2_1b",
                                  "recurrentgemma_2b"])
def test_serve_decode_example_runs_on_cpu_without_jax(arch):
    """examples/serve_decode_torch.py on the reduced config with
    `--device cpu`, with JAX and the JAX package unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            "import runpy\n"
            f"sys.argv = ['serve_decode_torch.py', '--device', 'cpu', "
            f"'--arch', {arch!r}, '--batch', '2', '--prompt-len', '8', "
            f"'--new-tokens', '4']\n"
            f"runpy.run_path({str(ROOT / 'examples' / 'serve_decode_torch.py')!r},"
            " run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    name = tconfigs.get(arch).name
    assert f"{name}: prefill 2x8 in" in out.stdout
    assert "decoded 4 tokens/seq" in out.stdout
