"""The port's launch modules (`launch.mesh`, `launch.specs`,
`launch.roofline`, `launch.dryrun`), the pspec functions of
`models.common` and `train.optimizer`, and `attn_impl="flash_stub"`
against the JAX package's on the CPU.

The reference's spec functions read only `mesh.shape`, so they are fed
`jax.sharding.AbstractMesh`es of the production shapes (no 256 devices).
Parity classes: every PartitionSpec, `active_param_count`,
`analytic_attn_flops` (floats bit-equal), `scan_ladder` and
`cell_filename` exact; the `flash_stub` logits and loss within 1e-5 in
f32.  The port's own counts are held to hand reckonings.
"""
import dataclasses
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.launch import dryrun, roofline, specs  # noqa: E402
from repro_torch.launch.mesh import (Mesh, P, Placed,  # noqa: E402
                                     batch_axes, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

# the reference's dry-run module sets XLA_FLAGS (512 host devices) when it
# is imported; with the backend already up the flag is inert, and it is
# put back for whatever this worker runs next
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

ARCHS = jconfigs.ARCH_IDS
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}


def _dtype(jdt) -> torch.dtype:
    return _DTYPES[np.dtype(jdt).name]


REDUCED = dict(num_layers=2, vocab_size=512, vocab_pad_to=64, d_model=64,
               num_heads=4, num_kv_heads=2, d_ff=128)


def _meshes(multi_pod):
    shape, names = MESHES[multi_pod]
    return AbstractMesh(shape, names), Mesh(shape, names)


def _flat(tree, path=""):
    """path -> leaf of nested dicts, lists and tuples; specs are leaves."""
    if isinstance(tree, (JP, P, Placed)) or not isinstance(
            tree, (dict, list, tuple)):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}"))
    return out


def _same_specs(jtree, ttree):
    j, t = _flat(jtree), _flat(ttree)
    assert j.keys() == t.keys()
    for k in j:
        assert isinstance(t[k], P), k
        assert tuple(j[k]) == tuple(t[k]), (k, j[k], t[k])


# -- meshes and specs ------------------------------------------------------------
def test_production_meshes_and_batch_axes():
    for multi_pod in (False, True):
        jmesh, _ = _meshes(multi_pod)
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.shape == dict(jmesh.shape)
        assert mesh.size == (512 if multi_pod else 256)
        assert mesh.devices == () and mesh.device_type == "meta"
        from repro.launch.mesh import batch_axes as jbatch_axes
        assert batch_axes(multi_pod) == jbatch_axes(multi_pod)


def test_host_mesh_defaults_to_the_card(monkeypatch):
    mesh = make_host_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(ValueError, match="real devices"):
        make_host_mesh("meta")


def test_partition_spec_is_a_value_like_the_reference():
    for entries in ((("data",), None), (("pod", "data"), "model"), ((),),
                    (None,), ("data", "model"), ()):
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P(("data",), None) == P("data", None)
    assert P("data", "model") == ("data", "model")
    assert P("data") != P("data", None)
    assert P(("pod", "data"), None, "model").axes() == ("pod", "data",
                                                        "model")
    assert make_production_mesh().split(P(("data",), "model")) == 256


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp", "ep_tp", "dp"])
def test_sharding_rules_match_reference(strategy, multi_pod):
    assert common.sharding_rules(strategy, multi_pod) == \
        jcommon.sharding_rules(strategy, multi_pod)


def test_unknown_strategy_raises():
    with pytest.raises(ValueError):
        common.sharding_rules("zero3")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch):
    """Every leaf's spec for every strategy on both meshes, and the
    abstract params: meta tensors of the leaf's shape and dtype placed as
    its spec."""
    jdefs = JLM(jconfigs.get(arch)).param_defs()
    tdefs = LM(tconfigs.get(arch), device="meta").param_defs()
    for multi_pod in (False, True):
        jmesh, mesh = _meshes(multi_pod)
        for strategy in ("tp", "fsdp_tp", "ep_tp", "dp"):
            jrules = jcommon.sharding_rules(strategy, multi_pod)
            rules = common.sharding_rules(strategy, multi_pod)
            want = jcommon.param_pspecs(jdefs, jrules, jmesh)
            _same_specs(want, common.param_pspecs(tdefs, rules, mesh))
        placed = _flat(common.abstract_params(tdefs, rules, mesh))
        jd = _flat(jax.tree.map(lambda d: d, jdefs,
                                is_leaf=lambda x: isinstance(
                                    x, jcommon.ParamDef)))
        flat_want = _flat(want)
        for k, p in placed.items():
            assert p.value.device.type == "meta"
            assert p.shape == jd[k].shape
            assert p.dtype == _dtype(jd[k].dtype)
            assert tuple(p.sharding.spec) == tuple(flat_want[k])
            assert p.sharding.mesh is mesh


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_pspecs_match_reference(arch):
    """AdamW and Adafactor state specs, with and without ZeRO-1, on both
    meshes and under the arch's default strategy."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jdefs = JLM(jcfg).param_defs()
    tdefs = LM(tcfg, device="meta").param_defs()
    strategy = "fsdp_tp" if jcfg.moe_experts else "tp"
    for multi_pod in (False, True):
        jmesh, mesh = _meshes(multi_pod)
        jps = jcommon.param_pspecs(
            jdefs, jcommon.sharding_rules(strategy, multi_pod), jmesh)
        tps = common.param_pspecs(
            tdefs, common.sharding_rules(strategy, multi_pod), mesh)
        jshapes = jax.tree.map(lambda d: d.shape, jdefs,
                               is_leaf=lambda x: isinstance(
                                   x, jcommon.ParamDef))
        tshapes = common.tree_map_defs(lambda d: d.shape, tdefs)
        for name in ("adamw", "adafactor"):
            for zero1 in (True, False):
                _same_specs(jopt.opt_state_pspecs(name, jshapes, jps, jmesh,
                                                  zero1),
                            opt.opt_state_pspecs(name, tshapes, tps, mesh,
                                                 zero1))


def test_zero1_pspec_places_data_axis():
    mesh = make_host_mesh("cpu")        # (1, 1) ("data", "model")
    # dim0 replicated & divisible -> gets 'data'
    assert opt.zero1_pspec(P(None, "model"), (8, 16), mesh) \
        == P("data", "model")
    # model dim untouched, no divisible dim -> unchanged
    assert opt.zero1_pspec(P("model",), (7,), mesh) == P("model")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_abstract_state_matches_reference(name):
    """The optimizer state on meta: the reference's eval_shape tree, leaf
    for leaf in shape and dtype."""
    cfg = dataclasses.replace(tconfigs.get("arctic_480b", reduced=True))
    jcfg = jconfigs.get("arctic_480b", reduced=True)
    mesh = make_host_mesh("cpu")
    tdefs = LM(cfg, device="meta").param_defs()
    params = common.abstract_params(tdefs, common.sharding_rules("tp"),
                                    mesh)
    jdefs = JLM(jcfg).param_defs()
    jparams = jax.tree.map(
        lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype), jdefs,
        is_leaf=lambda x: isinstance(x, jcommon.ParamDef))
    want = _flat(jopt.abstract_state(name, jparams, jopt.OptimizerConfig(
        name=name)))
    got = _flat(opt.abstract_state(name, params, opt.OptimizerConfig(
        name=name)))
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == _dtype(want[k].dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_activation_specs_match_reference(arch):
    for multi_pod in (False, True):
        jmesh, mesh = _meshes(multi_pod)
        for two_d in (False, True):
            jcfg = dataclasses.replace(jconfigs.get(arch),
                                       moe_2d_dispatch=two_d)
            tcfg = dataclasses.replace(tconfigs.get(arch),
                                       moe_2d_dispatch=two_d)
            for kind in ("train", "prefill", "decode"):
                for batch in (None, 1, 32, 256):
                    for e_ax in ("model", "data"):
                        try:
                            want = jspecs.activation_specs(
                                jcfg, jmesh, multi_pod, batch=batch,
                                kind=kind, expert_axis=e_ax)
                        except Exception as e:  # noqa: BLE001
                            # JAX refuses a spec naming "data" twice (the
                            # 2-D dispatch with experts over data)
                            assert type(e).__name__ == "DuplicateSpecError"
                            with pytest.raises(ValueError, match="more "
                                               "than one"):
                                specs.activation_specs(
                                    tcfg, mesh, multi_pod, batch=batch,
                                    kind=kind, expert_axis=e_ax)
                            continue
                        got = specs.activation_specs(
                            tcfg, mesh, multi_pod, batch=batch, kind=kind,
                            expert_axis=e_ax)
                        assert want.keys() == got.keys()
                        for k in want:
                            assert tuple(got[k].spec) == \
                                tuple(want[k].spec), (k, kind, batch)
                            assert got[k].mesh is mesh


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspec_tree_matches_reference(arch):
    jm, tm = JLM(jconfigs.get(arch)), LM(tconfigs.get(arch), device="meta")
    for multi_pod in (False, True):
        jmesh, mesh = _meshes(multi_pod)
        for shape in specs.SHAPES.values():
            for kind in ("prefill", "decode"):
                _same_specs(
                    jspecs.cache_pspec_tree(jm, jmesh, shape["batch"],
                                            shape["seq"], multi_pod, kind),
                    specs.cache_pspec_tree(tm, mesh, shape["batch"],
                                           shape["seq"], multi_pod, kind))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for multi_pod in (False, True):
        jmesh, mesh = _meshes(multi_pod)
        for batch, seq in ((256, 4096), (32, 32768), (24, 512), (1, 300)):
            want = jspecs.batch_specs(jcfg, jmesh, batch, seq, multi_pod)
            got = specs.batch_specs(tcfg, mesh, batch, seq, multi_pod)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].shape == tuple(want[k].shape)
                assert got[k].dtype == _dtype(want[k].dtype)
                assert got[k].value.device.type == "meta"
                assert tuple(got[k].sharding.spec) == \
                    tuple(want[k].sharding.spec)


# -- dry-run accounting ----------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_attention_flops_match_reference(arch):
    """active_param_count, and analytic_attn_flops for every shape and
    kind at 256 and 512 chips, floats bit-equal."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert dryrun.active_param_count(LM(tcfg, device="meta")) == \
        jdry.active_param_count(JLM(jcfg))
    for shape in specs.SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            for chips in (256, 512):
                for impl_cfg in (jcfg, dataclasses.replace(jcfg,
                                                           attn_window=512)):
                    tc = dataclasses.replace(
                        tcfg, attn_window=impl_cfg.attn_window)
                    want = jdry.analytic_attn_flops(
                        impl_cfg, kind, shape["batch"], shape["seq"], chips)
                    got = dryrun.analytic_attn_flops(
                        tc, kind, shape["batch"], shape["seq"], chips)
                    assert type(got) is type(want)
                    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_ladder_and_cell_filename_match_reference(arch):
    assert dryrun.scan_ladder(tconfigs.get(arch)) == \
        jdry.scan_ladder(jconfigs.get(arch))
    for shape in specs.SHAPES:
        for multi_pod in (False, True):
            for tag in ("", "stub"):
                assert dryrun.cell_filename(arch, shape, multi_pod, tag) == \
                    jdry.cell_filename(arch, shape, multi_pod, tag)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for shape in specs.SHAPES:
        assert specs.cell_supported(tcfg, shape) == \
            jspecs.cell_supported(jcfg, shape)
    assert specs.optimizer_for(tcfg).name == jspecs.optimizer_for(jcfg).name


def test_moe_active_param_fraction():
    """llama4: ~400B total, ~17B active (the name's contract)."""
    model = LM(tconfigs.get("llama4_maverick_400b_a17b"), device="meta")
    total = common.param_count(model.param_defs())
    active = dryrun.active_param_count(model)
    assert 3.5e11 < total < 4.5e11, total
    assert 1.2e10 < active < 2.2e10, active


def test_cell_builder_on_host_mesh():
    """build_cell gives abstract arguments the step runs on, on the meta
    device: params, the AdamW state and the batch, placed on the host
    mesh; the step's outputs come back as meta tensors."""
    mesh = make_host_mesh("cpu")
    cell = specs.build_cell("qwen2_1_5b", "train_4k", mesh, multi_pod=False,
                            overrides=REDUCED)
    assert cell.kind == "train"
    params, state, batch = cell.args()
    assert isinstance(state, opt.AdamWState)
    assert batch["tokens"].shape == (256, 4096)
    assert all(t.device.type == "meta" for t in opt.leaves(params))
    new_params, new_state, metrics = cell.step_fn(*cell.args())
    assert new_params is not None and metrics["loss"].device.type == "meta"
    assert cell.abstract_args[2]["tokens"].sharding.spec == P("data", None)


def test_serve_cell_builder_on_host_mesh():
    mesh = make_host_mesh("cpu")
    cell = specs.build_cell("mamba2_1_3b", "decode_32k", mesh,
                            multi_pod=False,
                            overrides={"num_layers": 2, "vocab_size": 512,
                                       "vocab_pad_to": 64, "d_model": 64,
                                       "ssm_state": 16, "ssm_headdim": 8,
                                       "ssm_chunk": 8})
    token, cache = cell.step_fn(*cell.args())
    assert cell.kind == "decode"
    assert token.shape == (128, 1) and token.dtype == torch.int32
    assert cell.abstract_args[3].shape == ()


def test_build_cell_refuses_a_model_off_meta():
    model = LM(tconfigs.get("qwen2_1_5b", reduced=True), device="cpu")
    with pytest.raises(ValueError, match="meta"):
        specs.abstract_cache(model, make_host_mesh("cpu"), 2, 8, False)


def _matmul_flops(cfg, B, S) -> int:
    """Forward FLOPs of the reduced dense LM's products: q, k, v, o, the
    score and value einsums, the gated MLP and the tied head."""
    D, H, KV, hd, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.hd, cfg.d_ff, cfg.padded_vocab)
    T = B * S
    per_layer = 2 * T * D * (H * hd + 2 * KV * hd) + 2 * T * H * hd * D \
        + 2 * (2 * B * H * S * S * hd) + 3 * 2 * T * D * F
    return cfg.num_layers * per_layer + 2 * T * D * V


def test_flop_count_of_a_train_step_equals_the_hand_count():
    """FlopCounterMode over a reduced qwen2 train step on meta (every
    product's two gradients, 3 x the forward) equals the hand count; with
    remat the recomputed forward adds at most one forward more."""
    B, S = 256, 4096                            # train_4k
    counts = {}
    for remat in (False, True):
        cell = specs.build_cell("qwen2_1_5b", "train_4k",
                                make_host_mesh("cpu"), multi_pod=False,
                                overrides={**REDUCED, "num_layers": 3,
                                           "remat": remat})
        _, c = roofline.count(cell.step_fn, *cell.args())
        counts[remat] = c.flops
    fwd = _matmul_flops(cell.cfg, B, S)
    assert counts[False] == 3 * fwd
    assert 3 * fwd < counts[True] <= 4 * fwd


def test_op_counter_counts_bytes_and_live_storage():
    a = torch.empty(16, 8, device="meta")
    b = torch.empty(16, 8, device="meta")

    def step(a, b):
        c = a + b                  # reads 2 x 512, writes 512
        d = c.t()                  # a view: nothing
        e = d.contiguous()         # reads 512, writes 512
        del c, d
        e.add_(1.0)                # in place: reads and writes 512
        a.copy_(e.t())             # writes 512
        return e

    out, c = roofline.count(step, a, b)
    assert c.hbm_bytes == 3 * 512 + 2 * 512 + 2 * 512 + 2 * 512
    assert c.temp_peak_bytes == 2 * 512     # c and e, not a's update
    assert c.flops == 0 and c.ops == 4


def test_analyze_uses_the_h100_peaks():
    r = roofline.analyze(989e12, 3.35e12, 450e9, model_flops=0.5 * 989e12,
                         chips=1)
    assert (r.compute_term, r.memory_term, r.collective_term) == (1.0, 1.0,
                                                                   1.0)
    assert r.useful_ratio == 0.5
    r = roofline.analyze(1.0, 2 * 3.35e12, 0.0, chips=4)
    assert r.bottleneck == "memory" and r.step_time_s == 2.0


@pytest.mark.parametrize("arch,over", [
    ("qwen2_1_5b", {}),
    ("llama4_maverick_400b_a17b", {"num_layers": 4, "moe_experts": 4}),
    ("recurrentgemma_2b", {"num_layers": 8}),
    ("whisper_small", {"num_layers": 3, "encoder_layers": 3})])
def test_ladder_extrapolation_equals_the_direct_count(arch, over):
    """The reference's depth ladder over the port's counts gives the full
    depth's flops, bytes and collective bytes exactly: a layer costs the
    same wherever it sits in the Python loop."""
    red = tconfigs.get(arch, reduced=True)
    full = tconfigs.get(arch)
    overrides = {f.name: getattr(red, f.name)
                 for f in dataclasses.fields(red)
                 if getattr(red, f.name) != getattr(full, f.name)
                 and f.name != "name"}
    overrides.update(over)
    base = dataclasses.replace(full, **overrides)
    mesh = make_production_mesh()
    for shape in ("train_4k", "decode_32k"):
        if not specs.cell_supported(base, shape)[0]:
            continue
        direct = dryrun.cost_cell(
            specs.build_cell(arch, shape, mesh, multi_pod=False,
                             overrides=overrides), mesh, False)
        ladder = dryrun.extrapolated_cost(arch, shape, mesh, False, None,
                                          overrides, base)
        for k in ("flops", "hbm", "coll"):
            assert ladder[k] == pytest.approx(direct[k], rel=1e-12), k


def test_run_cell_decode_on_meta_matches_the_spec_reckoning():
    """qwen2-1.5b decode_32k on the 16 x 16 mesh: OK, and the cache
    argument per device is the reckoning from its spec (batch 128 over 16
    data shards, 32768 positions over 16 model shards)."""
    rec = dryrun.run_cell("qwen2_1_5b", "decode_32k", False)
    assert rec["status"] == "OK" and rec["chips"] == 256
    cfg = tconfigs.get("qwen2_1_5b")
    per_kv = cfg.num_layers * (128 // 16) * (32768 // 16) \
        * cfg.num_kv_heads * cfg.hd * 2
    assert rec["memory"]["argument_bytes_by_arg"][2] == 2 * per_kv
    assert rec["memory"]["alias_bytes"] == 2 * per_kv
    params = common.param_count(LM(cfg, device="meta").param_defs())
    assert rec["active_params"] == params
    assert rec["tokens_per_step"] == 128
    r = rec["roofline"]
    assert r["model_flops"] == 2 * params * 128
    assert r["step_time_s"] == max(r["compute_term"], r["memory_term"],
                                   r["collective_term"])
    assert rec["collectives"]["all-gather"] == 0.0      # tp: no fsdp dims


def test_flash_stub_cell_adds_the_analytic_flops():
    over = {**REDUCED, "attn_impl": "flash_stub"}
    rec = dryrun.run_cell("qwen2_1_5b", "prefill_32k", False, overrides=over)
    plain = dryrun.run_cell("qwen2_1_5b", "prefill_32k", False,
                            overrides={**over, "attn_impl": "einsum"})
    cfg = dataclasses.replace(tconfigs.get("qwen2_1_5b"), **over)
    stub_flops = rec["roofline"]["flops"] - rec["cost"]["flops"]
    assert stub_flops == dryrun.analytic_attn_flops(cfg, "prefill", 32,
                                                    32768, 256)
    # the stub reads K/V once: no S^2 score tensor
    assert rec["cost"]["hbm"] < plain["cost"]["hbm"] / 10


def test_dryrun_main_writes_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    assert dryrun.main(["--arch", "qwen2_1_5b", "--shape", "long_500k"]) == 0
    rec = json.loads((tmp_path / "qwen2_1_5b_long_500k_16x16.json")
                     .read_text())
    assert rec["status"] == "SKIP(full-attention)"
    assert dryrun.main(["--arch", "mamba2_1_3b", "--shape", "decode_32k",
                        "--multi-pod", "--tag", "t", "--override",
                        "num_layers=2"]) == 0
    rec = json.loads((tmp_path / "mamba2_1_3b_decode_32k_2x16x16_t.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["chips"] == 512
    assert "bottleneck=" in capsys.readouterr().out
    assert dryrun.main(["--arch", "qwen2_1_5b", "--shape", "train_4k",
                        "--strategy", "zero3"]) == 1
    rec = json.loads((tmp_path / "qwen2_1_5b_train_4k_16x16.json")
                     .read_text())
    assert rec["status"].startswith("FAIL: ValueError")


# -- flash_stub and the meta device ----------------------------------------------
def test_flash_stub_matches_reference():
    """The dry-run stand-in at reduced qwen2 in f32: logits and loss within
    1e-5 of the reference's stub, prefill and decode through the cache."""
    jcfg = dataclasses.replace(jconfigs.get("qwen2_1_5b", reduced=True),
                               attn_impl="flash_stub",
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get("qwen2_1_5b", reduced=True),
                               attn_impl="flash_stub",
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tcfg, device="cpu")
    tp = tm.load_reference_params(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(jm.forward(params, {"tokens": jnp.asarray(tokens)}))
    got = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    jloss = float(jm.loss(params, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)}))
    tloss = float(tm.loss(tp, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)}))
    assert tloss == pytest.approx(jloss, rel=1e-5, abs=1e-5)
    jcache = jm.init_cache(2, 32)
    _, jcache = jm.prefill(params, {"tokens": jnp.asarray(tokens)}, jcache)
    jstep, _ = jm.decode_step(params, jnp.asarray(tokens[:, :1]), jcache, 16)
    tcache = tm.init_cache(2, 32)
    tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, tcache)
    tstep, _ = tm.decode_step(tp, torch.from_numpy(tokens[:, :1]), tcache,
                              16)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), rtol=1e-5,
                               atol=1e-5)


def test_meta_tensors_never_reach_a_kernel():
    from repro_torch.kernels import ops
    idx = torch.empty(8, dtype=torch.int32, device="meta")
    feats = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="meta tensor"):
        ops.segment_mean(idx, feats)
    cfg = dataclasses.replace(tconfigs.get("qwen2_1_5b", reduced=True),
                              attn_impl="flash")
    model = LM(cfg, device="meta")
    params = common.abstract_params(model.param_defs(),
                                    common.sharding_rules("tp"),
                                    make_host_mesh("cpu"))
    from repro_torch.launch.mesh import values
    tokens = torch.empty(2, 8, dtype=torch.int32, device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="meta tensor"):
        model.forward(values(params), {"tokens": tokens})


def test_meta_is_taken_only_when_named():
    from repro_torch import resolve_device
    assert resolve_device("meta").type == "meta"
    assert LM(tconfigs.get("qwen2_1_5b"), device="meta").device.type == \
        "meta"
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("mps")


def test_dryrun_costs_a_step_without_a_card(monkeypatch):
    """The dry-run never asks for a card: with CUDA reported absent, a
    full-width train cell on the 2 x 16 x 16 mesh costs on meta."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = dryrun.run_cell("mamba2_1_3b", "train_4k", True)
    assert rec["status"] == "OK"
    mem = rec["memory"]
    assert mem["peak_per_device_gib"] == pytest.approx(
        (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
         - mem["alias_bytes"]) / 2**30)
    assert math.isfinite(rec["roofline"]["useful_ratio"])


def test_scalar_index_tensor_decodes_like_an_int():
    """The decode cell passes its index as a 0-dim int32 tensor, which the
    attention reads without a host sync: the same logits as an int."""
    cfg = dataclasses.replace(tconfigs.get("qwen2_1_5b", reduced=True),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    logits = []
    for index in (9, torch.tensor(9, dtype=torch.int32)):
        cache = model.init_cache(2, 16)
        model.prefill(params, {"tokens": tokens}, cache)
        out, _ = model.decode_step(params, tokens[:, :1], cache, index)
        logits.append(out)
    assert torch.equal(logits[0], logits[1])
