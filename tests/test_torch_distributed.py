"""The port's distributed modules (`distributed.ctx`, `distributed.compression`)
and the elastic restore of `train.checkpoint` against the JAX package's on
the CPU.

Parity classes: int8 quantization, error-feedback compression and restored
leaves bit-exact; the compressed cross-axis sum bit-exact against the
reference's arithmetic over the same members; `constrain` the identity
(logits bit-equal inside and outside an activation-sharding context).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.launch.mesh import (Mesh, NamedSharding, P,  # noqa: E402
                                     make_host_mesh, make_production_mesh)
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _bits(x) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.uint8)


@pytest.fixture
def fresh_group():
    """Each test that restores onto a mesh leaves no process group behind
    (a worker runs several test files)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# -- compression ---------------------------------------------------------------
def test_int8_quantize_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1000)
                         .astype(np.float32))
    q, s = comp.int8_quantize(x)
    err = (comp.int8_dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7


def test_compression_error_feedback_telescopes():
    """The sum of the dequantized grads follows the sum of the true grads
    within one quantization step, not O(n_steps)."""
    rng = np.random.default_rng(0)
    grads = [{"w": torch.from_numpy(
        (rng.standard_normal((64,)) * (10.0 ** rng.integers(-3, 3)))
        .astype(np.float32))} for _ in range(50)]
    err = comp.init_error(grads[0])
    applied_sum = torch.zeros(64)
    true_sum = torch.zeros(64)
    for g in grads:
        deq, err = comp.compress_grads(g, err)
        applied_sum = applied_sum + deq["w"]
        true_sum = true_sum + g["w"]
    resid = float((applied_sum - true_sum).abs().max())
    last_scale = float((grads[-1]["w"] + err["w"]).abs().max()) / 127.0
    assert resid <= 2 * max(last_scale, 1e-6)


@pytest.mark.parametrize("case", ["ties", "normal", "tiny", "bf16"])
def test_int8_quantize_bits_match_reference(case):
    """q and the scale bit for bit, ties at .5 steps rounding to even."""
    rng = np.random.default_rng(7)
    if case == "ties":       # max 127 -> scale 1.0 in f32: x / s = x
        x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                      -126.5, 0.0, 64.5], np.float32)
    elif case == "tiny":
        x = (rng.standard_normal(513) * 1e-30).astype(np.float32)
    else:
        x = (rng.standard_normal((37, 29)) * 3.0).astype(np.float32)
    if case == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
        tx = torch.from_numpy(x).to(torch.bfloat16).float()
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = jcomp.int8_quantize(jx)
    q, s = comp.int8_quantize(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    np.testing.assert_array_equal(
        _bits(comp.int8_dequantize(q, s).numpy()),
        _bits(jcomp.int8_dequantize(jq, js)))
    if case == "ties":
        assert q.tolist()[:8] == [127, 0, 2, 2, 0, -2, -2, 4]


def test_compress_grads_bits_match_reference_over_50_steps():
    """A tree of dicts and a list of f32 and bf16 gradients through 50
    error-feedback steps: every dequantized leaf and every error leaf
    bit-equal to the reference's."""
    rng = np.random.default_rng(3)

    def draw(step):
        scale = 10.0 ** ((step % 7) - 3)
        a = (rng.standard_normal((16, 24)) * scale).astype(np.float32)
        b = (rng.standard_normal(40) * scale).astype(np.float32)
        c = (rng.standard_normal((3, 5, 7)) * scale).astype(np.float32)
        return a, b, c

    def jtree(a, b, c):
        return {"dense": {"w": jnp.asarray(a)},
                "stack": [jnp.asarray(b, jnp.bfloat16), jnp.asarray(c)]}

    def ttree(a, b, c):
        return {"dense": {"w": torch.from_numpy(a)},
                "stack": [torch.from_numpy(b).to(torch.bfloat16),
                          torch.from_numpy(c)]}

    first = draw(0)
    jerr = jcomp.init_error(jtree(*first))
    terr = comp.init_error(ttree(*first))
    for step in range(50):
        arrays = draw(step)
        jdeq, jerr = jcomp.compress_grads(jtree(*arrays), jerr)
        tdeq, terr = comp.compress_grads(ttree(*arrays), terr)
        for jt, tt in ((jdeq, tdeq), (jerr, terr)):
            pairs = [(jt["dense"]["w"], tt["dense"]["w"]),
                     (jt["stack"][0], tt["stack"][0]),
                     (jt["stack"][1], tt["stack"][1])]
            for j, t in pairs:
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def test_reference_compress_grads_tuple_fault_is_not_copied():
    """The reference splits its per-leaf (dequantized, error) pairs with
    `is_leaf=lambda t: isinstance(t, tuple)` (`src/repro/distributed/
    compression.py:46-49`), which also stops at a tuple of the caller's
    tree: a two-leaf tuple of grads comes back as its first leaf's
    (dequantized, error) pair.  The port keeps the tree's structure."""
    rng = np.random.default_rng(4)
    c = rng.standard_normal((3, 5)).astype(np.float32)
    d = rng.standard_normal(6).astype(np.float32)
    jdeq, _ = jcomp.compress_grads({"pair": (jnp.asarray(c), jnp.asarray(d))},
                                   {"pair": (jnp.zeros(c.shape),
                                             jnp.zeros(d.shape))})
    tdeq, terr = comp.compress_grads(
        {"pair": (torch.from_numpy(c), torch.from_numpy(d))},
        {"pair": (torch.zeros(3, 5), torch.zeros(6))})
    # the reference: the pair (deq(c), err(c)) where (deq(c), deq(d)) belongs
    assert np.asarray(jdeq["pair"][1]).shape == (3, 5)
    q, s = comp.int8_quantize(torch.from_numpy(c))
    np.testing.assert_array_equal(np.asarray(jdeq["pair"][0]),
                                  comp.int8_dequantize(q, s).numpy())
    assert isinstance(tdeq["pair"], tuple) and isinstance(terr["pair"], tuple)
    assert tdeq["pair"][0].shape == (3, 5) and tdeq["pair"][1].shape == (6,)
    assert torch.equal(tdeq["pair"][0], comp.int8_dequantize(q, s))
    qd, sd = comp.int8_quantize(torch.from_numpy(d))
    assert torch.equal(tdeq["pair"][1], comp.int8_dequantize(qd, sd))


def test_psum_compressed_is_the_identity_without_the_axis():
    grads = {"w": torch.ones(4)}
    err = comp.init_error(grads)
    for mesh, axis in ((make_host_mesh("cpu"), "pod"),
                       (make_production_mesh(), "pod"),
                       (Mesh((1, 16, 16), ("pod", "data", "model")), "pod"),
                       (Mesh((1, 1), ("data", "model")), "data")):
        out, out_err = comp.psum_compressed(grads, err, mesh, axis=axis)
        assert out is grads and out_err is err


def test_combine_matches_reference_arithmetic():
    """The cross-axis sum over four members' (q, scale), bit for bit
    against the reference's psum/pmax body in jnp."""
    rng = np.random.default_rng(5)
    members = [comp.int8_quantize(torch.from_numpy(
        (rng.standard_normal(300) * 10.0 ** i).astype(np.float32)))
        for i in range(-1, 3)]
    got = comp.combine(members)
    jq = jnp.stack([jnp.asarray(q.numpy()) for q, _ in members])
    js = jnp.stack([jnp.asarray(s.numpy()) for _, s in members])
    want = jnp.sum(jq.astype(jnp.int32), axis=0).astype(jnp.float32) \
        * jnp.max(js)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


_PSUM_RANK = """
import sys, torch, numpy as np
import torch.distributed as dist
sys.modules['jax'] = None; sys.modules['repro'] = None
from repro_torch.distributed import compression as comp
from repro_torch.launch.mesh import Mesh
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                        world_size=2, rank=rank)
rng = np.random.default_rng(11 + rank)
grads = {'a': torch.from_numpy((rng.standard_normal((8, 6)) * (rank + 1))
                               .astype(np.float32)),
         'b': [torch.from_numpy(rng.standard_normal(5).astype(np.float32))]}
err = {'a': torch.full((8, 6), 0.01 * rank), 'b': [torch.zeros(5)]}
mesh = Mesh((2, 1, 1), ('pod', 'data', 'model'), (torch.device('cpu'),))
summed, new_err = comp.psum_compressed(grads, err, mesh, axis='pod')
torch.save({'grads': grads, 'err': err, 'summed': summed,
            'new_err': new_err}, f'{out}/rank{rank}.pt')
dist.destroy_process_group()
"""


def test_psum_compressed_over_two_processes(tmp_path):
    """Two gloo ranks on the pod axis: each rank's sum equals `combine`
    over both ranks' quantized leaves, and its error equals its own
    compression residual, bit for bit."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM_RANK, str(r),
                               str(port), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for key in ("a", "b"):
        def leaf(tree):
            return tree[key] if key == "a" else tree[key][0]
        members = [comp.int8_quantize(leaf(r["grads"]).float()
                                      + leaf(r["err"])) for r in ranks]
        want = comp.combine(members)
        for r, (q, s) in zip(ranks, members):
            assert torch.equal(leaf(r["summed"]), want)
            own = leaf(r["grads"]).float() + leaf(r["err"])
            assert torch.equal(leaf(r["new_err"]),
                               own - comp.int8_dequantize(q, s))


# -- activation-sharding context -----------------------------------------------
def test_constrain_returns_its_tensor_in_any_context():
    x = torch.randn(2, 3)
    assert ctx.current_specs() is None
    assert ctx.constrain(x, "activations") is x
    specs = {"activations": NamedSharding(make_production_mesh(),
                                          P("data", None, None))}
    with ctx.activation_sharding(specs):
        assert ctx.current_specs() is specs
        assert ctx.constrain(x, "activations") is x
        with ctx.activation_sharding({}):
            assert ctx.current_specs() == {}
        assert ctx.current_specs() is specs
    assert ctx.current_specs() is None


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "llama4_maverick_400b_a17b"])
def test_logits_bit_equal_inside_an_activation_sharding_context(arch):
    """The reference's anchors (activations, attn_act, attn_scores,
    attn_out, moe_dispatch) change nothing on one device: the same params
    give bit-equal logits inside the dry-run's spec table and outside."""
    from repro_torch.launch.specs import activation_specs
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get(arch, reduced=True),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    plain = model.forward(params, {"tokens": tokens})
    mesh = make_production_mesh()
    with ctx.activation_sharding(activation_specs(cfg, mesh, False, batch=2)):
        inside = model.forward(params, {"tokens": tokens})
    assert torch.equal(plain, inside)


def test_transformer_reexports_activation_sharding():
    from repro_torch.models import transformer
    assert transformer.activation_sharding is ctx.activation_sharding


# -- elastic restore -------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn(8, 4, generator=g),
                      "b": torch.randn(4, generator=g).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_elastic_restore_with_new_shardings(tmp_path, fresh_group):
    """Restore onto explicit NamedShardings of the host mesh: each leaf a
    DTensor over the mesh, placed as its spec says, values bit-equal."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tree = _tree(3)
    ckpt.save(tmp_path, 1, tree)
    mesh = make_host_mesh("cpu")
    sh = {"layer": {"w": NamedSharding(mesh, P("data", None)),
                    "b": NamedSharding(mesh, P())},
          "step": NamedSharding(mesh, P())}
    like = {"layer": {k: torch.zeros_like(v) for k, v in
                      tree["layer"].items()}, "step": torch.zeros_like(
                          tree["step"])}
    restored, _ = ckpt.restore(tmp_path, 1, like, shardings=sh)
    for key in ("w", "b"):
        got = restored["layer"][key]
        assert isinstance(got, DTensor)
        assert torch.equal(got.to_local(), tree["layer"][key])
    assert torch.equal(restored["step"].to_local(), tree["step"])
    assert restored["layer"]["w"].placements == (Shard(0), Replicate())
    assert restored["layer"]["w"].placements == mesh.placements(
        P("data", None))
    assert restored["layer"]["b"].placements == (Replicate(), Replicate())
    assert restored["layer"]["w"].device_mesh.mesh_dim_names == (
        "data", "model")


def test_partial_shardings_restore_the_rest_plainly(tmp_path, fresh_group):
    from torch.distributed.tensor import DTensor
    tree = _tree(4)
    ckpt.save(tmp_path, 2, tree)
    mesh = make_host_mesh("cpu")
    restored, _ = ckpt.restore(
        tmp_path, 2, tree,
        shardings={"layer": {"w": NamedSharding(mesh, P(None, "model"))}})
    assert isinstance(restored["layer"]["w"], DTensor)
    assert not isinstance(restored["layer"]["b"], DTensor)
    assert torch.equal(restored["layer"]["b"], tree["layer"]["b"])


def test_restore_refuses_a_spec_that_splits_a_leaf(tmp_path, fresh_group):
    tree = _tree()
    ckpt.save(tmp_path, 1, tree)
    for mesh, spec in ((make_production_mesh(), P("data", None)),
                       (make_production_mesh(), P()),
                       (make_host_mesh("cpu"), P(None, None, None))):
        with pytest.raises(ValueError, match="layer/w"):
            ckpt.restore(tmp_path, 1, tree, shardings={
                "layer": {"w": NamedSharding(mesh, spec)}})


def test_reference_checkpoint_restores_onto_the_host_mesh(tmp_path,
                                                          fresh_group):
    """A checkpoint written by the JAX package, restored with shardings by
    both packages: every leaf bit-equal, placed as its spec."""
    from jax.sharding import NamedSharding as JNS, PartitionSpec as JP
    from repro.launch.mesh import make_host_mesh as jhost
    rng = np.random.default_rng(2)
    jtree = {"w": jnp.asarray(rng.standard_normal((6, 5)), jnp.bfloat16),
             "v": jnp.asarray(rng.standard_normal(5), jnp.float32)}
    jckpt.save(tmp_path, 3, jtree)
    jmesh = jhost()
    jrest, _ = jckpt.restore(tmp_path, 3, jtree, shardings={
        "w": JNS(jmesh, JP("data", None)), "v": JNS(jmesh, JP())})
    mesh = make_host_mesh("cpu")
    like = {"w": torch.zeros(6, 5, dtype=torch.bfloat16),
            "v": torch.zeros(5)}
    got, _ = ckpt.restore(tmp_path, 3, like, shardings={
        "w": NamedSharding(mesh, P("data", None)),
        "v": NamedSharding(mesh, P())})
    np.testing.assert_array_equal(
        got["w"].to_local().view(torch.int16).numpy(),
        np.asarray(jrest["w"]).view(np.int16))
    np.testing.assert_array_equal(_bits(got["v"].to_local().numpy()),
                                  _bits(jrest["v"]))
    assert tuple(jrest["w"].sharding.spec) == tuple(P("data", None))
    assert got["w"].placements == mesh.placements(P("data", None))
