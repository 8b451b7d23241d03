"""The port's first slice end to end on the CPU: the gids-device loader side
by side with the JAX package's, SGD steps from shared parameters, the
example script, and the rule that the port imports nothing of JAX or of the
JAX package."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core.dataplane import DataPlaneSpec  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.models.gnn import (GNN, GNNConfig, hop_indices,  # noqa: E402
                                    sgd_step)

ROOT = Path(__file__).resolve().parents[1]
KW = dict(batch_size=64, fanouts=(4, 3), data_plane="gids-device",
          cache_lines=256, cache_ways=4, window_depth=2)


def _loaders(n=3000, dim=16):
    feats = np.random.default_rng(0).standard_normal((n, dim)) \
        .astype(np.float32)
    ref = JLoader(jrmat(n, 8, dim, seed=3), feats, JConfig(**KW))
    port = GIDSDataLoader(rmat_graph(n, 8, dim, seed=3), feats,
                          LoaderConfig(**KW), device="cpu")
    return feats, ref, port


def test_gids_device_loader_matches_reference():
    """Blocks, tier counts, priced prep and exposed prep bit-identical to
    the reference for 10 batches under cache pressure; features equal
    feats[all_nodes] exactly; the cache metadata ends equal."""
    feats, ref, port = _loaders()
    for _ in range(10):
        a, b = ref.next_batch(), port.next_batch()
        np.testing.assert_array_equal(a.blocks.seeds, b.blocks.seeds)
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        for ha, hb in zip(a.blocks.hop_nodes, b.blocks.hop_nodes,
                          strict=True):
            np.testing.assert_array_equal(ha, hb)
        assert a.report.tier_names == b.report.tier_names
        assert a.report.tier_counts == b.report.tier_counts
        assert a.prep_time_s == b.prep_time_s
        assert a.exposed_prep_s == b.exposed_prep_s
        assert a.merge_depth == b.merge_depth
        jplan, tplan = ref.store.last_plan, port.store.last_plan
        assert tplan.is_partition()
        np.testing.assert_array_equal(tplan.assignment, jplan.assignment)
        np.testing.assert_array_equal(tplan.kernel_slots(0),
                                      jplan.kernel_slots(0))
        assert isinstance(b.features, torch.Tensor)
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
    jc = ref.store.tiers[0].store.cache
    tc = port.store.tiers[0].store.cache
    for name in ("tags", "reuse", "hits", "misses", "bypasses"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)),
                                      getattr(tc, name).numpy())
    assert int(tc.hits) > 0


def test_three_sgd_steps_match_reference():
    """Three SGD steps on the port's batches from the reference's initial
    parameters: per-step losses and the final parameters agree within
    1e-5 (f32 on both sides)."""
    feats, ref, port = _loaders()
    labels_all = np.random.default_rng(1).integers(0, 5, 3000) \
        .astype(np.int32)
    cfg_kw = dict(model="sage", in_dim=16, hidden_dim=32, num_classes=5,
                  fanouts=(4, 3))
    jm = jgnn.GNN(jgnn.GNNConfig(**cfg_kw))
    params = jm.init(jax.random.PRNGKey(0))
    tm = GNN(GNNConfig(**cfg_kw), device="cpu")
    tm.load_reference_params(jax.tree.map(np.asarray, params))
    lr = 0.1
    for _ in range(3):
        b = port.next_batch()
        hi = hop_indices(b.blocks)
        y = labels_all[b.blocks.seeds]
        j_loss, grads = jax.value_and_grad(jm.loss)(
            params, jnp.asarray(feats[b.blocks.all_nodes]),
            [jnp.asarray(i) for i in hi], jnp.asarray(y))
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        t_loss = sgd_step(tm, b.features, [torch.from_numpy(i) for i in hi],
                          torch.from_numpy(y), lr)
        np.testing.assert_allclose(t_loss.item(), float(j_loss),
                                   rtol=1e-5, atol=1e-5)
    for l in range(tm.L):
        for k, p in tm.layer[l].items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[f"layer{l}"][k]),
                                       rtol=1e-5, atol=1e-5)
    for k, p in tm.head.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params["head"][k]),
                                   rtol=1e-5, atol=1e-5)


def test_ported_options_build_and_distributed_options_run():
    """The host planes, merged windows, the topology plane, the sharded
    and cluster planes, the LADIES sampler, the GNN-serving presets, the
    LM families and configs (ROADMAP item 10) and the distributed options
    (item 11: the `flash_stub` attention, the `moe_2d_dispatch` field) are
    ported; an unknown attention or sampler raises ValueError."""
    for name in ("gids", "gids-async", "bam", "mmap", "pinned-host",
                 "gids-merged", "gids-merged-async", "gids-topo",
                 "gids-topo-merged", "gids-sharded", "gids-merged-sharded",
                 "gids-hosts", "gids-hosts-merged", "serve-gnn",
                 "serve-gnn-shared"):
        assert DataPlaneSpec.preset(name).name == name
    from repro_torch import configs
    from repro_torch.models.transformer import LM
    assert LM(configs.get("mamba2_1_3b"), device="cpu").plan == [
        (("ssm",), 48)]
    cfg = configs.get("qwen2_1_5b", reduced=True)
    assert LM(dataclasses.replace(cfg, attn_impl="flash_stub",
                                  moe_2d_dispatch=True),
              device="cpu").cfg.attn_impl == "flash_stub"
    with pytest.raises(ValueError, match="unknown attn_impl"):
        LM(dataclasses.replace(cfg, attn_impl="splash"), device="cpu")
    assert LoaderConfig().data_plane == "gids"
    spec = DataPlaneSpec.preset("gids-device", merge_execute=True,
                                topology=True)
    assert spec.merge_execute and spec.topology
    with pytest.raises(KeyError):
        DataPlaneSpec.preset("no-such-plane")
    assert LoaderConfig(sampler="ladies").sampler == "ladies"
    with pytest.raises(ValueError, match="unknown sampler"):
        LoaderConfig(sampler="graphsaint")


def _no_jax_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


_BLOCK_JAX = "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"


def test_port_imports_no_jax():
    """Every repro_torch module imports with JAX and the JAX package
    unimportable, and no source names the JAX package."""
    code = _BLOCK_JAX + (
        "import importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    print(m.name)\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_no_jax_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout
    for name in ("core.topology", "sampling.tiered", "core.accumulator",
                 "kernels.tiered_gather", "core.device_store",
                 "core.software_cache", "core.prefetch", "graph.datasets",
                 "core.sharding", "core.hosts", "core.faults",
                 "core.feedback", "core.storage_sim", "graph.synthetic",
                 "obs", "obs.metrics", "obs.trace", "obs.validate",
                 "serve.workload", "serve.admission", "serve.gnn_engine",
                 "core.tiers", "core.dataplane", "graph.csr",
                 "models.recurrent", "configs.whisper_small",
                 "configs.recurrentgemma_2b", "distributed.ctx",
                 "distributed.compression", "launch.mesh", "launch.specs",
                 "launch.roofline", "launch.dryrun"):
        assert f"repro_torch.{name}\n" in out.stdout
    pattern = re.compile(r"^\s*(import (jax|repro)\b|from (jax|repro)\b)",
                         re.M)
    sources = [*(ROOT / "src" / "repro_torch").rglob("*.py"),
               ROOT / "chip_smoke.py",
               ROOT / "examples" / "train_gnn_igb_torch.py",
               ROOT / "examples" / "serve_decode_torch.py",
               ROOT / "examples" / "quickstart_torch.py"]
    for path in sources:
        hits = [m.group(0) for m in pattern.finditer(path.read_text())]
        assert not hits, (path, hits)


def test_example_trains_on_cpu_without_jax():
    code = _BLOCK_JAX + (
        "import runpy\n"
        "sys.argv = ['train_gnn_igb_torch.py', '--device', 'cpu', "
        "'--steps', '3', '--nodes', '2000', '--feature-dim', '32', "
        "'--hidden', '32', '--batch', '32']\n"
        f"runpy.run_path({str(ROOT / 'examples' / 'train_gnn_igb_torch.py')!r},"
        " run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_no_jax_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "3 steps in" in out.stdout
    assert "iter    2 loss" in out.stdout
