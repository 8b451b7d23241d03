"""The port's GNN (repro_torch.models.gnn) against the JAX package's: logits,
loss and every parameter gradient from the same parameters and inputs, and
the learns test of test_gnn_e2e.py run through the port's gids-device
loader on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import gnn as jgnn  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.models.gnn import (GNN, GNNConfig, hop_indices,  # noqa: E402
                                    sgd_step)
from repro_torch.sampling.neighbor import host_sample_blocks  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)   # f32 on both sides; sums in other orders


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    g = rmat_graph(500, 6, 16, seed=5)
    feats = rng.standard_normal((g.num_nodes, 16)).astype(np.float32)
    blocks = host_sample_blocks(g, rng.integers(0, g.num_nodes, 16), (4, 3),
                                rng)
    table = feats[blocks.all_nodes]
    labels = rng.integers(0, 5, 16).astype(np.int32)
    return table, hop_indices(blocks), labels


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_logits_loss_grads_match_reference(model):
    cfg_kw = dict(model=model, in_dim=16, hidden_dim=32, num_classes=5,
                  fanouts=(4, 3))
    ref = jgnn.GNN(jgnn.GNNConfig(**cfg_kw))
    params = ref.init(jax.random.PRNGKey(0))
    table, hi, labels = _inputs()
    j_hi = [jnp.asarray(i) for i in hi]
    j_logits = ref.forward(params, jnp.asarray(table), j_hi)
    j_loss, j_grads = jax.value_and_grad(ref.loss)(
        params, jnp.asarray(table), j_hi, jnp.asarray(labels))

    port = GNN(GNNConfig(**cfg_kw), device="cpu")
    port.load_reference_params(jax.tree.map(np.asarray, params))
    t_hi = [torch.from_numpy(i) for i in hi]
    t_table = torch.from_numpy(table)
    np.testing.assert_allclose(port(t_table, t_hi).detach().numpy(),
                               np.asarray(j_logits), **TOL)
    loss = port.loss(t_table, t_hi, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), **TOL)
    groups = {f"layer{l}": port.layer[l] for l in range(port.L)}
    groups["head"] = port.head
    for group, ps in groups.items():
        for k, p in ps.items():
            # a parameter the loss never reads (gcn's w_nbr) has no grad
            # in torch and a zero one in JAX
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            np.testing.assert_allclose(grad.numpy(),
                                       np.asarray(j_grads[group][k]),
                                       err_msg=f"{group}.{k}", **TOL)


def test_load_reference_params_checks_the_tree():
    port = GNN(GNNConfig(in_dim=8, hidden_dim=8, num_classes=3,
                         fanouts=(2,)), device="cpu")
    tree = {g: {k: p.detach().numpy() for k, p in ps.items()}
            for g, ps in (("layer0", port.layer[0]), ("head", port.head))}
    port.load_reference_params(tree)
    bad = dict(tree, head={**tree["head"], "w": np.zeros((8, 4))})
    with pytest.raises(ValueError, match="shape"):
        port.load_reference_params(bad)
    with pytest.raises(ValueError, match="groups"):
        port.load_reference_params({"head": tree["head"]})


def test_segment_mean_refuses_feature_gradients():
    port = GNN(GNNConfig(in_dim=4, hidden_dim=4, num_classes=2,
                         fanouts=(2,)), device="cpu")
    feats = torch.randn(6, 4, requires_grad=True)
    hi = [torch.tensor([0, 1], dtype=torch.int32),
          torch.tensor([2, 3, 4, 5], dtype=torch.int32)]
    loss = port.loss(feats, hi, torch.tensor([0, 1]))
    with pytest.raises(RuntimeError, match="feature table"):
        loss.backward()


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_gnn_learns_on_gids_device(model):
    """Port of test_gnn_e2e.py::test_gnn_learns on the gids-device plane,
    device='cpu'."""
    rng = np.random.default_rng(0)
    g = rmat_graph(4000, 10, 16, seed=1)
    n_classes = 5
    labels_all = rng.integers(0, n_classes, g.num_nodes)
    feats = (2.0 * np.eye(n_classes, 16)[labels_all]
             + 0.1 * rng.standard_normal((g.num_nodes, 16))
             ).astype(np.float32)
    cfg = GNNConfig(model=model, in_dim=16, hidden_dim=32,
                    num_classes=n_classes, fanouts=(4, 3))
    gnn = GNN(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    dl = GIDSDataLoader(g, feats, LoaderConfig(
        batch_size=128, fanouts=cfg.fanouts, data_plane="gids-device",
        cache_lines=2048, window_depth=2), device="cpu")
    losses = []
    for _ in range(60):
        b = dl.next_batch()
        hi = [torch.from_numpy(i) for i in hop_indices(b.blocks)]
        lab = torch.from_numpy(labels_all[b.blocks.seeds])
        losses.append(sgd_step(gnn, b.features, hi, lab, 0.2).item())
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(losses).all()
    assert last < first * 0.8, (first, last)
