"""The benchmark's plain reference agrees with `repro_torch` run on the CPU
(`device="cpu"`, the kernels' plain versions) at a small size."""
import numpy as np
import pytest
import torch

from bench import cell as cell_run
from bench import judge
from bench import trace as trace_mod
from bench.reference import check, follow, gnn

from . import tiny


@pytest.mark.parametrize("name", ["sage3-igbs.b1024", "gat3-igbs.b1024"])
def test_reference_follows_the_program(tmp_path, name):
    cell = tiny.tiny_cell(tmp_path, name)
    cfg = cell.config
    inp, prog, first, program = cell_run.setup(
        cell, 3, torch.device("cpu"), trace_mod.Spans(False))
    ref = judge.cpu_tree_all(follow.follow(
        cfg["model"], inp.params, first, inp.features, inp.labels,
        cfg["fanouts"], cfg.get("num_heads", 1), cfg["lr"],
        torch.device("cpu")))
    np.testing.assert_allclose(program["losses"], ref["losses"], rtol=1e-5)
    gaps = judge.training_gaps(program, ref, judge.cpu_tree(inp.params),
                               cfg["lr"])
    assert max(gaps[k] for k in judge.NUMBERS[3:]) < 1e-4
    # the same loss from the program's own forward on the same rows
    graph = check.Graph(inp.indptr, inp.indices)
    for b in first:
        assert check.bad_sample_ids(graph, inp.seed_pool, b["seeds"],
                                    b["hop_nodes"],
                                    b["all_nodes"], cfg["fanouts"],
                                    cell.traffic["batch_size"]) == 0
        assert check.bad_rows(inp.features, b["all_nodes"],
                              b["row_sums"].numpy(),
                              b["col_sums"].numpy()) == 0


def test_reference_layers_match_the_program_layer_by_layer():
    from repro_torch.models.gnn import GNN, GNNConfig
    gen = torch.Generator().manual_seed(0)
    fan = (3, 2)
    for model in ("sage", "gat"):
        shapes = gnn.param_shapes(model, 8, 8, 3, 2, 4)
        params = gnn.init_params(shapes, gen, torch.device("cpu"))
        net = GNN(GNNConfig(model=model, in_dim=8, hidden_dim=8,
                            num_classes=3, fanouts=fan, num_heads=4),
                  device="cpu")
        net.load_reference_params(params)
        levels = [torch.randn(n, 8, generator=gen) for n in (2, 6, 12)]
        feats = torch.cat(levels)
        hop = [torch.arange(0, 2), torch.arange(2, 8), torch.arange(8, 20)]
        got = net(feats, [h.to(torch.int32) for h in hop])
        want = gnn.logits(model, params, levels, fan, 4)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_bad_sample_ids_catches_a_wrong_neighbour():
    indptr = np.array([0, 2, 3, 3])          # 0 -> {1, 2}, 1 -> {2}, 2: none
    indices = np.array([1, 2, 2], np.int32)
    g = check.Graph(indptr, indices)
    seeds = np.array([0, 1])
    hops = [np.array([1, 2, 2, 2])]           # fanout 2
    all_nodes = np.array([0, 1, 2])
    pool = np.array([0, 1])                   # the nodes with an out-edge
    assert check.bad_sample_ids(g, pool, seeds, hops, all_nodes, [2],
                                2) == 0
    assert check.bad_sample_ids(g, pool, seeds, [np.array([1, 2, 0, 2])],
                                all_nodes, [2], 2) == 1
    # an isolated row samples itself; a seed outside the pool is refused
    assert check.bad_sample_ids(g, pool, np.array([0, 2]),
                                [np.array([1, 1, 2, 2])], all_nodes, [2],
                                2) == 1
