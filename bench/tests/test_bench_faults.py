"""A run with its timed path broken underneath comes out not correct: the
harness drives the rest of the run as it is (with the look for a card left
out), on the CPU at a small size."""
import numpy as np
import pytest
import torch

import repro_torch.core.device_store as device_store
import repro_torch.core.pipeline as pipeline
from bench import cell as cell_run
from bench import judge
from repro_torch.models.gnn import sgd_step as real_sgd_step

from . import tiny

#: the fault is planted in the cell's family module (its `sgd_step`)
FAMILY = "family"


def state_unchanged(model, feats, hop_idx, labels, lr):
    """The step computes its loss and returns it, and updates nothing."""
    return model.loss(feats, hop_idx, labels).detach()


def half_batch(model, feats, hop_idx, labels, lr):
    """Half of the batch left out: the mean loss over the first half of the
    seeds and their subtrees."""
    keep, fanouts, cut = len(labels) // 2, model.cfg.fanouts, []
    n = keep
    for lvl, idx in enumerate(hop_idx):
        cut.append(idx[:n])
        if lvl < len(fanouts):
            n *= fanouts[lvl]
    return real_sgd_step(model, feats, cut, labels[:keep], lr)


def one_leaf_unmoved(model, feats, hop_idx, labels, lr):
    """Every leaf but the first layer's first one moves: a fault confined
    to one leaf, which the first step's median leaf does not see."""
    leaf = next(iter(model.param_tree()["layer0"].values()))
    before = leaf.clone()
    loss = real_sgd_step(model, feats, hop_idx, labels, lr)
    leaf.copy_(before)
    return loss


def altered_rows(store, ids, staged, future_counts, mark=None):
    """One gathered row altered where the data plane produces it."""
    store, out, hits = real_gather(store, ids, staged, future_counts)
    out[len(out) // 2, 0] += 1.0
    return store, out, hits


def altered_sample(graph, seeds, fanouts, rng):
    """One sampled id of the last hop replaced by its own source row, never
    a neighbour (the graph has no self-loops)."""
    blocks = real_sample(graph, seeds, fanouts, rng)
    src = blocks.hop_nodes[-2] if len(blocks.hop_nodes) > 1 else seeds
    last = blocks.hop_nodes[-1]
    row = int(np.flatnonzero(np.diff(graph.indptr)[src] > 0)[0])
    last[row * fanouts[-1]] = src[row]
    blocks.all_nodes = np.unique(np.concatenate(
        [seeds.astype(np.int64), *blocks.hop_nodes]))
    return blocks


real_gather = device_store.device_gather
real_sample = pipeline.host_sample_blocks

FAULTS = {
    "state_unchanged": (FAMILY, "sgd_step", state_unchanged,
                        ("change_gap", "grad_gap")),
    "half_batch": (FAMILY, "sgd_step", half_batch, ("loss_gap",)),
    "one_leaf_unmoved": (FAMILY, "sgd_step", one_leaf_unmoved,
                         ("grad_gap_worst", "change_gap_worst")),
    "altered_rows": (device_store, "device_gather", altered_rows,
                     ("bad_feature_rows",)),
    "altered_sample": (pipeline, "host_sample_blocks", altered_sample,
                       ("bad_sample_ids",)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["sage3-igbs.b1024", "gat3-igbs.b1024"])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, name, fault):
    module, attr, broken, fails = FAULTS[fault]
    cell = tiny.tiny_cell(tmp_path, name)
    monkeypatch.setattr(cell.family if module == FAMILY else module, attr,
                        broken)
    out = cell_run.run(cell, 17, 0.2, False, torch.device("cpu"), 0.0)
    assert not judge.passed(out["checks"])
    for number in fails:
        c = out["checks"][number]
        assert c["value"] is None or c["value"] > c["limit"], (number, c)
    if fault == "state_unchanged":
        for number in ("grad_gap", "change_gap"):
            assert out["checks"][number]["value"] > 0.5
    if fault == "one_leaf_unmoved":     # the first step's median misses it
        c = out["checks"]["grad_gap"]
        assert c["value"] <= c["limit"], c
