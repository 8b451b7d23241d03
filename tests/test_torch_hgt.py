"""HGT on typed nodes (`models/hgt.py`, `kernels/hgt_attend.py`'s plain
path) against its plain reference (`bench/reference/hgt.py`, which imports
nothing of the program and serves the benchmark too) on the CPU at a tiny
size, with seeded random weights, and the slot layout and the joint
attention by their definitions.  The card's cases are in
`test_torch_hgt_attend.py`."""
import numpy as np
import pytest
import torch

from bench.reference import hgt as ref
from repro_torch.core import GIDSDataLoader, LoaderConfig
from repro_torch.graph.hetero import HeteroGraph, Relation
from repro_torch.kernels.hgt_attend import (HGTAttend, attend_backward_ref,
                                            attend_ref, hgt_attend)
from repro_torch.models.hgt import HGT, HGTConfig, hgt_blocks, sgd_step
from repro_torch.obs import HOT_PATH, Tracer
from repro_torch.sampling.relational import relational_sample_blocks

#: three types in id order and five relations, three of them into the
#: seeds' type (paper)
TYPES = {"paper": 140, "author": 110, "fos": 9}
RELATIONS = (("paper", "cites", "paper"),
             ("paper", "written_by", "author"),
             ("author", "rev_written_by", "paper"),
             ("paper", "topic", "fos"),
             ("fos", "rev_topic", "paper"))
NAMES = [name for _, name, _ in RELATIONS]
#: forward edges per relation; each reverse holds the same edges
EDGES = {"cites": 420, "written_by": 160, "topic": 110}
FANOUTS = (3, 2, 2)
DIM, HIDDEN, HEADS, CLASSES = 12, 16, 4, 5
LR = 0.1

#: float32 throughout; the program projects each distinct row once through
#: W_K with W_att and mu / sqrt(d) folded in, the reference projects every
#: slot by W_K, then W_att, and takes one masked softmax, so the two differ
#: by the order of float32 operations alone.  Measured on seeds 1-4 and 7
#: here: logits apart by at most 1.2e-7, parameters after a step by 6e-8,
#: gradients by 1.5e-8.  The tolerances leave room for another CPU's
#: order, and every departure below (a per-relation softmax, mu, W_att,
#: W_msg or the gate left out, two types' W_K swapped) moves some gradient
#: by 1.8e-3 to 3e-2 (seed 4).
LOGIT_TOL = {"rtol": 1e-5, "atol": 1e-6}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}


def tiny_graph(seed: int = 0, scale: int = 1,
               classes: int | None = None) -> HeteroGraph:
    """Each forward relation's `scale` x EDGES uniform distinct edges, its
    reverse their transpose; many papers and authors have no edge in some
    relation.  With `classes`, only the edges whose ends' global ids agree
    modulo `classes` are kept: every neighbour shares its node's class."""
    rng = np.random.default_rng(seed)
    off = dict(zip(TYPES, np.cumsum([0] + list(TYPES.values()))))
    edges = {}
    for s, name, t in RELATIONS:
        if name.startswith("rev_"):
            continue
        keys = np.unique(rng.integers(0, TYPES[s] * TYPES[t],
                                      scale * EDGES[name]))
        u, v = keys // TYPES[t], keys % TYPES[t]
        keep = u != v if s == t else np.ones(len(u), bool)
        if classes:
            keep &= (u + off[s]) % classes == (v + off[t]) % classes
        edges[name] = (u[keep], v[keep])
    rels = []
    for s, name, t in RELATIONS:
        u, v = edges[name.removeprefix("rev_")]
        if name.startswith("rev_"):
            u, v = v, u
        order = np.lexsort((u, v))
        indptr = np.zeros(TYPES[t] + 1, np.int64)
        np.cumsum(np.bincount(v, minlength=TYPES[t]), out=indptr[1:])
        rels.append(Relation(s, name, t, indptr,
                             (u[order] + off[s]).astype(np.int64)))
    return HeteroGraph(TYPES, rels, feature_dim=DIM, name="tiny-typed")


@pytest.fixture(scope="module")
def graph():
    return tiny_graph()


def _config() -> HGTConfig:
    return HGTConfig(in_dim=DIM, hidden_dim=HIDDEN, num_heads=HEADS,
                     num_classes=CLASSES, fanouts=FANOUTS,
                     relations=RELATIONS, node_types=tuple(TYPES))


def _kept(blocks) -> dict:
    """The batch in global ids, as the benchmark keeps it."""
    lv = blocks.levels
    return {"seeds": blocks.seeds, "levels": lv,
            "hops": [[{"dst": lv[k][r.dst],
                       "src": np.where(r.mask, lv[k + 1][r.src], -1),
                       "mask": r.mask} for r in hop]
                     for k, hop in enumerate(blocks.hops)]}


def _setup(graph, seed: int, batch: int = 20):
    gen = torch.Generator().manual_seed(seed)
    params = ref.init_params(
        ref.param_shapes(DIM, HIDDEN, HEADS, CLASSES, len(FANOUTS),
                         list(TYPES), NAMES), gen, torch.device("cpu"))
    table = torch.randn(graph.num_nodes, DIM, generator=gen)
    labels = torch.randint(0, CLASSES, (graph.num_nodes,), generator=gen)
    rng = np.random.default_rng(seed)
    seeds = rng.choice(TYPES["paper"], batch, replace=False)
    blocks = relational_sample_blocks(graph, seeds, FANOUTS, rng)
    model = HGT(_config(), device="cpu")
    model.load_reference_params(params)
    x = table[torch.from_numpy(blocks.all_nodes)]
    y = labels[torch.from_numpy(blocks.seeds)]
    return params, model, blocks, x, y


def _program_grads(model, x, hb, y):
    model.zero_grad(set_to_none=True)
    loss = model.loss(x, hb, y)
    loss.backward()
    # a leaf the step does not read has no gradient: the reference's zero
    return float(loss.detach()), {
        g: {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in grp.items()} for g, grp in model._groups().items()}


def _assert_grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for g in want:
        assert set(got[g]) == set(want[g])
        for k in want[g]:
            torch.testing.assert_close(got[g][k], want[g][k], **GRAD_TOL,
                                       msg=f"{g}.{k}")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_loss_gradients_and_a_step_match_the_reference(graph, seed):
    params, model, blocks, x, y = _setup(graph, seed)
    hb = hgt_blocks(blocks, graph, "cpu")
    step = _kept(blocks)
    torch.testing.assert_close(
        model(x, hb), ref.logits(params, x, step, TYPES, RELATIONS, HEADS),
        **LOGIT_TOL)
    value, grads, new = ref.sgd_step(params, x, step, y, TYPES, RELATIONS,
                                     HEADS, LR)
    loss, got = _program_grads(model, x, hb, y)
    assert loss == pytest.approx(value, rel=1e-6)
    _assert_grads_close(got, grads)
    # every type and relation moves but the last layer's relations into
    # other types than the seeds'
    still = {g for g, grp in grads.items()
             if not any(v.abs().max() > 0 for v in grp.values())}
    assert still == {f"layer{len(FANOUTS) - 1}.{name}"
                     for _, name, t in RELATIONS if t != "paper"}
    model.load_reference_params(params)
    assert float(sgd_step(model, x, hb, y, LR)) == pytest.approx(value,
                                                                 rel=1e-6)
    after = model.param_tree()
    for g, grp in new.items():
        for k, v in grp.items():
            torch.testing.assert_close(after[g][k], v, **LOGIT_TOL,
                                       msg=f"{g}.{k}")


def _per_relation(e, valid, v):
    """The attention as a per-relation softmax summed over the relations:
    what R-GAT does, and what HGT's Eq. 3 does not."""
    n = e.shape[0]
    on = valid[..., None]
    e = torch.where(on, e, float("-inf"))
    e = torch.where(on.any(dim=2, keepdim=True), e, 0.0)
    alpha = torch.softmax(e, dim=2) * on
    return (alpha[..., None] * v).sum((1, 2)).reshape(n, -1)


def _mutated(params: dict, mutant: str) -> dict:
    out = {g: {k: v.clone() for k, v in grp.items()}
           for g, grp in params.items()}
    for g, grp in out.items():
        if mutant == "no_mu" and "mu" in grp:
            grp["mu"] = torch.ones_like(grp["mu"])
        if mutant in ("no_w_att", "no_w_msg") and "w_att" in grp:
            key = mutant.removeprefix("no_")
            grp[key] = torch.eye(grp[key].shape[-1]).expand_as(
                grp[key]).clone()
        if mutant == "no_gate" and "beta" in grp:
            grp["beta"] = torch.full_like(grp["beta"], 30.0)   # no skip
    if mutant == "types_swapped":
        for l in range(len(FANOUTS)):
            a, b = out[f"layer{l}.paper"], out[f"layer{l}.author"]
            a["w_k"], b["w_k"] = b["w_k"], a["w_k"]
    return out


@pytest.mark.parametrize("mutant", ["per_relation_softmax", "no_mu",
                                    "no_w_att", "no_w_msg", "no_gate",
                                    "types_swapped"])
def test_a_departure_from_the_equations_fails_the_tolerances(
        graph, monkeypatch, mutant):
    """The reference with one part of HGT changed or left out stands in for
    a program that lacks it: the program's gradients, held to the
    reference's by the tolerances above, are told apart from it."""
    params, model, blocks, x, y = _setup(graph, seed=4)
    _, got = _program_grads(model, x, hgt_blocks(blocks, graph, "cpu"), y)
    step = _kept(blocks)
    if mutant == "per_relation_softmax":
        monkeypatch.setattr(ref, "attend", _per_relation)
    else:
        params = _mutated(params, mutant)
    _, grads, _ = ref.sgd_step(params, x, step, y, TYPES, RELATIONS, HEADS,
                               LR)
    # the mutation changes leaves named in the program's tree: compare the
    # gradients the program computes with the untouched parameters
    with pytest.raises(AssertionError):
        _assert_grads_close(got, grads)


def _loop_attend(q, k, v, indptr, idx):
    """The joint attention destination by destination, from its
    definition: out[t] = sum_s softmax_s(q_t . k_s) v_s per head."""
    outs = []
    for t in range(q.shape[0]):
        rows = idx[indptr[t]:indptr[t + 1]].long()
        if len(rows) == 0:
            outs.append(0.0 * q[t].reshape(-1))          # in the graph
            continue
        e = (q[t][None] * k[rows]).sum(-1)                # (slots, H)
        alpha = torch.softmax(e, dim=0)
        outs.append((alpha[..., None] * v[rows]).sum(0).reshape(-1))
    return torch.stack(outs)


def _case(kind: str, H: int = 3, D: int = 5, seed: int = 0):
    """q, k, v (float64) and a CSR: ragged segments with a destination of
    no slot, one of a single slot, one of many, and a row named by many
    slots."""
    rng = np.random.default_rng(seed)
    counts = {"ragged": [3, 0, 1, 7, 2, 0, 12, 1],
              "all_empty": [0, 0, 0],
              "one_row_many_slots": [4, 6, 1, 5]}[kind]
    R = 6
    idx = rng.integers(0, R, sum(counts))
    if kind == "one_row_many_slots":
        idx[: len(idx) // 2] = 2
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n = len(counts)
    return (torch.from_numpy(rng.standard_normal((n, H, D))),
            torch.from_numpy(rng.standard_normal((R, H, D))),
            torch.from_numpy(rng.standard_normal((R, H, D))),
            torch.from_numpy(indptr), torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(rng.standard_normal((n, H * D))))


#: float64 against float64: the definitions differ by the order of sums
F64_TOL = {"rtol": 1e-10, "atol": 1e-12}


@pytest.mark.parametrize("kind", ["ragged", "all_empty",
                                  "one_row_many_slots"])
def test_plain_attend_is_the_joint_softmax_forward_and_backward(kind):
    q, k, v, indptr, idx, g = _case(kind)
    out, lse = attend_ref(q, k, v, indptr, idx)
    torch.testing.assert_close(out, _loop_attend(q, k, v, indptr, idx),
                               **F64_TOL)
    empty = (indptr[1:] == indptr[:-1])
    assert not out[empty].any() and torch.isinf(lse[empty]).all()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(_loop_attend(*leaves, indptr, idx), leaves, g,
                               allow_unused=True)
    got = attend_backward_ref(g, q, k, v, indptr, idx, out, lse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, torch.zeros_like(a) if b is None else b,
                                   **F64_TOL)


@pytest.mark.parametrize("kind", ["ragged", "one_row_many_slots"])
def test_attend_function_passes_gradcheck(kind):
    q, k, v, indptr, idx, _ = _case(kind, H=2, D=3, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda *t: HGTAttend.apply(*t, indptr, idx), leaves)


def test_joint_softmax_is_not_a_per_relation_one():
    """One destination with two slots of one relation and one of another:
    the joint weights sum to 1 over all three, where a per-relation softmax
    gives each relation's slots weights summing to 1 and adds the two."""
    q = torch.ones(1, 1, 1, dtype=torch.float64)
    k = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64).view(3, 1, 1)
    v = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64).view(3, 1, 1)
    indptr = torch.tensor([0, 3], dtype=torch.int32)
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)      # rows 0, 1 | 2
    got = hgt_attend(q, k, v, indptr, idx)
    w = torch.softmax(torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64), 0)
    assert float(got) == pytest.approx(float((w * v.view(-1)).sum()))
    pair = torch.softmax(torch.tensor([0.0, 1.0], dtype=torch.float64), 0)
    per_relation = float((pair * v.view(-1)[:2]).sum()) + 4.0
    assert abs(float(got) - per_relation) > 0.5


def _listing(blocks, k: int) -> list[list[tuple[int, int]]]:
    """Every destination of level k's slots, slot by slot: (relation,
    source position in level k + 1), relation by relation in the graph's
    order, then in slot order."""
    out = [[] for _ in blocks.levels[k]]
    for b in blocks.hops[k]:
        for row, t in enumerate(b.dst):
            for j in range(b.src.shape[1]):
                if b.mask[row, j]:
                    out[t].append((b.relation, int(b.src[row, j])))
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_slot_layout_lists_every_slot_relation_by_relation(graph, seed):
    rng = np.random.default_rng(seed)
    seeds = rng.choice(TYPES["paper"], 24, replace=False)
    blocks = relational_sample_blocks(graph, seeds, FANOUTS, rng)
    tracer = Tracer()
    hb = hgt_blocks(blocks, graph, "cpu", tracer)
    for k, hop in enumerate(hb.hops):
        # each stacked row: (relation, source position in level k + 1)
        stacked = []
        for r, s, rows in hop.rows:
            assert graph.relations[r].src_type == list(TYPES)[s]
            pos = rows.numpy() + hb.bounds[k + 1][s]
            assert len(np.unique(pos)) == len(pos)     # distinct, once
            stacked += [(r, int(p)) for p in pos]
        indptr, idx = hop.indptr.numpy(), hop.idx.numpy()
        assert indptr.dtype == idx.dtype == np.int32
        got = [[stacked[i] for i in idx[indptr[t]:indptr[t + 1]]]
               for t in range(len(indptr) - 1)]
        want = _listing(blocks, k)
        assert got == want
        assert any(len({r for r, _ in slots}) > 1 for slots in want)
        m = tracer.metrics
        assert m.get(f"hgt.slots.{k}").value == len(idx)
        assert m.get(f"hgt.kv_rows.{k}").value == len(stacked)
        assert m.get(f"hgt.dst_rows.{k}").value == len(blocks.levels[k])
        for t, (lo, hi) in enumerate(zip(hb.bounds[k], hb.bounds[k][1:])):
            lo_id, hi_id = graph.type_range(list(TYPES)[t])
            level = blocks.levels[k]
            assert ((level[lo:hi] >= lo_id) & (level[lo:hi] < hi_id)).all()
        assert hb.bounds[k][0] == 0 and hb.bounds[k][-1] == len(level)
    spans = [w for w in tracer.wall_spans() if w.name == "hgt_slots"]
    assert len(spans) == 1 and spans[0].cat == HOT_PATH


def test_last_rows_count_each_relation_s_distinct_sources(graph):
    _, model, blocks, x, _ = _setup(graph, seed=6)
    model(x, hgt_blocks(blocks, graph, "cpu"))
    assert len(model.last_rows) == len(FANOUTS)
    for l, rows in enumerate(model.last_rows):
        k = len(FANOUTS) - 1 - l
        want = {NAMES[b.relation]: len(np.unique(b.src[b.mask]))
                for b in blocks.hops[k] if b.mask.any()}
        assert rows["kv_rows"] == want
        assert rows["slots"] == sum(int(b.mask.sum())
                                    for b in blocks.hops[k])
        assert rows["dst"] == len(blocks.levels[k])


def test_loader_trains_hgt_through_gids_device():
    """`GIDSDataLoader(sampler="relational")` on the gids-device plane
    (device='cpu') feeds HGT: its batches' rows are the table's rows of
    `all_nodes`, and the model learns a class its neighbours' features and
    its own show."""
    graph = tiny_graph(seed=2, scale=7, classes=CLASSES)
    rng = np.random.default_rng(0)
    labels = np.arange(graph.num_nodes) % CLASSES
    feats = (2.0 * np.eye(CLASSES, DIM)[labels]
             + 0.1 * rng.standard_normal((graph.num_nodes, DIM))
             ).astype(np.float32)
    dl = GIDSDataLoader(graph, feats, LoaderConfig(
        batch_size=32, fanouts=FANOUTS, sampler="relational",
        data_plane="gids-device", cache_lines=256, window_depth=2),
        train_ids=np.arange(TYPES["paper"]), device="cpu")
    model = HGT(_config(), generator=torch.Generator().manual_seed(0),
                device="cpu")
    losses = []
    for _ in range(30):
        b = dl.next_batch()
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
        y = torch.from_numpy(labels[b.blocks.seeds])
        losses.append(float(sgd_step(model, b.features,
                                     hgt_blocks(b.blocks, graph, "cpu"), y,
                                     0.5)))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])


def test_model_refuses_a_type_named_like_a_relation():
    with pytest.raises(ValueError, match="share a name"):
        HGT(HGTConfig(in_dim=DIM, hidden_dim=HIDDEN, num_heads=HEADS,
                      num_classes=CLASSES, fanouts=FANOUTS,
                      relations=(("paper", "paper", "paper"),),
                      node_types=("paper",)), device="cpu")
