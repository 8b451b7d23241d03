"""R-GAT on typed nodes (`graph/hetero.py`, `sampling/relational.py`,
`models/rgat.py`) against its plain reference (`models/rgat_ref.py`) and by
property, on the CPU at tiny sizes with seeded random weights."""
import numpy as np
import pytest
import torch

from repro_torch.core import GIDSDataLoader, LoaderConfig
from repro_torch.graph.hetero import HeteroGraph, Relation
from repro_torch.models import rgat_ref
from repro_torch.models.rgat import (IGBH_RELATIONS, RGAT, RGATConfig,
                                     block_tensors, sgd_step)
from repro_torch.obs import HOT_PATH, Tracer
from repro_torch.sampling.relational import relational_sample_blocks

TYPES = {"paper": 300, "author": 260, "institute": 5, "fos": 17}
#: forward edges per relation; each reverse holds the same edges
EDGES = {"cites": 1500, "written_by": 500, "topic": 700, "affiliated_to": 90}
FANOUTS = (4, 3, 2)
NAMES = [name for _, name, _ in IGBH_RELATIONS]
DIM, HIDDEN, HEADS, CLASSES = 24, 16, 4, 7


def _csr(dst_local, src_global, n_dst):
    order = np.lexsort((src_global, dst_local))
    indptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(np.bincount(dst_local, minlength=n_dst), out=indptr[1:])
    return indptr, src_global[order].astype(np.int64)


def tiny_hetero(seed: int = 0, scale: int = 1,
                classes: int | None = None) -> HeteroGraph:
    """IGBH's types and seven relations at a tiny size: each forward
    relation `scale` x EDGES uniform distinct edges, its reverse their
    transpose.  Many authors and papers have no edge in some relation
    (masked slots).  With `classes`, only the edges whose ends' global ids
    agree modulo `classes` are kept: every neighbour shares its node's
    class."""
    rng = np.random.default_rng(seed)
    off = dict(zip(TYPES, np.cumsum([0] + list(TYPES.values()))))
    edges = {}
    for s, name, t in IGBH_RELATIONS:
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
    for s, name, t in IGBH_RELATIONS:
        u, v = edges[name.removeprefix("rev_")]
        if name.startswith("rev_"):
            u, v = v, u
        indptr, indices = _csr(v, u + off[s], TYPES[t])
        rels.append(Relation(s, name, t, indptr, indices))
    return HeteroGraph(TYPES, rels, feature_dim=DIM, name="tiny-igbh")


@pytest.fixture(scope="module")
def hg():
    return tiny_hetero()


def _seeds(hg, n, seed):
    return np.random.default_rng(seed).choice(hg.counts["paper"], n,
                                              replace=False)


def _setup(hg, seed=0, batch=24):
    gen = torch.Generator().manual_seed(seed)
    params = rgat_ref.init_params(
        rgat_ref.param_shapes(DIM, HIDDEN, HEADS, CLASSES, len(FANOUTS),
                              NAMES), gen, torch.device("cpu"))
    table = torch.randn(hg.num_nodes, DIM, generator=gen)
    labels = torch.randint(0, CLASSES, (hg.num_nodes,), generator=gen)
    blocks = relational_sample_blocks(hg, _seeds(hg, batch, seed), FANOUTS,
                                      np.random.default_rng(seed))
    model = RGAT(RGATConfig(in_dim=DIM, hidden_dim=HIDDEN, num_heads=HEADS,
                            num_classes=CLASSES, fanouts=FANOUTS),
                 device="cpu")
    model.load_reference_params(params)
    x = table[torch.from_numpy(blocks.all_nodes)]
    y = labels[torch.from_numpy(blocks.seeds)]
    return params, model, blocks, x, y


def _ref_steps(params, x, blocks, y, steps, lr=0.1):
    out = []
    for _ in range(steps):
        value, grads, params = rgat_ref.sgd_step(params, x, blocks, y, NAMES,
                                                 HEADS, lr)
        out.append((value, grads, params))
    return out


#: float32 throughout; the program projects each referenced row once and
#: sums the attention with einsum, the reference projects every slot and
#: sums elementwise, so the two differ by the order of float32 additions
#: alone.  Measured on seeds 1-5 here: logits equal to the bit, gradients
#: apart by at most 3e-7 (a few ulps of leaves near 1e-2 to 1).  The
#: tolerances leave ~3x room over that for another CPU's order, and are
#: ~1000x below what 10-bit mantissas give (logits apart by 1e-3 to 2.5e-3).
LOGIT_TOL = {"rtol": 1e-5, "atol": 1e-6}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}


def test_logits_loss_and_grads_match_the_reference(hg):
    params, model, blocks, x, y = _setup(hg, seed=1)
    tb = block_tensors(blocks, "cpu")
    torch.testing.assert_close(
        model(x, tb), rgat_ref.logits(params, x, blocks, NAMES, HEADS),
        **LOGIT_TOL)
    value, grads, _ = _ref_steps(params, x, blocks, y, 1)[0]
    loss = model.loss(x, tb, y)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(value, rel=1e-6)
    # a leaf the step does not read has no gradient, the reference's zero
    tree = {g: {k: torch.zeros_like(p) if p.grad is None else p.grad
                for k, p in grp.items()}
            for g, grp in model._groups().items()}
    assert set(tree) == set(grads)
    for g in grads:
        for k in grads[g]:
            torch.testing.assert_close(tree[g][k], grads[g][k], **GRAD_TOL,
                                       msg=f"{g}.{k}")


def test_parameters_after_two_sgd_steps_match_the_reference(hg):
    params, model, blocks, x, y = _setup(hg, seed=2)
    tb = block_tensors(blocks, "cpu")
    ref = _ref_steps(params, x, blocks, y, 2)
    losses = [float(sgd_step(model, x, tb, y, 0.1)) for _ in range(2)]
    assert losses == pytest.approx([r[0] for r in ref], rel=1e-6)
    got = model.param_tree()
    for g, grp in ref[-1][2].items():
        for k, v in grp.items():
            torch.testing.assert_close(got[g][k], v, **LOGIT_TOL,
                                       msg=f"{g}.{k}")


def _tf32_like(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (round to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def test_a_tf32_like_perturbation_fails_the_tolerances(hg):
    """The reference on inputs and weights rounded to 10 mantissa bits, in
    the program's place: the tolerances above tell it apart."""
    params, _, blocks, x, y = _setup(hg, seed=3)
    rounded = {g: {k: _tf32_like(v) for k, v in grp.items()}
               for g, grp in params.items()}
    want = rgat_ref.logits(params, x, blocks, NAMES, HEADS)
    got = rgat_ref.logits(rounded, _tf32_like(x), blocks, NAMES, HEADS)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **LOGIT_TOL)
    _, g_want, _ = _ref_steps(params, x, blocks, y, 1)[0]
    _, g_got, _ = _ref_steps(rounded, _tf32_like(x), blocks, y, 1)[0]
    with pytest.raises(AssertionError):
        for g in g_want:
            for k in g_want[g]:
                torch.testing.assert_close(g_got[g][k], g_want[g][k],
                                           **GRAD_TOL)


def _edge_set(rel: Relation, off: int) -> set:
    rows = np.repeat(np.arange(len(rel.indptr) - 1), rel.degrees()) + off
    return set(zip(rows.tolist(), rel.indices.tolist()))


@pytest.mark.parametrize("seed", [0, 5])
def test_relational_sampler_properties(hg, seed):
    seeds = _seeds(hg, 32, seed)
    b = relational_sample_blocks(hg, seeds, FANOUTS,
                                 np.random.default_rng(seed))
    assert len(b.levels) == len(FANOUTS) + 1
    np.testing.assert_array_equal(b.levels[0], np.unique(seeds))
    assert b.all_nodes is b.levels[-1]
    for lo, hi, pos in zip(b.levels, b.levels[1:], b.level_pos):
        assert np.all(np.diff(hi) > 0)                 # sorted, unique
        np.testing.assert_array_equal(hi[pos], lo)      # nested
    unmasked = 0
    for k, hop in enumerate(b.hops):
        assert [blk.relation for blk in hop] == list(range(len(NAMES)))
        drawn = [b.levels[k]]
        for blk in hop:
            rel = hg.relations[blk.relation]
            lo, hi = hg.type_range(rel.dst_type)
            dst = b.levels[k][blk.dst]
            np.testing.assert_array_equal(
                dst, b.levels[k][(b.levels[k] >= lo) & (b.levels[k] < hi)])
            assert blk.src.shape == blk.mask.shape == (len(dst), FANOUTS[k])
            deg = rel.degrees()[dst - lo]
            # masked exactly where the destination has no edge in r
            np.testing.assert_array_equal(
                blk.mask, np.repeat((deg > 0)[:, None], FANOUTS[k], 1))
            edges = _edge_set(rel, lo)
            src = b.levels[k + 1][blk.src]
            pairs = zip(np.repeat(dst, FANOUTS[k])[blk.mask.ravel()].tolist(),
                        src[blk.mask].tolist())
            assert all(p in edges for p in pairs)
            unmasked += int(blk.mask.sum())
            drawn.append(src[blk.mask])
        np.testing.assert_array_equal(b.levels[k + 1],
                                      np.unique(np.concatenate(drawn)))
    assert b.num_requests == len(seeds) + unmasked
    assert b.num_slots - b.num_masked == unmasked
    assert b.num_masked > 0                     # the tiny graph has them
    again = relational_sample_blocks(hg, seeds, FANOUTS,
                                     np.random.default_rng(seed))
    for x, y in zip(b.levels, again.levels):
        np.testing.assert_array_equal(x, y)
    for hop, hop2 in zip(b.hops, again.hops):
        for x, y in zip(hop, hop2):
            np.testing.assert_array_equal(x.src, y.src)
            np.testing.assert_array_equal(x.mask, y.mask)


def test_hetero_graph_validates_and_unions(hg):
    union = hg.union()
    assert union.num_nodes == sum(TYPES.values())
    assert union.num_edges == hg.num_edges == sum(
        r.num_edges for r in hg.relations)
    for v in (0, hg.offsets["author"] + 3, hg.offsets["institute"]):
        want = []
        for rel in hg.relations:
            lo, hi = hg.type_range(rel.dst_type)
            if lo <= v < hi:
                want += rel.indices[rel.indptr[v - lo]:
                                    rel.indptr[v - lo + 1]].tolist()
        assert union.neighbors(v).tolist() == want
    bad = hg.relations[0]
    wrong = Relation(bad.src_type, bad.name, bad.dst_type, bad.indptr,
                     bad.indices + hg.counts["paper"])      # authors' ids
    with pytest.raises(ValueError, match="outside"):
        HeteroGraph(TYPES, [wrong])


def test_loader_trains_through_gids_device_with_spans_and_counters():
    """`GIDSDataLoader(sampler="relational")` on the gids-device plane
    (device='cpu'): batches' rows are the table's rows of `all_nodes`, the
    model learns a class its neighbours' features show (R-GAT never reads
    a seed's own row), and a tracer gets the sampler's stages under
    `plan_next` and its counters."""
    hg = tiny_hetero(scale=7, classes=CLASSES)
    rng = np.random.default_rng(0)
    labels = np.arange(hg.num_nodes) % CLASSES
    feats = (2.0 * np.eye(CLASSES, DIM)[labels]
             + 0.1 * rng.standard_normal((hg.num_nodes, DIM))
             ).astype(np.float32)
    tracer = Tracer()
    dl = GIDSDataLoader(hg, feats, LoaderConfig(
        batch_size=32, fanouts=FANOUTS, sampler="relational",
        data_plane="gids-device", cache_lines=256, window_depth=2),
        train_ids=np.arange(hg.counts["paper"]), device="cpu", tracer=tracer)
    model = RGAT(RGATConfig(in_dim=DIM, hidden_dim=HIDDEN, num_heads=HEADS,
                            num_classes=CLASSES, fanouts=FANOUTS),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    losses, levels = [], []
    for _ in range(30):
        b = dl.next_batch()
        np.testing.assert_array_equal(b.features.numpy(),
                                      feats[b.blocks.all_nodes])
        y = torch.from_numpy(labels[b.blocks.seeds])
        losses.append(float(sgd_step(model, b.features,
                                     block_tensors(b.blocks, "cpu"), y,
                                     0.2)))
        levels.append([len(v) for v in b.blocks.levels])
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])
    spans = [w for w in tracer.wall_spans()
             if w.name in ("sample_relations", "build_blocks")]
    assert {w.name for w in spans} == {"sample_relations", "build_blocks"}
    assert all(w.cat == HOT_PATH and w.parent.name == "plan_next"
               for w in spans)
    m = tracer.metrics
    assert m.get("relational.slots").value \
        > m.get("relational.masked_slots").value > 0
    # every batch sampled so far, the delivered ones among them
    assert m.get("relational.level_rows.0").value >= 30 * 32
    assert m.get("relational.level_rows.3").value >= sum(l[3] for l in levels)


def test_loader_refuses_a_mismatched_sampler(hg):
    feats = np.zeros((hg.num_nodes, DIM), np.float32)
    with pytest.raises(ValueError, match="HeteroGraph"):
        GIDSDataLoader(hg, feats, LoaderConfig(fanouts=FANOUTS), device="cpu")
    with pytest.raises(ValueError, match="HeteroGraph"):
        GIDSDataLoader(hg.union(), feats,
                       LoaderConfig(fanouts=FANOUTS, sampler="relational"),
                       device="cpu")
