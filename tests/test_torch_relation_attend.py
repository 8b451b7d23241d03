"""R-GAT's relation attention (`kernels/relation_attend.py`): the plain
forward (online softmax over the slots) and the hand-written backward (the
flash-attention identity, grad_z summed by source row, grad_s_dst summed
by destination) against autograd of the formulation `RGAT._attend` used
before the kernels (gathered rows, masked softmax, einsum), and the
destination scores through W folded into a_dst against the score from
z[i_dst], in float64 on the CPU.  The card's cases run the CUDA kernels at
layer 0's shapes of a real batch of the `rgat3-igbh` cell's sampler and
skip without a card.  This file imports no JAX, so the card runs it:
`python3 -m pytest -m chip tests/test_torch_relation_attend.py`."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.relation_attend import (  # noqa: E402
    RelationAttend, attend_backward_ref, attend_ref, fold_scores,
    fold_scores_backward_ref, fold_scores_ref, relation_attend)

ROOT = Path(__file__).resolve().parents[1]
#: float64 against float64: the two formulations differ by the order of
#: their sums and by alpha = exp(e - lse) against exp(e - max) / sum
F64_TOL = {"rtol": 1e-10, "atol": 1e-12}
#: (f, H, C): the cell's fanouts at its width, and a small head
SHAPES = [(5, 4, 128), (10, 4, 128), (15, 4, 128), (5, 2, 3), (15, 3, 8)]
KINDS = ("random_mask", "one_unmasked", "repeated_source", "all_unmasked")


def _case(f, H, C, kind, seed=0, m=37, R=53, dtype=torch.float64):
    """(z, a_src, a_dst, i_src, i_dst, mask): every destination keeps at
    least one unmasked slot; `one_unmasked` gives destination 0 exactly
    one, `repeated_source` repeats a source within destination 1's row and
    across rows, and i_dst rows are distinct (a block's destinations)."""
    rng = np.random.default_rng(seed + 1000 * f + 10 * H + C)
    z = torch.from_numpy(rng.standard_normal((R, H, C)))
    a_src = torch.from_numpy(rng.standard_normal((H, C)) / np.sqrt(C))
    a_dst = torch.from_numpy(rng.standard_normal((H, C)) / np.sqrt(C))
    i_src = rng.integers(0, R, (m, f))
    i_dst = rng.permutation(R)[:m]
    mask = rng.random((m, f)) < 0.7
    if kind == "all_unmasked":
        mask[:] = True
    mask[np.arange(m), rng.integers(0, f, m)] = True
    if kind == "one_unmasked":
        mask[0] = False
        mask[0, f - 1] = True
    if kind == "repeated_source":
        i_src[1] = i_src[1, 0]
        mask[1] = True
        i_src[2:, 0] = i_src[1, 0]
    return (z.to(dtype), a_src.to(dtype), a_dst.to(dtype),
            torch.from_numpy(i_src.astype(np.int32)),
            torch.from_numpy(i_dst.astype(np.int32)), torch.from_numpy(mask))


def _scores(z, a_dst, i_dst):
    """Each destination's score from its own projected row, a_dst . z[i_dst]
    per head (m, H): the form before W was folded into a_dst."""
    return (z[i_dst.long()] * a_dst).sum(-1)


def _before(z, a_src, s_dst, i_src, mask):
    """`RGAT._attend` after the projection, as it was before the kernels,
    and its pre-activation scores (m, f, H)."""
    i_src = i_src.long()
    m = i_src.shape[0]
    score_src = (z * a_src).sum(-1)
    x = score_src[i_src] + s_dst[:, None]
    e = F.leaky_relu(x, 0.2).masked_fill(~mask[..., None], float("-inf"))
    alpha = torch.softmax(e, dim=1)
    out = torch.einsum("mfh,mfhc->mhc", alpha, z[i_src]).reshape(m, -1)
    return out, x


def _kernel_args(z, a_src, a_dst, i_src, i_dst, mask):
    """A `_case` as the kernel takes it: (z, a_src, s_dst, i_src, mask)."""
    return z, a_src, _scores(z, a_dst, i_dst), i_src, mask


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f,H,C", SHAPES)
def test_plain_forward_is_the_masked_softmax(f, H, C, kind):
    case = _kernel_args(*_case(f, H, C, kind))
    out, lse = attend_ref(*case)
    want, x = _before(*case)
    torch.testing.assert_close(out, want, **F64_TOL)
    mask = case[4]
    # both sides of the LeakyReLU kink among the unmasked slots
    live = x[mask]
    assert (live > 0).any() and (live < 0).any()
    e = F.leaky_relu(x, 0.2).masked_fill(~mask[..., None], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(e, dim=1), **F64_TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f,H,C", SHAPES)
def test_plain_backward_is_autograd_of_the_masked_softmax(f, H, C, kind):
    z, a_src, s_dst, i_src, mask = _kernel_args(*_case(f, H, C, kind,
                                                       seed=1))
    leaves = [t.clone().requires_grad_() for t in (z, a_src, s_dst)]
    want_out, _ = _before(*leaves, i_src, mask)
    g = torch.randn(want_out.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(f * H + C))
    want = torch.autograd.grad(want_out, leaves, g)
    out, lse = attend_ref(z, a_src, s_dst, i_src, mask)
    got = attend_backward_ref(g, z, a_src, s_dst, i_src, mask, out, lse)
    for name, a, b in zip(("grad_z", "grad_a_src", "grad_s_dst"), got, want):
        torch.testing.assert_close(a, b, **F64_TOL, msg=name)


def _fold_case(f, H, C, kind, seed=4, m=37, n=101, d=7):
    """Features x (n, d), W (d, H * C), a_src, a_dst, and a block whose
    slots and destinations are rows of x: destinations drawn apart from the
    sources where `kind` is "cross_type" (a relation between two types),
    else among them."""
    rng = np.random.default_rng(seed + 1000 * f + 10 * H + C)
    _, a_src, a_dst, i_src, _, mask = _case(f, H, C, kind if kind in KINDS
                                            else "random_mask", seed=seed,
                                            m=m, R=n // 2)
    x = torch.from_numpy(rng.standard_normal((n, d)))
    w = torch.from_numpy(rng.standard_normal((d, H * C)) / np.sqrt(d))
    lo = n // 2 if kind == "cross_type" else 0
    i_dst = torch.from_numpy(lo + rng.permutation(n - lo)[:m])
    return x, w, a_src, a_dst, i_src.long(), i_dst, mask


def _fold_paths(x, w, a_src, a_dst, i_src, i_dst, mask):
    """m_v,r both ways: every row the slots and destinations name projected
    and each destination scored from its row of z (before), and the source
    rows alone projected with the destinations scored through W folded into
    a_dst (`RGAT._dst_scores`, `RGAT._attend`; `fold_scores` on the
    CPU)."""
    H, C = a_src.shape
    m, f = i_src.shape
    ref, inv = torch.unique(torch.cat([i_src.reshape(-1), i_dst]),
                            return_inverse=True)
    z = (x[ref] @ w).reshape(len(ref), H, C)
    before, _ = _before(z, a_src, _scores(z, a_dst, inv[m * f:]),
                        inv[:m * f].reshape(m, f), mask)
    ref, inv = torch.unique(i_src, return_inverse=True)
    z = (x[ref] @ w).reshape(len(ref), H, C)
    ut = (w.view(-1, H, C) * a_dst).sum(-1).t()
    after = RelationAttend.apply(z, a_src, fold_scores(x, i_dst, ut),
                                 inv.to(torch.int32), mask)
    return before, after


@pytest.mark.parametrize("kind", KINDS + ("cross_type",))
@pytest.mark.parametrize("f,H,C", SHAPES)
def test_fold_gives_the_z_dst_logits_and_gradients(f, H, C, kind):
    """The destination scores through W folded into a_dst against the
    score from the destination's own projected row, in float64: the
    output and the gradients in x, W, a_src and a_dst."""
    x, w, a_src, a_dst, i_src, i_dst, mask = _fold_case(f, H, C, kind)
    leaves = [t.clone().requires_grad_() for t in (x, w, a_src, a_dst)]
    before, after = _fold_paths(*leaves, i_src, i_dst, mask)
    torch.testing.assert_close(after, before, **F64_TOL)
    g = torch.randn(before.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(f + H + C))
    want = torch.autograd.grad(before, leaves, g)
    got = torch.autograd.grad(after, leaves, g)
    for name, a, b in zip(("x", "w", "a_src", "a_dst"), got, want):
        torch.testing.assert_close(a, b, **F64_TOL, msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_function_gradients_pass_gradcheck(kind):
    """The autograd.Function on the CPU: its hand-written backward against
    finite differences, in z, a_src and s_dst."""
    z, a_src, s_dst, i_src, mask = _kernel_args(
        *_case(4, 2, 3, kind, seed=2, m=9, R=14))
    leaves = [t.requires_grad_() for t in (z, a_src, s_dst)]
    assert torch.autograd.gradcheck(
        lambda *t: RelationAttend.apply(*t, i_src, mask), leaves)


@pytest.mark.parametrize("kind", KINDS + ("cross_type",))
def test_fold_gradients_pass_gradcheck(kind):
    """The folded path end to end (x, W, a_src and a_dst through the
    projection, the fold and the Function) against finite differences."""
    x, w, a_src, a_dst, i_src, i_dst, mask = _fold_case(4, 2, 3, kind, m=9,
                                                        n=23, d=5)
    leaves = [t.requires_grad_() for t in (x, w, a_src, a_dst)]
    assert torch.autograd.gradcheck(
        lambda *t: _fold_paths(*t, i_src, i_dst, mask)[1], leaves)


@pytest.mark.parametrize("what", ["masked_slots_ignored",
                                  "no_unmasked_slot_gives_zeros",
                                  "masked_row_score_unread"])
def test_masked_slots_are_never_read(what):
    z, a_src, s_dst, i_src, mask = _kernel_args(
        *_case(5, 4, 16, "random_mask", seed=3))
    out, lse = attend_ref(z, a_src, s_dst, i_src, mask)
    g = torch.randn(out.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    if what == "masked_slots_ignored":
        moved = torch.where(mask, i_src, (i_src + 7) % z.shape[0])
        again, lse2 = attend_ref(z, a_src, s_dst, moved, mask)
        assert torch.equal(out, again) and torch.equal(lse, lse2)
        grads = attend_backward_ref(g, z, a_src, s_dst, i_src, mask, out,
                                    lse)
        moved_grads = attend_backward_ref(g, z, a_src, s_dst, moved, mask,
                                          again, lse2)
        assert all(torch.equal(a, b) for a, b in zip(grads, moved_grads))
        return
    mask[3] = False
    out, lse = attend_ref(z, a_src, s_dst, i_src, mask)
    grads = attend_backward_ref(g, z, a_src, s_dst, i_src, mask, out, lse)
    if what == "no_unmasked_slot_gives_zeros":
        assert torch.isfinite(out).all()
        assert not out[3].any() and torch.isneginf(lse[3]).all()
        assert all(torch.isfinite(t).all() for t in grads)
        assert not grads[2][3].any()          # its score takes no gradient
        assert grads[2].abs().sum() > 0
    else:
        # a destination without an unmasked slot: its score is never read
        moved = s_dst.clone()
        moved[3] += 5.0
        again, lse2 = attend_ref(z, a_src, moved, i_src, mask)
        assert torch.equal(out, again) and torch.equal(lse, lse2)
        moved_grads = attend_backward_ref(g, z, a_src, moved, i_src, mask,
                                          again, lse2)
        assert all(torch.equal(a, b) for a, b in zip(grads, moved_grads))


# -- on the card ---------------------------------------------------------------

#: kernel against the plain formulas in float64 on the same inputs, as the
#: norm of the difference over the norm of the float64 result.  The kernel
#: sums in float32 in another order (a warp's shuffle tree, the slots in
#: flat order): a few float32 ulps, ~1e-7 of a norm; 1e-5 leaves room and
#: is far below what a wrong slot, head or softmax gives (order 1).
CARD_REL = 1e-5
#: elementwise, over the largest magnitude of each result
CARD_ATOL = 1e-5


def _rel(a, b) -> float:
    return float((a.double() - b).norm() / b.norm())


@pytest.fixture(scope="module")
def batch():
    """One 1024-seed batch of the `rgat3-igbh` cell's graph and sampler on
    the card (`RGATBlocks`), and the configuration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench.families import rgat as family
    from repro_torch.graph.hetero import HeteroGraph, Relation
    from repro_torch.models.rgat import block_tensors
    from repro_torch.sampling.relational import relational_sample_blocks
    cfg = json.loads((ROOT / "bench" / "configs" / "rgat3-igbh.json")
                     .read_text())
    rels = family.relation_csrs(cfg, torch.device("cuda"))
    graph = HeteroGraph(cfg["nodes"], [
        Relation(r["src"], r["name"], r["dst"], r["indptr"], r["indices"])
        for r in rels], feature_dim=cfg["in_dim"], name=cfg["name"])
    cites = next(r for r in rels if r["name"] == "cites")
    rng = np.random.default_rng(2**31 + 7)
    seeds = rng.choice(np.flatnonzero(np.diff(cites["indptr"])), 1024,
                       replace=False)
    blocks = relational_sample_blocks(graph, seeds, cfg["fanouts"], rng)
    return block_tensors(blocks, "cuda"), cfg


@pytest.fixture(scope="module")
def layer0(batch):
    """The largest relation block at layer 0 (hop 2, fanout 5) of the
    batch, as `RGAT._attend` indexes it, with random projections at the
    cell's widths (H 4, C 128) and random destination scores."""
    blocks, cfg = batch
    hop = blocks.hops[len(cfg["fanouts"]) - 1]
    b = max(hop, key=lambda t: len(t.rows))
    m, f = b.src.shape
    ref, inv = torch.unique(b.src, return_inverse=True)
    H = cfg["num_heads"]
    C = cfg["hidden_dim"] // H
    gen = torch.Generator(device="cuda").manual_seed(5)
    z = torch.randn((len(ref), H, C), generator=gen, device="cuda")
    a_src = 0.1 * torch.randn((H, C), generator=gen, device="cuda")
    s_dst = torch.randn((m, H), generator=gen, device="cuda")
    g = torch.randn((m, H * C), generator=gen, device="cuda")
    return z, a_src, s_dst, inv.to(torch.int32), b.mask, g


def _leaves(case):
    return [t.clone().requires_grad_() for t in case[:3]]


def _kernel_run(case, leaves=None):
    z, a_src, s_dst, i_src, mask, g = case
    leaves = _leaves(case) if leaves is None else leaves
    out = relation_attend(*leaves, i_src, mask)
    grads = torch.autograd.grad(out, leaves, g)
    return out.detach(), grads


@pytest.mark.chip
def test_card_kernels_match_the_plain_formulas(layer0):
    z, a_src, s_dst, i_src, mask, g = layer0
    m, f = i_src.shape
    assert f == 5 and z.shape[1:] == (4, 128) and m >= 10_000
    assert mask.all(dim=1).all()          # the sampler masks whole rows
    _build.reset_launches()
    out, grads = _kernel_run(layer0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["relation_attend_fwd"] == 1
    assert _build.LAUNCHES["relation_attend_bwd"] == 1
    wide = [t.double() for t in (z, a_src, s_dst)]
    want_out, lse = attend_ref(*wide, i_src, mask)
    want = attend_backward_ref(g.double(), *wide, i_src, mask, want_out, lse)
    for name, a, b in zip(("out", "grad_z", "grad_a_src", "grad_s_dst"),
                          (out, *grads), (want_out, *want)):
        assert _rel(a, b) < CARD_REL, (name, _rel(a, b))
        scale = float(b.abs().max())
        torch.testing.assert_close(a.double(), b, rtol=0,
                                   atol=CARD_ATOL * scale, msg=name)


@pytest.mark.chip
def test_card_backward_is_the_same_in_every_run(layer0):
    _, first = _kernel_run(layer0)
    _, second = _kernel_run(layer0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.chip
def test_card_forward_and_backward_allocate_no_gather(layer0):
    """What the forward and backward allocate beyond their outputs (out and
    grad_z) stays below an eighth of one (m, f, H, C) float32 tensor, which
    the einsum path held twice (the gather and its gradient): the scratch
    is alpha and de per slot and head, the keys and their sort."""
    z, _, _, i_src, *_ = layer0
    m, f = i_src.shape
    R, H, C = z.shape
    leaves = _leaves(layer0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _kernel_run(layer0, leaves)
    torch.cuda.synchronize()
    scratch = (torch.cuda.max_memory_allocated() - base
               - (m + R) * H * C * 4)
    assert scratch < m * f * H * C * 4 // 8


@pytest.mark.chip
def test_card_z_holds_only_the_source_rows(batch):
    """R-GAT's forward at the cell's widths on the batch: every relation
    with a destination projects exactly its slots' unique rows (never its
    destinations'), the fold scores each level's rows once, and the
    forward launches the kernel once a block."""
    from repro_torch.models.rgat import RGAT, RGATConfig
    blocks, cfg = batch
    model = RGAT(RGATConfig(
        in_dim=cfg["in_dim"], hidden_dim=cfg["hidden_dim"],
        num_heads=cfg["num_heads"], num_classes=cfg["num_classes"],
        fanouts=tuple(cfg["fanouts"]),
        relations=tuple(tuple(r) for r in cfg["relations"])), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    feats = torch.randn((blocks.level_sizes[-1], cfg["in_dim"]),
                        generator=gen, device="cuda")
    _build.reset_launches()
    with torch.no_grad():
        model(feats, blocks)
    torch.cuda.synchronize()
    names = [r[1] for r in cfg["relations"]]
    L = len(cfg["fanouts"])
    for l, rows in enumerate(model.last_rows):
        k = L - 1 - l
        want = {names[b.relation]: len(torch.unique(b.src))
                for b in blocks.hops[k] if len(b.rows)}
        assert rows["projected"] == want
        assert rows["scored"] == blocks.level_sizes[k]
    n_blocks = sum(1 for hop in blocks.hops for b in hop if len(b.rows))
    assert _build.LAUNCHES["relation_attend_fwd"] == n_blocks


def _scores_case(batch, layer):
    """`fold_scores`' inputs at a layer's shapes of the batch: layer 0
    reads level 2's rows from level 3's 1024-d rows, layer 1 level 1's from
    level 2's 512-d rows; 28 columns (7 relations, 4 heads); random h, ut
    and scores' gradient."""
    blocks, cfg = batch
    k = len(cfg["fanouts"]) - 1 - layer
    d = cfg["in_dim"] if layer == 0 else cfg["hidden_dim"]
    J = len(cfg["relations"]) * cfg["num_heads"]
    pos = blocks.level_pos[k]
    gen = torch.Generator(device="cuda").manual_seed(7 + layer)
    h = torch.randn((blocks.level_sizes[k + 1], d), generator=gen,
                    device="cuda")
    ut = torch.randn((J, d), generator=gen, device="cuda") / d ** 0.5
    g = torch.randn((len(pos), J), generator=gen, device="cuda")
    return h, pos, ut, g


def _scores_run(h, pos, ut, g):
    leaves = [h.clone().requires_grad_(), ut.clone().requires_grad_()]
    out = fold_scores(leaves[0], pos, leaves[1])
    return (out.detach(), *torch.autograd.grad(out, leaves, g))


@pytest.mark.chip
@pytest.mark.parametrize("layer", [0, 1])
def test_card_fold_scores_match_the_plain_formulas(batch, layer):
    """`fold_scores` forward and backward (grad_h and grad_ut) within
    CARD_REL of the plain formulas in float64, bit-equal over two runs."""
    h, pos, ut, g = _scores_case(batch, layer)
    _build.reset_launches()
    got = _scores_run(h, pos, ut, g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fold_scores_fwd"] == 1
    assert _build.LAUNCHES["fold_scores_bwd"] == 1
    wide = [t.double() for t in (h, ut)]
    want = (fold_scores_ref(wide[0], pos, wide[1]),
            *fold_scores_backward_ref(g.double(), wide[0], pos, wide[1],
                                      True))
    for name, a, b in zip(("scores", "grad_h", "grad_ut"), got, want):
        assert _rel(a, b) < CARD_REL, (name, _rel(a, b))
    assert all(torch.equal(a, b) for a, b in zip(got, _scores_run(h, pos, ut,
                                                                  g)))


@pytest.mark.chip
def test_card_fold_scores_allocate_no_gather(batch):
    """At layer 0, what `fold_scores` allocates beyond its inputs' clones,
    the scores and the gradients stays below a quarter of the (n, d)
    gather of the rows it reads (the scratch: one (J, d) partial a
    block)."""
    h, pos, ut, g = _scores_case(batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _scores_run(h, pos, ut, g)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base
             - 2 * (h.numel() + ut.numel()) * 4 - 2 * g.numel() * 4)
    assert extra < len(pos) * h.shape[1] * 4 // 4


@pytest.mark.chip
@pytest.mark.parametrize("fault", ["head_dim_64", "int64_indices",
                                   "non_contiguous"])
def test_card_wrapper_refuses_what_the_kernels_do_not_take(layer0, fault):
    z, a_src, s_dst, i_src, mask, _ = layer0
    if fault == "head_dim_64":
        z, a_src = z[..., :64].contiguous(), a_src[:, :64].contiguous()
    elif fault == "int64_indices":
        i_src = i_src.long()
    else:
        i_src = i_src.t().contiguous().t()
    with pytest.raises(ValueError):
        relation_attend(z, a_src, s_dst, i_src, mask)
