"""R-GAT's relation attention (`kernels/relation_attend.py`): the plain
forward (online softmax over the slots) and the hand-written backward (the
flash-attention identity, grad_z summed by source row) against autograd
of the formulation `RGAT._attend` used before the kernels (gathered rows,
masked softmax, einsum), in float64 on the CPU.  The card's cases run the
CUDA kernels at layer 0's shapes of a real batch of the `rgat3-igbh`
cell's sampler and skip without a card.  This file imports no JAX, so the
card runs it: `python3 -m pytest -m chip tests/test_torch_relation_attend.py`."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.relation_attend import (  # noqa: E402
    RelationAttend, attend_backward_ref, attend_ref, relation_attend)

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


def _before(z, a_src, a_dst, i_src, i_dst, mask):
    """`RGAT._attend` after the projection, as it was before the kernels,
    and its pre-activation scores (m, f, H)."""
    i_src, i_dst = i_src.long(), i_dst.long()
    m = i_src.shape[0]
    score_src = (z * a_src).sum(-1)
    score_dst = (z * a_dst).sum(-1)
    x = score_src[i_src] + score_dst[i_dst][:, None]
    e = F.leaky_relu(x, 0.2).masked_fill(~mask[..., None], float("-inf"))
    alpha = torch.softmax(e, dim=1)
    out = torch.einsum("mfh,mfhc->mhc", alpha, z[i_src]).reshape(m, -1)
    return out, x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f,H,C", SHAPES)
def test_plain_forward_is_the_masked_softmax(f, H, C, kind):
    case = _case(f, H, C, kind)
    out, lse = attend_ref(*case)
    want, x = _before(*case)
    torch.testing.assert_close(out, want, **F64_TOL)
    mask = case[5]
    # both sides of the LeakyReLU kink among the unmasked slots
    live = x[mask]
    assert (live > 0).any() and (live < 0).any()
    e = F.leaky_relu(x, 0.2).masked_fill(~mask[..., None], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(e, dim=1), **F64_TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f,H,C", SHAPES)
def test_plain_backward_is_autograd_of_the_masked_softmax(f, H, C, kind):
    z, a_src, a_dst, i_src, i_dst, mask = _case(f, H, C, kind, seed=1)
    leaves = [t.clone().requires_grad_() for t in (z, a_src, a_dst)]
    want_out, _ = _before(*leaves, i_src, i_dst, mask)
    g = torch.randn(want_out.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(f * H + C))
    want = torch.autograd.grad(want_out, leaves, g)
    out, lse = attend_ref(z, a_src, a_dst, i_src, i_dst, mask)
    got = attend_backward_ref(g, z, a_src, a_dst, i_src, i_dst, mask, out,
                              lse)
    for name, a, b in zip(("grad_z", "grad_a_src", "grad_a_dst"), got, want):
        torch.testing.assert_close(a, b, **F64_TOL, msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_function_gradients_pass_gradcheck(kind):
    """The autograd.Function on the CPU: its hand-written backward against
    finite differences."""
    z, a_src, a_dst, i_src, i_dst, mask = _case(4, 2, 3, kind, seed=2, m=9,
                                                R=14)
    leaves = [t.requires_grad_() for t in (z, a_src, a_dst)]
    assert torch.autograd.gradcheck(
        lambda *t: RelationAttend.apply(*t, i_src, i_dst, mask), leaves)


@pytest.mark.parametrize("what", ["masked_slots_ignored",
                                  "no_unmasked_slot_gives_zeros"])
def test_masked_slots_are_never_read(what):
    z, a_src, a_dst, i_src, i_dst, mask = _case(5, 4, 16, "random_mask",
                                                seed=3)
    out, lse = attend_ref(z, a_src, a_dst, i_src, i_dst, mask)
    if what == "masked_slots_ignored":
        moved = torch.where(mask, i_src, (i_src + 7) % z.shape[0])
        again, lse2 = attend_ref(z, a_src, a_dst, moved, i_dst, mask)
        assert torch.equal(out, again) and torch.equal(lse, lse2)
    else:
        mask[3] = False
        out, lse = attend_ref(z, a_src, a_dst, i_src, i_dst, mask)
        assert torch.isfinite(out).all()
        assert not out[3].any() and torch.isneginf(lse[3]).all()
        g = torch.ones_like(out)
        grads = attend_backward_ref(g, z, a_src, a_dst, i_src, i_dst, mask,
                                    out, lse)
        assert all(torch.isfinite(t).all() for t in grads)


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
def layer0():
    """The largest relation block at layer 0 (hop 2, fanout 5) of one
    1024-seed batch of the `rgat3-igbh` cell's graph and sampler, on the
    card, with random projections at its widths (H 4, C 128)."""
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
    hop = block_tensors(blocks, "cuda").hops[len(cfg["fanouts"]) - 1]
    b = max(hop, key=lambda t: len(t.rows))
    m, f = b.src.shape
    ref, inv = torch.unique(torch.cat([b.src.reshape(-1), b.nxt]),
                            return_inverse=True)
    inv = inv.to(torch.int32)
    H = cfg["num_heads"]
    C = cfg["hidden_dim"] // H
    gen = torch.Generator(device="cuda").manual_seed(5)
    z = torch.randn((len(ref), H, C), generator=gen, device="cuda")
    a_src, a_dst = (0.1 * torch.randn((H, C), generator=gen, device="cuda")
                    for _ in range(2))
    g = torch.randn((m, H * C), generator=gen, device="cuda")
    return (z, a_src, a_dst, inv[:m * f].reshape(m, f), inv[m * f:],
            b.mask, g)


def _leaves(case):
    return [t.clone().requires_grad_() for t in case[:3]]


def _kernel_run(case, leaves=None):
    z, a_src, a_dst, i_src, i_dst, mask, g = case
    leaves = _leaves(case) if leaves is None else leaves
    out = relation_attend(*leaves, i_src, i_dst, mask)
    grads = torch.autograd.grad(out, leaves, g)
    return out.detach(), grads


@pytest.mark.chip
def test_card_kernels_match_the_plain_formulas(layer0):
    z, a_src, a_dst, i_src, i_dst, mask, g = layer0
    m, f = i_src.shape
    assert f == 5 and z.shape[1:] == (4, 128) and m >= 10_000
    assert mask.all(dim=1).all()          # the sampler masks whole rows
    _build.reset_launches()
    out, grads = _kernel_run(layer0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["relation_attend_fwd"] == 1
    assert _build.LAUNCHES["relation_attend_bwd"] == 1
    wide = [t.double() for t in (z, a_src, a_dst)]
    want_out, lse = attend_ref(*wide, i_src, i_dst, mask)
    want = attend_backward_ref(g.double(), *wide, i_src, i_dst, mask,
                               want_out, lse)
    for name, a, b in zip(("out", "grad_z", "grad_a_src", "grad_a_dst"),
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
@pytest.mark.parametrize("fault", ["head_dim_64", "int64_indices",
                                   "non_contiguous"])
def test_card_wrapper_refuses_what_the_kernels_do_not_take(layer0, fault):
    z, a_src, a_dst, i_src, i_dst, mask, _ = layer0
    if fault == "head_dim_64":
        z, a_src, a_dst = z[..., :64].contiguous(), a_src[:, :64], \
            a_dst[:, :64]
        a_src, a_dst = a_src.contiguous(), a_dst.contiguous()
    elif fault == "int64_indices":
        i_src = i_src.long()
    else:
        i_src = i_src.t().contiguous().t()
    with pytest.raises(ValueError):
        relation_attend(z, a_src, a_dst, i_src, i_dst, mask)
