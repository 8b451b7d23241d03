"""HGT's joint attention kernels (`kernels/hgt_attend.py`,
`csrc/hgt_attend.cu`) against their plain versions on the card, at layer
0's shape of a real batch of the `hgt3-igbh` cell's graph and sampler
(`models/hgt.py` `hgt_blocks`), with random queries, rows and gradients at
the cell's widths (8 heads of 32).  The plain versions are held to the
formulas on the CPU by `test_torch_hgt.py`.  Every case needs a card and
skips without one; this file imports no JAX, so the card runs it:
`python3 -m pytest -m chip tests/test_torch_hgt_attend.py`."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hgt_attend import (  # noqa: E402
    HEAD_DIM, HEADS, attend_backward_ref, attend_ref, hgt_attend)

ROOT = Path(__file__).resolve().parents[1]
#: float32 kernels against the float64 formulas, by norm: a slot's score
#: is a 32-term dot product and a destination sums ~12 slots, each term
#: rounded once in float32 (~6e-8 relative); 1e-5 leaves ~100x room over
#: that and fails a TF32-rounded row (~1e-3)
CARD_REL = 1e-5
#: elementwise, over the largest magnitude of each result
CARD_ATOL = 1e-5


def _rel(a, b) -> float:
    return float((a.double() - b).norm() / b.norm())


@pytest.fixture(scope="module")
def layer0():
    """Layer 0 (hop 2, fanout 5) of one 1024-seed batch of the `hgt3-igbh`
    cell's graph on the card, as `HGT` hands it to `hgt_attend`: the CSR
    over level 2 and the rows of every relation's stacked k'/v', with
    random q, k', v' and the output's gradient g."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench.families import rgat as family
    from repro_torch.graph.hetero import HeteroGraph, Relation
    from repro_torch.models.hgt import hgt_blocks
    from repro_torch.sampling.relational import relational_sample_blocks
    cfg = json.loads((ROOT / "bench" / "configs" / "hgt3-igbh.json")
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
    hop = hgt_blocks(blocks, graph, "cuda").hops[len(cfg["fanouts"]) - 1]
    n = len(hop.indptr) - 1
    R = sum(len(rows) for _, _, rows in hop.rows)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    return (rand(n, HEADS, HEAD_DIM, scale=0.3),
            rand(R, HEADS, HEAD_DIM, scale=0.3), rand(R, HEADS, HEAD_DIM),
            hop.indptr, hop.idx, rand(n, HEADS * HEAD_DIM))


def _leaves(case):
    return [t.clone().requires_grad_() for t in case[:3]]


def _kernel_run(case, leaves=None):
    q, k, v, indptr, idx, g = case
    leaves = _leaves(case) if leaves is None else leaves
    out = hgt_attend(*leaves, indptr, idx)
    grads = torch.autograd.grad(out, leaves, g)
    return out.detach(), grads


@pytest.mark.chip
def test_card_kernels_match_the_plain_formulas(layer0):
    q, k, v, indptr, idx, g = layer0
    n, S = q.shape[0], idx.shape[0]
    counts = (indptr[1:] - indptr[:-1]).cpu()
    assert n > 30_000 and S > 3 * n and int(indptr[-1]) == S
    assert int(counts.max()) > 5          # slots of several relations
    _build.reset_launches()
    out, grads = _kernel_run(layer0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["hgt_attend_fwd"] == 1
    assert _build.LAUNCHES["hgt_attend_bwd"] == 1
    wide = [t.double() for t in (q, k, v)]
    want_out, lse = attend_ref(*wide, indptr, idx)
    want = attend_backward_ref(g.double(), *wide, indptr, idx, want_out, lse)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (want_out, *want)):
        assert _rel(a, b) < CARD_REL, (name, _rel(a, b))
        scale = float(b.abs().max())
        torch.testing.assert_close(a.double(), b, rtol=0,
                                   atol=CARD_ATOL * scale, msg=name)


@pytest.mark.chip
def test_card_backward_is_the_same_in_every_run(layer0):
    out1, first = _kernel_run(layer0)
    out2, second = _kernel_run(layer0)
    assert torch.equal(out1, out2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.chip
def test_card_forward_and_backward_allocate_no_gather(layer0):
    """The peak beyond the inputs and the results (out, dq, dk', dv') stays
    far below one (S, 8, 32) float32 gather of k' (S KB): the backward's
    scratch is ~90 bytes a slot."""
    q, k, v, indptr, idx, g = layer0
    leaves = _leaves(layer0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _kernel_run(layer0, leaves)
    torch.cuda.synchronize()
    row = HEADS * HEAD_DIM * 4
    results = (2 * q.shape[0] + 2 * k.shape[0]) * row
    extra = torch.cuda.max_memory_allocated() - base - results
    gather = idx.shape[0] * row
    assert extra < gather // 4, (extra, gather)


@pytest.mark.chip
def test_card_ragged_and_empty_destinations_match_the_plain_path():
    """Destinations with no slot (zeros), one slot, many slots across 32 a
    chunk, and a row named by many slots, at the cell's widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(11)
    counts = np.array([0, 1, 0, 70, 33, 5, 0, 1, 12, 31, 32, 3])
    R = 40
    idx = rng.integers(0, R, counts.sum())
    idx[:20] = 7                                   # one row, many slots
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    case = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .cuda() for s in ((len(counts), HEADS, HEAD_DIM),
                              (R, HEADS, HEAD_DIM), (R, HEADS, HEAD_DIM))]
    g = torch.randn(len(counts), HEADS * HEAD_DIM, device="cuda")
    case += [torch.from_numpy(indptr).cuda(),
             torch.from_numpy(idx.astype(np.int32)).cuda(), g]
    out, grads = _kernel_run(case)
    cpu = [t.detach().cpu() for t in case]
    leaves = [t.double().requires_grad_() for t in cpu[:3]]
    want_out = hgt_attend(*leaves, cpu[3], cpu[4])
    want = torch.autograd.grad(want_out, leaves, cpu[5].double())
    assert not out[torch.from_numpy(counts == 0).cuda()].any()
    for a, b in zip((out, *grads), (want_out.detach(), *want)):
        torch.testing.assert_close(a.cpu().double(), b, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.chip
@pytest.mark.parametrize("fault", ["head_dim_64", "int64_idx",
                                   "non_contiguous_k", "short_indptr",
                                   "float64"])
def test_card_wrapper_refuses_what_the_kernels_do_not_take(layer0, fault):
    q, k, v, indptr, idx, _ = layer0
    if fault == "head_dim_64":
        q, k, v = (t.reshape(t.shape[0], 4, 64) for t in (q, k, v))
    elif fault == "int64_idx":
        idx = idx.long()
    elif fault == "non_contiguous_k":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "short_indptr":
        indptr = indptr[:-1]
    else:
        q, k, v = (t.double() for t in (q, k, v))
    with pytest.raises(ValueError):
        hgt_attend(q, k, v, indptr, idx)
