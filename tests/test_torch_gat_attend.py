"""GAT's attention over the fanout (`kernels/gat_attend.py`,
`csrc/gat_attend.cu`).

On the CPU: `gat_attend` is the eager chain `GNN._layer` ran before the
kernels, bit for bit, forward and autograd's gradients (also at the
LeakyReLU's kink), and the kernels' backward formulas (`attend_backward_ref`,
through `GATAttend`) against autograd and float64 `gradcheck`.  On the card
(marked `chip`, skipped without one): the kernels against the float64
formulas at layer 0's shapes of a 1024-seed batch of the `gat3-igbs` cell,
bit-equal over two runs, the wrapper's refusals, and one GAT `sgd_step`'s
launches.  This file imports no JAX, so the card runs it:
`python3 -m pytest -m chip tests/test_torch_gat_attend.py`."""
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gat_attend import (  # noqa: E402
    HEAD_DIM, HEADS, MAX_FANOUT, GATAttend, attend_backward_ref, attend_ref,
    gat_attend)
from repro_torch.models.gnn import GNN, GNNConfig, sgd_step  # noqa: E402

#: float32 kernels against the float64 formulas, by norm: a score is a
#: 32-term dot product and a destination sums <= 10 slots, each term
#: rounded once in float32 (~6e-8 relative); 1e-5 leaves ~100x room over
#: that and fails a TF32-rounded product (~1e-3)
CARD_REL = 1e-5
#: elementwise, over the largest magnitude of each result
CARD_ATOL = 1e-5


def _eager_layer(p, x_dst, x_nbr, fanout, heads):
    """`GNN._layer`'s GAT branch as it was before the kernels."""
    n, f, H = x_dst.shape[0], fanout, heads
    hd = p["w_nbr"].shape[1] // H
    zd = (x_dst @ p["w_self"]).reshape(n, H, hd)
    zn = (x_nbr @ p["w_nbr"]).reshape(n, f, H, hd)
    es = (zd * p["attn_src"]).sum(-1)                  # (n, H)
    en = (zn * p["attn_dst"]).sum(-1)                  # (n, f, H)
    e = F.leaky_relu(es[:, None, :] + en, 0.2)
    a = torch.softmax(e, dim=1)
    agg = (a[..., None] * zn).sum(dim=1)               # (n, H, hd)
    return F.elu(agg.reshape(n, H * hd) + p["b"])


def _gat(fanouts, in_dim=24, seed=0, device="cpu"):
    cfg = GNNConfig(model="gat", in_dim=in_dim, hidden_dim=HEADS * HEAD_DIM,
                    num_classes=7, fanouts=fanouts, num_heads=HEADS)
    return GNN(cfg, generator=torch.Generator().manual_seed(seed),
               device=device)


def _attention_inputs(n, f, dtype=torch.float32, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, dtype=dtype)
                ).to(device)
    return (rand(n, HEADS, HEAD_DIM), rand(n, f, HEADS, HEAD_DIM),
            rand(HEADS, HEAD_DIM, scale=HEAD_DIM ** -0.5),
            rand(HEADS, HEAD_DIM, scale=HEAD_DIM ** -0.5))


def _grads(out, leaves, seed=1):
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=out.dtype).to(out.device)
    return torch.autograd.grad(out, leaves, g), g


@pytest.mark.parametrize("fanout", [10, 5])
def test_layer_is_the_eager_chain_bit_for_bit(fanout):
    model = _gat((fanout,))
    p = model.layer[0]
    gen = torch.Generator().manual_seed(3)
    x_dst = torch.randn(37, 24, generator=gen)
    x_nbr = torch.randn(37 * fanout, 24, generator=gen)
    leaves = list(p.values())
    got = model._layer(p, x_dst, None, x_nbr=x_nbr, fanout=fanout)
    want = _eager_layer(p, x_dst, x_nbr, fanout, HEADS)
    assert torch.equal(got, want)
    got_grads, _ = _grads(got, leaves)
    want_grads, _ = _grads(want, leaves)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


def _at_the_kink(f):
    """Inputs where row 0's slot 3 scores exactly 0 in every head (zd[0] and
    zn[0, 3] zero), the LeakyReLU's kink, where torch's backward takes the
    negative slope."""
    zd, zn, a_src, a_dst = _attention_inputs(9, f, dtype=torch.float64)
    zd[0] = 0.0
    zn[0, 3] = 0.0
    return zd, zn, a_src, a_dst


@pytest.mark.parametrize("fanout", [10, 5])
def test_plain_version_at_the_kink_is_the_eager_chain(fanout):
    inputs = [t.float() for t in _at_the_kink(fanout)]
    s = ((inputs[0] * inputs[2]).sum(-1)[:, None]
         + (inputs[1] * inputs[3]).sum(-1))
    assert (s[0, 3] == 0).all()
    leaves = [t.clone().requires_grad_() for t in inputs]
    got = gat_attend(*leaves)
    p = {"w_self": torch.eye(HEADS * HEAD_DIM),
         "w_nbr": torch.eye(HEADS * HEAD_DIM), "attn_src": leaves[2],
         "attn_dst": leaves[3], "b": torch.zeros(HEADS * HEAD_DIM)}
    n = inputs[0].shape[0]
    x_dst = leaves[0].reshape(n, -1)
    x_nbr = leaves[1].reshape(n * fanout, -1)
    want = _eager_layer(p, x_dst, x_nbr, fanout, HEADS)
    assert torch.equal(F.elu(got), want)
    got_grads, _ = _grads(F.elu(got), leaves)
    want_grads, _ = _grads(want, leaves)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fanout,kink", [(10, False), (5, False),
                                         (1, False), (MAX_FANOUT, False),
                                         (10, True), (5, True)])
def test_backward_formulas_are_autograds(fanout, kink):
    inputs = (_at_the_kink(fanout) if kink
              else _attention_inputs(11, fanout, dtype=torch.float64))
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = attend_ref(*leaves)
    want, g = _grads(out, leaves)
    got = attend_backward_ref(g, *inputs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fanout", [5, 3])
def test_function_passes_gradcheck_in_float64(fanout):
    inputs = [t.requires_grad_() for t in _attention_inputs(
        4, fanout, dtype=torch.float64, seed=fanout)]
    assert torch.autograd.gradcheck(GATAttend.apply, inputs)


# -- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def layer0():
    """Layer 0's three levels at a 1024-seed `gat3-igbs` batch, (n, f):
    seeds over 10 slots, then hop 1 and hop 2 over 5; random zd, zn and
    gradient at the cell's widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = []
    for i, (n, f) in enumerate(((1024, 10), (10_240, 5), (51_200, 5))):
        zd, zn, a_src, a_dst = _attention_inputs(n, f, seed=i, device="cuda")
        g = torch.randn((n, HEADS * HEAD_DIM), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        cases.append((zd, zn, a_src, a_dst, g))
    return cases


def _kernel_run(case):
    *inputs, g = case
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = gat_attend(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, g)


@pytest.mark.chip
def test_card_kernels_match_the_float64_formulas(layer0):
    for case in layer0:
        *inputs, g = case
        _build.reset_launches()
        out, grads = _kernel_run(case)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["gat_attend_fwd"] == 1
        assert _build.LAUNCHES["gat_attend_bwd"] == 1
        wide = [t.double() for t in inputs]
        want = (attend_ref(*wide),
                *attend_backward_ref(g.double(), *wide))
        for name, a, b in zip(("out", "dzd", "dzn", "d_src", "d_dst"),
                              (out, *grads), want):
            rel = float((a.double() - b).norm() / b.norm())
            assert rel < CARD_REL, (name, rel)
            torch.testing.assert_close(
                a.double(), b, rtol=0, atol=CARD_ATOL * float(b.abs().max()),
                msg=name)


def _eager_run(case):
    """The eager chain under autograd on the card, as the reference runs
    it."""
    *inputs, g = case
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = attend_ref(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, g)


@pytest.mark.chip
def test_card_kernels_are_the_eager_chain_bit_for_bit(layer0):
    for case in layer0:
        out, grads = _kernel_run(case)
        want_out, want = _eager_run(case)
        assert torch.equal(out, want_out)
        for name, a, b in zip(("dzd", "dzn", "d_src", "d_dst"), grads, want):
            assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.chip
def test_card_kernels_are_the_same_in_every_run(layer0):
    for case in layer0:
        out1, first = _kernel_run(case)
        out2, second = _kernel_run(case)
        assert torch.equal(out1, out2)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.chip
def test_card_torch_sums_a_head_in_the_kernels_order():
    """`(x * y).sum(-1)` over 32 floats on the card, which the reference
    computes for every score, sums as the kernels' `head_dot` does: the
    products halved 16, 8, 4, 2, 1 apart.  If a PyTorch release changes
    its order, this fails before the benchmark's `correct` does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator("cuda").manual_seed(23)
    x, y = (torch.randn((4096, HEADS, HEAD_DIM), generator=gen,
                        device="cuda") for _ in range(2))
    p = x * y
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    assert torch.equal((x * y).sum(-1), p[..., 0])


def _near_the_kink(n, f, seed, device="cuda"):
    """Random inputs with zd and every slot row orthogonal to their head's
    attention vector in float64, then rounded to float32: every score is
    rounding, and its sign, the LeakyReLU's slope, depends on the order in
    which its dot products are summed."""
    zd, zn, a_src, a_dst = _attention_inputs(n, f, dtype=torch.float64,
                                             seed=seed)
    zd = zd - ((zd * a_src).sum(-1, keepdim=True)
               / (a_src * a_src).sum(-1, keepdim=True)) * a_src
    zn = zn - ((zn * a_dst).sum(-1, keepdim=True)
               / (a_dst * a_dst).sum(-1, keepdim=True)) * a_dst
    return [t.float().to(device) for t in (zd, zn, a_src, a_dst)]


@pytest.mark.chip
@pytest.mark.parametrize("fanout", [10, 5])
def test_card_slopes_at_the_kink_are_the_eager_chains(fanout):
    """With every score at the kink, the kernels' gradients are the eager
    chain's on the card: one slot taking the other slope would move its row
    of dzn by 0.8 |de| |attn_dst|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inputs = _near_the_kink(8192, fanout, seed=fanout)
    zd, zn, a_src, a_dst = inputs
    s = (zd * a_src).sum(-1)[:, None] + (zn * a_dst).sum(-1)
    assert float((s.abs() < 1e-5).float().mean()) > 0.99
    assert 0.2 < float((s > 0).float().mean()) < 0.8
    g = torch.randn((zd.shape[0], HEADS * HEAD_DIM), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(29))
    out, grads = _kernel_run((*inputs, g))
    want_out, want = _eager_run((*inputs, g))
    assert torch.equal(out, want_out)
    for name, a, b in zip(("dzd", "dzn", "d_src", "d_dst"), grads, want):
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.chip
@pytest.mark.parametrize("fault", ["head_dim_64", "float64", "fanout_17",
                                   "non_contiguous_zn", "cpu_attn"])
def test_card_wrapper_refuses_what_the_kernels_do_not_take(layer0, fault):
    zd, zn, a_src, a_dst, _ = layer0[0]
    if fault == "head_dim_64":
        zd, zn = zd.reshape(-1, 2, 64), zn.reshape(*zn.shape[:2], 2, 64)
        a_src, a_dst = a_src.reshape(2, 64), a_dst.reshape(2, 64)
    elif fault == "float64":
        zd, zn, a_src, a_dst = (t.double() for t in (zd, zn, a_src, a_dst))
    elif fault == "fanout_17":
        zn = torch.zeros((zd.shape[0], 17, HEADS, HEAD_DIM), device="cuda")
    elif fault == "non_contiguous_zn":
        zn = zn.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        a_src = a_src.cpu()
    with pytest.raises(ValueError):
        gat_attend(zd, zn, a_src, a_dst)


@pytest.mark.chip
def test_card_sgd_step_launches_once_per_layer_level():
    """One GAT step at fanouts (10, 5, 5): layer 0 attends over three
    levels, layer 1 over two, layer 2 over one, each forward and backward;
    the step's loss and parameters are the eager chain's to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fanouts, batch, in_dim = (10, 5, 5), 64, 256
    gen = torch.Generator("cuda").manual_seed(7)
    sizes = [batch]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    feats = torch.randn((3000, in_dim), generator=gen, device="cuda")
    hop_idx = [torch.randint(0, 3000, (s,), generator=gen, device="cuda",
                             dtype=torch.int32) for s in sizes]
    labels = torch.randint(0, 7, (batch,), generator=gen, device="cuda")
    model, eager = (_gat(fanouts, in_dim, device="cuda") for _ in range(2))
    _build.reset_launches()
    loss = sgd_step(model, feats, hop_idx, labels, 0.05)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gat_attend_fwd"] == 6
    assert _build.LAUNCHES["gat_attend_bwd"] == 6
    from repro_torch.models import gnn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gnn, "gat_attend", attend_ref)
        want = sgd_step(eager, feats, hop_idx, labels, 0.05)
    assert torch.equal(loss, want)
    for (name, a), b in zip(model.named_parameters(), eager.parameters()):
        assert torch.equal(a, b), name
