"""R-GAT's attention over one relation's block (csrc/relation_attend.cu),
forward and backward, as a `torch.autograd.Function`.

Given the projected source rows `z` (R, H, C), the attention vector
`a_src` (H, C), each destination's score `s_dst` (m, H) and its slots
`i_src` (m, f), indices into z, with their mask (m, f):

    e_vj = LeakyReLU_0.2(a_src . z[i_src[v, j]] + s_dst[v])    per head
    alpha_vj = softmax over v's unmasked slots
    out[v] = concat over heads of sum_j alpha_vj z[i_src[v, j]]    (m, H * C)

The caller computes s_dst = a_dst . (W x_v) per head as x_v . (W a_dst),
W folded into a_dst (`models/rgat.py`), so z holds only the rows the slots
name; `fold_scores` computes every relation's s_dst of a layer at once,
h[pos] @ ut^T with ut (relations * H, d) the folded rows, reading h by row
position.  The kernels read z and h by index and never build the
(m, f, H, C) gather, its gradient, or the destination level's rows.  CPU
tensors take the plain versions below (`attend_ref`,
`attend_backward_ref`, `fold_scores_ref`, `fold_scores_backward_ref`),
which compute the same formulas: an online softmax in slot order forward;
backward alpha = exp(e - lse), the flash-attention identity D_v = <g_v,
out_v> for the softmax, grad_z summed by source row and grad_s_dst = sum_j
de_vj.  CUDA tensors take the kernels, which raise on what they do not take
(C other than 128, indices other than int32, tensors not contiguous); there
is no fallback.  Every destination should have an unmasked slot; one
without gets zeros.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

#: the kernels' head width: one float4 a lane of a warp
HEAD_DIM = 128
SLOPE = 0.2
#: `fold_scores`' most columns (one a lane) and widest rows (8 warps of
#: HEAD_DIM floats)
MAX_COLUMNS, MAX_WIDTH = 32, 1024


def attend_ref(z: torch.Tensor, a_src: torch.Tensor, s_dst: torch.Tensor,
               i_src: torch.Tensor, mask: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward in plain PyTorch: (out (m, H * C), lse (m, H)), the
    softmax taken online over the slots in order, as the kernel does."""
    m, f = i_src.shape
    H, C = z.shape[1:]
    i_src = i_src.long()
    mx = z.new_full((m, H), float("-inf"))
    l = z.new_zeros((m, H))
    acc = z.new_zeros((m, H, C))
    for j in range(f):
        zu = z[i_src[:, j]]
        e = F.leaky_relu((zu * a_src).sum(-1) + s_dst, SLOPE)
        on = mask[:, j, None].expand(m, H)
        new = torch.where(on, torch.maximum(mx, e), mx)
        c = torch.where(on, torch.exp(mx - new), 1.0)
        p = torch.where(on, torch.exp(e - new), 0.0)
        l = l * c + p
        acc = acc * c[..., None] + p[..., None] * zu
        mx = new
    has = l > 0
    out = torch.where(has[..., None], acc / l[..., None], 0.0)
    lse = torch.where(has, mx + torch.log(l), float("-inf"))
    return out.reshape(m, H * C), lse


def attend_backward_ref(g: torch.Tensor, z: torch.Tensor,
                        a_src: torch.Tensor, s_dst: torch.Tensor,
                        i_src: torch.Tensor, mask: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch: (grad_z, grad_a_src, grad_s_dst) from
    the output's gradient `g` (m, H * C) and the forward's `out`, `lse`."""
    m, f = i_src.shape
    H, C = z.shape[1:]
    i_src = i_src.long()
    g = g.reshape(m, H, C)
    D = (g * out.reshape(m, H, C)).sum(-1)      # sum_j alpha_vj <g_v, z_u>
    grad_z = torch.zeros_like(z)
    grad_a_src = torch.zeros_like(a_src)
    sum_de = z.new_zeros((m, H))
    for j in range(f):
        on = mask[:, j]
        u = i_src[on, j]
        zu = z[u]
        x = (zu * a_src).sum(-1) + s_dst[on]
        alpha = torch.exp(F.leaky_relu(x, SLOPE) - lse[on])
        ds = alpha * ((g[on] * zu).sum(-1) - D[on])
        de = torch.where(x > 0, ds, ds * SLOPE)
        sum_de[on] += de
        grad_a_src += (de[..., None] * zu).sum(0)
        grad_z.index_add_(0, u, alpha[..., None] * g[on]
                          + de[..., None] * a_src)
    return grad_z, grad_a_src, sum_de


def _check(z, a_src, s_dst, i_src, mask) -> None:
    name = "relation_attend"
    _build.require_cuda(name, z, a_src, s_dst, i_src, mask)
    if z.dim() != 3 or z.dtype != torch.float32 or z.shape[2] != HEAD_DIM:
        raise ValueError(f"{name}: z must be (R, H, {HEAD_DIM}) float32, "
                         f"got {tuple(z.shape)} {z.dtype}")
    H = z.shape[1]
    if a_src.shape != (H, HEAD_DIM) or a_src.dtype != torch.float32:
        raise ValueError(f"{name}: a_src must be ({H}, {HEAD_DIM}) float32, "
                         f"got {tuple(a_src.shape)} {a_src.dtype}")
    if i_src.dim() != 2 or i_src.dtype != torch.int32:
        raise ValueError(f"{name}: i_src must be (m, f) int32, got "
                         f"{tuple(i_src.shape)} {i_src.dtype}")
    m = i_src.shape[0]
    if s_dst.shape != (m, H) or s_dst.dtype != torch.float32:
        raise ValueError(f"{name}: s_dst must be ({m}, {H}) float32, got "
                         f"{tuple(s_dst.shape)} {s_dst.dtype}")
    if mask.shape != i_src.shape or mask.dtype != torch.bool:
        raise ValueError(f"{name}: mask must be {tuple(i_src.shape)} bool, "
                         f"got {tuple(mask.shape)} {mask.dtype}")
    for what, t in (("z", z), ("a_src", a_src)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def _forward(z, a_src, s_dst, i_src, mask):
    """The forward kernel: (out, lse, key), key (m * f,) int32 each slot's
    source row (R where masked)."""
    _check(z, a_src, s_dst, i_src, mask)
    R, H, C = z.shape
    m, f = i_src.shape
    out = torch.empty((m, H * C), dtype=z.dtype, device=z.device)
    lse = torch.empty((m, H), dtype=z.dtype, device=z.device)
    key = torch.empty(m * f, dtype=torch.int32, device=z.device)
    if m == 0:
        return out, lse, key
    P, I = _build.P, _build.I
    fn = _build.function("relation_attend", "relation_attend_fwd",
                         (P,) * 8 + (I,) * 4 + (P,))
    _build.check(fn(z.data_ptr(), a_src.data_ptr(), s_dst.data_ptr(),
                    i_src.data_ptr(), mask.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), key.data_ptr(), m, f, H, R,
                    _build.stream(z)), "relation_attend_fwd")
    _build.LAUNCHES["relation_attend_fwd"] += 1
    return out, lse, key


def _backward(g, z, a_src, s_dst, i_src, mask, out, lse, key):
    """The two backward kernels, after a stable sort of the forward's keys
    that lists each row's slots."""
    R, H, C = z.shape
    m, f = i_src.shape
    grad_z = torch.empty_like(z)
    grad_a_src = torch.empty_like(a_src)
    grad_s_dst = torch.empty_like(s_dst)
    if m == 0:
        return grad_z.zero_(), grad_a_src.zero_(), grad_s_dst
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    skey, order = torch.sort(key, stable=True)
    P, I = _build.P, _build.I
    blocks = _build.function("relation_attend", "relation_attend_bwd_blocks",
                             (I, I))(m, H)
    dev = z.device
    off = torch.empty(R + 1, dtype=torch.int32, device=dev)
    alpha = torch.empty((m, f, H), dtype=z.dtype, device=dev)
    de = torch.empty_like(alpha)
    partial = torch.empty((blocks, H, C), dtype=z.dtype, device=dev)
    fn = _build.function("relation_attend", "relation_attend_bwd",
                         (P,) * 14 + (I,) + (P,) * 3 + (I,) * 4 + (P,))
    _build.check(fn(z.data_ptr(), a_src.data_ptr(), s_dst.data_ptr(),
                    i_src.data_ptr(), mask.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), g.data_ptr(), skey.data_ptr(),
                    order.data_ptr(), off.data_ptr(), alpha.data_ptr(),
                    de.data_ptr(), partial.data_ptr(), blocks,
                    grad_z.data_ptr(), grad_a_src.data_ptr(),
                    grad_s_dst.data_ptr(), m, f, H, R, _build.stream(z)),
                 "relation_attend_bwd")
    _build.LAUNCHES["relation_attend_bwd"] += 1
    return grad_z, grad_a_src, grad_s_dst


class RelationAttend(torch.autograd.Function):
    """out (m, H * C) and its gradient in z, a_src and s_dst; the indices
    and the mask take none."""

    @staticmethod
    def forward(ctx, z, a_src, s_dst, i_src, mask):
        inputs = (z, a_src, s_dst, i_src, mask)
        if all(t.device.type == "cpu" for t in inputs):
            out, lse = attend_ref(*inputs)
            key = None
        else:
            out, lse, key = _forward(*inputs)
        ctx.save_for_backward(*inputs, out, lse, key)
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, out, lse, key = ctx.saved_tensors
        if key is None:
            grads = attend_backward_ref(g, *inputs, out, lse)
        else:
            grads = _backward(g, *inputs, out, lse, key)
        return (*grads, None, None)


def relation_attend(z: torch.Tensor, a_src: torch.Tensor,
                    s_dst: torch.Tensor, i_src: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    return RelationAttend.apply(z, a_src, s_dst, i_src, mask)


def fold_scores_ref(h: torch.Tensor, pos: torch.Tensor,
                    ut: torch.Tensor) -> torch.Tensor:
    """The destinations' scores in plain PyTorch: h[pos] @ ut^T, (n, J)."""
    return h[pos] @ ut.t()


def fold_scores_backward_ref(g: torch.Tensor, h: torch.Tensor,
                             pos: torch.Tensor, ut: torch.Tensor,
                             needs_h: bool
                             ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(grad_h, or None where `needs_h` is false, and grad_ut) from the
    scores' gradient `g` (n, J)."""
    grad_ut = g.t() @ h[pos]
    if not needs_h:
        return None, grad_ut
    return torch.zeros_like(h).index_add_(0, pos, g @ ut), grad_ut


def _check_scores(h, pos, ut) -> None:
    name = "fold_scores"
    _build.require_cuda(name, h, pos, ut)
    if (h.dim() != 2 or h.dtype != torch.float32 or h.shape[1] % HEAD_DIM
            or not 0 < h.shape[1] <= MAX_WIDTH):
        raise ValueError(f"{name}: h must be (rows, d) float32 with d a "
                         f"multiple of {HEAD_DIM} up to {MAX_WIDTH}, got "
                         f"{tuple(h.shape)} {h.dtype}")
    if pos.dim() != 1 or pos.dtype != torch.int64:
        raise ValueError(f"{name}: pos must be (n,) int64, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if (ut.dim() != 2 or ut.dtype != torch.float32
            or ut.shape[1] != h.shape[1]
            or not 0 < ut.shape[0] <= MAX_COLUMNS):
        raise ValueError(f"{name}: ut must be (J, {h.shape[1]}) float32 with "
                         f"J up to {MAX_COLUMNS}, got {tuple(ut.shape)} "
                         f"{ut.dtype}")
    for what, t in (("h", h), ("ut", ut)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def _scores_blocks(n: int, d: int) -> int:
    return _build.function("relation_attend", "fold_scores_blocks",
                           (_build.LL, _build.I))(n, d)


def _scores_forward(h, pos, ut):
    _check_scores(h, pos, ut)
    n, (J, d) = len(pos), ut.shape
    s = torch.empty((n, J), dtype=h.dtype, device=h.device)
    if n == 0:
        return s
    P, I, LL = _build.P, _build.I, _build.LL
    fn = _build.function("relation_attend", "fold_scores_fwd",
                         (P,) * 4 + (LL,) + (I,) * 3 + (P,))
    _build.check(fn(h.data_ptr(), pos.data_ptr(), ut.data_ptr(), s.data_ptr(),
                    n, d, J, _scores_blocks(n, d), _build.stream(h)),
                 "fold_scores_fwd")
    _build.LAUNCHES["fold_scores_fwd"] += 1
    return s


def _scores_backward(g, h, pos, ut, needs_h):
    """grad_ut through one (J, d) partial a block, summed in block order,
    and grad_h's rows `pos` (the rest zero) where `needs_h`."""
    n, (J, d) = len(pos), ut.shape
    grad_h = torch.zeros_like(h) if needs_h else None
    if n == 0:
        return grad_h, torch.zeros_like(ut)
    g = g.contiguous()
    blocks = _scores_blocks(n, d)
    partial = torch.empty((blocks, J, d), dtype=h.dtype, device=h.device)
    grad_ut = torch.empty_like(ut)
    P, I, LL = _build.P, _build.I, _build.LL
    fn = _build.function("relation_attend", "fold_scores_bwd",
                         (P,) * 7 + (LL,) + (I,) * 3 + (P,))
    _build.check(fn(h.data_ptr(), pos.data_ptr(), ut.data_ptr(), g.data_ptr(),
                    partial.data_ptr(), grad_ut.data_ptr(),
                    grad_h.data_ptr() if needs_h else None, n, d, J, blocks,
                    _build.stream(h)), "fold_scores_bwd")
    _build.LAUNCHES["fold_scores_bwd"] += 1
    return grad_h, grad_ut


class FoldScores(torch.autograd.Function):
    """h[pos] @ ut^T (n, J) and its gradient in h and ut; pos takes none.
    `pos` names distinct rows of h."""

    @staticmethod
    def forward(ctx, h, pos, ut):
        ctx.save_for_backward(h, pos, ut)
        if all(t.device.type == "cpu" for t in (h, pos, ut)):
            return fold_scores_ref(h, pos, ut)
        return _scores_forward(h, pos, ut)

    @staticmethod
    def backward(ctx, g):
        h, pos, ut = ctx.saved_tensors
        needs_h = ctx.needs_input_grad[0]
        if h.device.type == "cpu":
            grad_h, grad_ut = fold_scores_backward_ref(g, h, pos, ut, needs_h)
        else:
            grad_h, grad_ut = _scores_backward(g, h, pos, ut, needs_h)
        return grad_h, None, grad_ut


def fold_scores(h: torch.Tensor, pos: torch.Tensor,
                ut: torch.Tensor) -> torch.Tensor:
    return FoldScores.apply(h, pos, ut)
