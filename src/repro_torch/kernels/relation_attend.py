"""R-GAT's attention over one relation's block (csrc/relation_attend.cu),
forward and backward, as a `torch.autograd.Function`.

Given the projected rows `z` (R, H, C), the attention vectors `a_src`,
`a_dst` (H, C), each destination's slots `i_src` (m, f) and mask (m, f)
and its own row `i_dst` (m,), all indices into z:

    e_vj = LeakyReLU_0.2(a_src . z[i_src[v, j]] + a_dst . z[i_dst[v]])  per head
    alpha_vj = softmax over v's unmasked slots
    out[v] = concat over heads of sum_j alpha_vj z[i_src[v, j]]    (m, H * C)

The kernels read z by index and never build the (m, f, H, C) gather or
its gradient.  CPU tensors take the plain versions below (`attend_ref`,
`attend_backward_ref`), which compute the same formulas: an online
softmax in slot order forward; backward alpha = exp(e - lse), the
flash-attention identity D_v = <g_v, out_v> for the softmax, and grad_z
summed by source row.  CUDA tensors take the kernels, which raise on what
they do not take (C other than 128, indices other than int32, tensors not
contiguous); there is no fallback.  Every destination should have an
unmasked slot; one without gets zeros.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

#: the kernels' head width: one float4 a lane of a warp
HEAD_DIM = 128
SLOPE = 0.2


def attend_ref(z: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
               i_src: torch.Tensor, i_dst: torch.Tensor, mask: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward in plain PyTorch: (out (m, H * C), lse (m, H)), the
    softmax taken online over the slots in order, as the kernel does."""
    m, f = i_src.shape
    H, C = z.shape[1:]
    i_src, i_dst = i_src.long(), i_dst.long()
    sd = (z[i_dst] * a_dst).sum(-1)                           # (m, H)
    mx = z.new_full((m, H), float("-inf"))
    l = z.new_zeros((m, H))
    acc = z.new_zeros((m, H, C))
    for j in range(f):
        zu = z[i_src[:, j]]
        e = F.leaky_relu((zu * a_src).sum(-1) + sd, SLOPE)
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
                        a_src: torch.Tensor, a_dst: torch.Tensor,
                        i_src: torch.Tensor, i_dst: torch.Tensor,
                        mask: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch: (grad_z, grad_a_src, grad_a_dst) from
    the output's gradient `g` (m, H * C) and the forward's `out`, `lse`."""
    m, f = i_src.shape
    H, C = z.shape[1:]
    i_src, i_dst = i_src.long(), i_dst.long()
    g = g.reshape(m, H, C)
    zv = z[i_dst]
    sd = (zv * a_dst).sum(-1)
    D = (g * out.reshape(m, H, C)).sum(-1)      # sum_j alpha_vj <g_v, z_u>
    grad_z = torch.zeros_like(z)
    grad_a_src = torch.zeros_like(a_src)
    sum_de = z.new_zeros((m, H))
    for j in range(f):
        on = mask[:, j]
        u = i_src[on, j]
        zu = z[u]
        x = (zu * a_src).sum(-1) + sd[on]
        alpha = torch.exp(F.leaky_relu(x, SLOPE) - lse[on])
        ds = alpha * ((g[on] * zu).sum(-1) - D[on])
        de = torch.where(x > 0, ds, ds * SLOPE)
        sum_de[on] += de
        grad_a_src += (de[..., None] * zu).sum(0)
        grad_z.index_add_(0, u, alpha[..., None] * g[on]
                          + de[..., None] * a_src)
    grad_z.index_add_(0, i_dst, sum_de[..., None] * a_dst)
    grad_a_dst = (sum_de[..., None] * zv).sum(0)
    return grad_z, grad_a_src, grad_a_dst


def _check(z, a_src, a_dst, i_src, i_dst, mask) -> None:
    name = "relation_attend"
    _build.require_cuda(name, z, a_src, a_dst, i_src, i_dst, mask)
    if z.dim() != 3 or z.dtype != torch.float32 or z.shape[2] != HEAD_DIM:
        raise ValueError(f"{name}: z must be (R, H, {HEAD_DIM}) float32, "
                         f"got {tuple(z.shape)} {z.dtype}")
    H = z.shape[1]
    for what, a in (("a_src", a_src), ("a_dst", a_dst)):
        if a.shape != (H, HEAD_DIM) or a.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be ({H}, {HEAD_DIM}) "
                             f"float32, got {tuple(a.shape)} {a.dtype}")
    if i_src.dim() != 2 or i_src.dtype != torch.int32:
        raise ValueError(f"{name}: i_src must be (m, f) int32, got "
                         f"{tuple(i_src.shape)} {i_src.dtype}")
    m = i_src.shape[0]
    if i_dst.shape != (m,) or i_dst.dtype != torch.int32:
        raise ValueError(f"{name}: i_dst must be ({m},) int32, got "
                         f"{tuple(i_dst.shape)} {i_dst.dtype}")
    if mask.shape != i_src.shape or mask.dtype != torch.bool:
        raise ValueError(f"{name}: mask must be {tuple(i_src.shape)} bool, "
                         f"got {tuple(mask.shape)} {mask.dtype}")
    for what, t in (("z", z), ("a_src", a_src), ("a_dst", a_dst)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def _forward(z, a_src, a_dst, i_src, i_dst, mask):
    """The forward kernel: (out, lse, key), key (m * f + m,) int32 each
    slot's source row (R where masked) and then each destination's row."""
    _check(z, a_src, a_dst, i_src, i_dst, mask)
    R, H, C = z.shape
    m, f = i_src.shape
    out = torch.empty((m, H * C), dtype=z.dtype, device=z.device)
    lse = torch.empty((m, H), dtype=z.dtype, device=z.device)
    key = torch.empty(m * f + m, dtype=torch.int32, device=z.device)
    if m == 0:
        return out, lse, key
    P, I = _build.P, _build.I
    fn = _build.function("relation_attend", "relation_attend_fwd",
                         (P,) * 9 + (I,) * 4 + (P,))
    _build.check(fn(z.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
                    i_src.data_ptr(), i_dst.data_ptr(), mask.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), key.data_ptr(), m, f, H, R,
                    _build.stream(z)), "relation_attend_fwd")
    _build.LAUNCHES["relation_attend_fwd"] += 1
    return out, lse, key


def _backward(g, z, a_src, a_dst, i_src, i_dst, mask, out, lse, key):
    """The two backward kernels, after a stable sort of the forward's keys
    that lists each row's slots, then its destination entry."""
    R, H, C = z.shape
    m, f = i_src.shape
    grad_z = torch.empty_like(z)
    grad_a_src = torch.empty_like(a_src)
    grad_a_dst = torch.empty_like(a_dst)
    if m == 0:
        return grad_z.zero_(), grad_a_src.zero_(), grad_a_dst.zero_()
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
    sum_de = torch.empty((m, H), dtype=z.dtype, device=dev)
    partial = torch.empty((blocks, 2, H, C), dtype=z.dtype, device=dev)
    fn = _build.function("relation_attend", "relation_attend_bwd",
                         (P,) * 16 + (I,) + (P,) * 3 + (I,) * 4 + (P,))
    _build.check(fn(z.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
                    i_src.data_ptr(), i_dst.data_ptr(), mask.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), g.data_ptr(),
                    skey.data_ptr(), order.data_ptr(), off.data_ptr(),
                    alpha.data_ptr(), de.data_ptr(), sum_de.data_ptr(),
                    partial.data_ptr(), blocks, grad_z.data_ptr(),
                    grad_a_src.data_ptr(), grad_a_dst.data_ptr(), m, f, H, R,
                    _build.stream(z)), "relation_attend_bwd")
    _build.LAUNCHES["relation_attend_bwd"] += 1
    return grad_z, grad_a_src, grad_a_dst


class RelationAttend(torch.autograd.Function):
    """out (m, H * C) and its gradient in z, a_src and a_dst; the indices
    and the mask take none."""

    @staticmethod
    def forward(ctx, z, a_src, a_dst, i_src, i_dst, mask):
        inputs = (z, a_src, a_dst, i_src, i_dst, mask)
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
        return (*grads, None, None, None)


def relation_attend(z: torch.Tensor, a_src: torch.Tensor,
                    a_dst: torch.Tensor, i_src: torch.Tensor,
                    i_dst: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return RelationAttend.apply(z, a_src, a_dst, i_src, i_dst, mask)
