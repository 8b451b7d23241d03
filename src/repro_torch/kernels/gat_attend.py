"""GAT's attention over a destination's fixed fanout (csrc/gat_attend.cu),
forward and backward, as a `torch.autograd.Function`.

Given the destinations' projection `zd` (n, H, C) = x_dst W_self, their
slots' projection `zn` (n, f, H, C) = x_nbr W_nbr and the attention vectors
`attn_src`, `attn_dst` (H, C):

    s_tj = <zd[t], attn_src> + <zn[t, j], attn_dst>             per head
    alpha_tj = softmax over j of leaky_relu(s_tj, 0.2)
    out[t] = concat over heads of sum_j alpha_tj zn[t, j]       (n, H * C)

`gat_attend` gives CPU tensors `attend_ref`, the eager chain `GNN._layer`
ran before the kernels, differentiated by autograd, so the CPU's numbers
are that chain's.  CUDA tensors take the kernels, which read zd and zn in
place and raise on what they do not take (widths other than 4 heads of 32,
a fanout above 16, dtypes other than float32, tensors not contiguous);
there is no fallback.  On the card the kernels give the eager chain's
results to the bit, forward and backward (csrc/gat_attend.cu says how).
`attend_backward_ref` writes the kernels' backward formulas in plain
PyTorch; `GATAttend` given CPU tensors runs `attend_ref` forward and those
formulas backward, so the formulas can be checked against autograd on the
CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

#: the kernels' heads and head width (a 128-float row, a float4 a lane) and
#: the largest fanout they are instantiated for
HEADS, HEAD_DIM, MAX_FANOUT = 4, 32, 16
SLOPE = 0.2


def attend_ref(zd: torch.Tensor, zn: torch.Tensor, attn_src: torch.Tensor,
               attn_dst: torch.Tensor) -> torch.Tensor:
    """The forward in plain PyTorch, the eager chain: out (n, H * C)."""
    n, _, H, C = zn.shape
    es = (zd * attn_src).sum(-1)                       # (n, H)
    en = (zn * attn_dst).sum(-1)                       # (n, f, H)
    e = F.leaky_relu(es[:, None, :] + en, SLOPE)
    a = torch.softmax(e, dim=1)
    agg = (a[..., None] * zn).sum(dim=1)               # (n, H, C)
    return agg.reshape(n, H * C)


def attend_backward_ref(g: torch.Tensor, zd: torch.Tensor, zn: torch.Tensor,
                        attn_src: torch.Tensor, attn_dst: torch.Tensor
                        ) -> tuple[torch.Tensor, ...]:
    """The backward in plain PyTorch, as the kernels compute it: (dzd, dzn,
    d attn_src, d attn_dst) from the output's gradient `g` (n, H * C)."""
    n, _, H, C = zn.shape
    g = g.reshape(n, H, C)
    s = (zd * attn_src).sum(-1)[:, None, :] + (zn * attn_dst).sum(-1)
    alpha = torch.softmax(F.leaky_relu(s, SLOPE), dim=1)     # (n, f, H)
    p = (g[:, None] * zn).sum(-1) * alpha
    de = p - alpha * p.sum(1, keepdim=True)
    ds = torch.where(s > 0, de, de * SLOPE)
    dzn = alpha[..., None] * g[:, None] + ds[..., None] * attn_dst
    des = ds.sum(1)                                          # (n, H)
    return (des[..., None] * attn_src, dzn, (des[..., None] * zd).sum(0),
            (ds[..., None] * zn).sum((0, 1)))


def _check(zd, zn, attn_src, attn_dst) -> None:
    name = "gat_attend"
    _build.require_cuda(name, zd, zn, attn_src, attn_dst)
    width = (HEADS, HEAD_DIM)
    for what, t in (("zd", zd), ("zn", zn), ("attn_src", attn_src),
                    ("attn_dst", attn_dst)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if zd.dim() != 3 or zd.shape[1:] != width:
        raise ValueError(f"{name}: zd must be (n, {HEADS}, {HEAD_DIM}), got "
                         f"{tuple(zd.shape)}")
    n = zd.shape[0]
    if (zn.dim() != 4 or zn.shape[0] != n or zn.shape[2:] != width
            or not 1 <= zn.shape[1] <= MAX_FANOUT):
        raise ValueError(f"{name}: zn must be ({n}, f, {HEADS}, {HEAD_DIM}) "
                         f"with 1 <= f <= {MAX_FANOUT}, got {tuple(zn.shape)}")
    for what, t in (("attn_src", attn_src), ("attn_dst", attn_dst)):
        if t.shape != width:
            raise ValueError(f"{name}: {what} must be {width}, got "
                             f"{tuple(t.shape)}")


def _forward(zd, zn, attn_src, attn_dst):
    """(out (n, H * C), stats (n, 2, H): the softmax's max and sum)."""
    _check(zd, zn, attn_src, attn_dst)
    n, f = zn.shape[:2]
    out = torch.empty((n, HEADS * HEAD_DIM), dtype=zd.dtype, device=zd.device)
    stats = torch.empty((n, 2, HEADS), dtype=zd.dtype, device=zd.device)
    if n == 0:
        return out, stats
    P, I = _build.P, _build.I
    fn = _build.function("gat_attend", "gat_attend_fwd", (P,) * 6 + (I, I, P))
    _build.check(fn(zd.data_ptr(), zn.data_ptr(), attn_src.data_ptr(),
                    attn_dst.data_ptr(), out.data_ptr(), stats.data_ptr(), n,
                    f, _build.stream(zd)), "gat_attend_fwd")
    _build.LAUNCHES["gat_attend_fwd"] += 1
    return out, stats


def _backward(g, zd, zn, attn_src, attn_dst, stats):
    """(dzd, dzn, d attn_src, d attn_dst).  The kernel writes dzd, dzn and
    the products des * zd and ds * zn of the scores' gradients, the tensors
    autograd sums into the attention vectors' gradients for the eager
    chain; they are summed here by the same torch reduction, so that those
    gradients have the eager chain's bits too."""
    n, f = zn.shape[:2]
    dzd, dzn, pd, pn = (torch.empty_like(t) for t in (zd, zn, zd, zn))
    if n:
        g = g.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
        P, I = _build.P, _build.I
        fn = _build.function("gat_attend", "gat_attend_bwd",
                             (P,) * 10 + (I, I, P))
        _build.check(fn(zd.data_ptr(), zn.data_ptr(), attn_src.data_ptr(),
                        attn_dst.data_ptr(), stats.data_ptr(), g.data_ptr(),
                        dzd.data_ptr(), dzn.data_ptr(), pd.data_ptr(),
                        pn.data_ptr(), n, f, _build.stream(zd)),
                     "gat_attend_bwd")
        _build.LAUNCHES["gat_attend_bwd"] += 1
    return dzd, dzn, pd.sum(0), pn.sum((0, 1))


class GATAttend(torch.autograd.Function):
    """out (n, H * C) and its gradient in zd, zn, attn_src and attn_dst."""

    @staticmethod
    def forward(ctx, zd, zn, attn_src, attn_dst):
        inputs = (zd, zn, attn_src, attn_dst)
        if all(t.device.type == "cpu" for t in inputs):
            out, stats = attend_ref(*inputs), None
        else:
            out, stats = _forward(*inputs)
        ctx.save_for_backward(*inputs, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, stats = ctx.saved_tensors
        if stats is None:
            return attend_backward_ref(g, *inputs)
        return _backward(g, *inputs, stats)


def gat_attend(zd: torch.Tensor, zn: torch.Tensor, attn_src: torch.Tensor,
               attn_dst: torch.Tensor) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (zd, zn, attn_src, attn_dst)):
        return attend_ref(zd, zn, attn_src, attn_dst)
    return GATAttend.apply(zd, zn, attn_src, attn_dst)
