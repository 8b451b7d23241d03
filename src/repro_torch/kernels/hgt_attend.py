"""HGT's attention over every relation into a destination at once
(csrc/hgt_attend.cu), forward and backward, as a `torch.autograd.Function`.

Given the destinations' queries `q` (n, H, D), the relation-transformed
source rows `k` and `v` (R, H, D) (k' = K W_att, v' = V W_msg, with the
relation's prior mu / sqrt(D) folded into k'), and each destination's slots
as a CSR, `indptr` (n + 1,) over `idx` (S,), rows of k and v:

    e_ts = q_t . k[idx[s]]                                     per head
    alpha_ts = softmax over t's slots s in [indptr[t], indptr[t + 1])
    out[t] = concat over heads of sum_s alpha_ts v[idx[s]]      (n, H * D)

A destination's slots come from every relation into its type, so the
softmax is taken across relations (HGT's Eq. 3), not within each.  The
kernels read k and v by index and never build the (S, H, D) gathers or
their gradients.  CPU tensors take the plain versions below (`attend_ref`,
`attend_backward_ref`), which compute the same formulas: the softmax by a
scatter max and sum; backward alpha = exp(e - lse), the flash-attention
identity D_t = <g_t, out_t>, dq summed by destination, dk and dv by row.
CUDA tensors take the kernels, which raise on what they do not take (widths
other than 8 heads of 32, indices other than int32, tensors not contiguous);
there is no fallback.  A destination with no slot gets zeros.
"""
from __future__ import annotations

import torch

from . import _build

#: the kernels' heads and head width: a 256-float row, 8 floats a lane
HEADS, HEAD_DIM = 8, 32


def _slot_dst(indptr: torch.Tensor) -> torch.Tensor:
    """Each slot's destination, (S,) int64."""
    n = len(indptr) - 1
    return torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                   (indptr[1:] - indptr[:-1]).long())


def attend_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               indptr: torch.Tensor, idx: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward in plain PyTorch: (out (n, H * D), lse (n, H))."""
    n, H, D = q.shape
    dst, idx = _slot_dst(indptr), idx.long()
    e = (q[dst] * k[idx]).sum(-1)                               # (S, H)
    mx = torch.full((n, H), float("-inf"), dtype=q.dtype, device=q.device)
    mx = mx.scatter_reduce(0, dst[:, None].expand(-1, H), e, "amax")
    p = torch.exp(e - mx[dst])
    l = q.new_zeros((n, H)).index_add_(0, dst, p)
    acc = q.new_zeros((n, H, D)).index_add_(0, dst, p[..., None] * v[idx])
    has = l > 0
    out = acc / torch.where(has, l, 1.0)[..., None]
    lse = torch.where(has, mx + torch.log(torch.where(has, l, 1.0)),
                      float("-inf"))
    return out.reshape(n, H * D), lse


def attend_backward_ref(g: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, indptr: torch.Tensor,
                        idx: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch: (dq, dk, dv) from the output's
    gradient `g` (n, H * D) and the forward's `out`, `lse`."""
    n, H, D = q.shape
    dst, idx = _slot_dst(indptr), idx.long()
    g = g.reshape(n, H, D)
    Dt = (g * out.reshape(n, H, D)).sum(-1)          # sum_s alpha <g_t, v_s>
    ks, vs = k[idx], v[idx]
    alpha = torch.exp((q[dst] * ks).sum(-1) - lse[dst])
    ds = alpha * ((g[dst] * vs).sum(-1) - Dt[dst])
    dq = torch.zeros_like(q).index_add_(0, dst, ds[..., None] * ks)
    dk = torch.zeros_like(k).index_add_(0, idx, ds[..., None] * q[dst])
    dv = torch.zeros_like(v).index_add_(0, idx, alpha[..., None] * g[dst])
    return dq, dk, dv


def _check(q, k, v, indptr, idx) -> None:
    name = "hgt_attend"
    _build.require_cuda(name, q, k, v, indptr, idx)
    width = (HEADS, HEAD_DIM)
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or t.dtype != torch.float32 or t.shape[1:] != width:
            raise ValueError(f"{name}: {what} must be (rows, {HEADS}, "
                             f"{HEAD_DIM}) float32, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k and v must have one shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    n = q.shape[0]
    if indptr.shape != (n + 1,) or indptr.dtype != torch.int32:
        raise ValueError(f"{name}: indptr must be ({n + 1},) int32, got "
                         f"{tuple(indptr.shape)} {indptr.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be (S,) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")


def _forward(q, k, v, indptr, idx):
    _check(q, k, v, indptr, idx)
    n = q.shape[0]
    out = torch.empty((n, HEADS * HEAD_DIM), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, HEADS), dtype=q.dtype, device=q.device)
    if n == 0:
        return out, lse
    P, I = _build.P, _build.I
    fn = _build.function("hgt_attend", "hgt_attend_fwd", (P,) * 7 + (I, P))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    indptr.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), n, _build.stream(q)), "hgt_attend_fwd")
    _build.LAUNCHES["hgt_attend_fwd"] += 1
    return out, lse


def _backward(g, q, k, v, indptr, idx, out, lse):
    """Both backward passes, after a stable sort of the slots' rows that
    lists each row's slots."""
    n, R, S = q.shape[0], k.shape[0], idx.shape[0]
    dq = torch.empty_like(q)
    dk, dv = (torch.zeros_like(k), torch.zeros_like(v)) if S == 0 else (
        torch.empty_like(k), torch.empty_like(v))
    if n == 0:
        return dq, dk, dv
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    skey, order = torch.sort(idx, stable=True)
    dev = q.device
    off = torch.empty(R + 1, dtype=torch.int32, device=dev)
    alpha = torch.empty((S, HEADS), dtype=q.dtype, device=dev)
    ds = torch.empty_like(alpha)
    slot_dst = torch.empty(S, dtype=torch.int32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("hgt_attend", "hgt_attend_bwd",
                         (P,) * 17 + (I,) * 3 + (P,))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    indptr.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), g.data_ptr(), skey.data_ptr(),
                    order.data_ptr(), off.data_ptr(), alpha.data_ptr(),
                    ds.data_ptr(), slot_dst.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), n, S, R, _build.stream(q)),
                 "hgt_attend_bwd")
    _build.LAUNCHES["hgt_attend_bwd"] += 1
    return dq, dk, dv


class HGTAttend(torch.autograd.Function):
    """out (n, H * D) and its gradient in q, k and v; the CSR takes none."""

    @staticmethod
    def forward(ctx, q, k, v, indptr, idx):
        inputs = (q, k, v, indptr, idx)
        if all(t.device.type == "cpu" for t in inputs):
            out, lse = attend_ref(*inputs)
        else:
            out, lse = _forward(*inputs)
        ctx.save_for_backward(*inputs, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, out, lse = ctx.saved_tensors
        if inputs[0].device.type == "cpu":
            grads = attend_backward_ref(g, *inputs, out, lse)
        else:
            grads = _backward(g, *inputs, out, lse)
        return (*grads, None, None)


def hgt_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               indptr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return HGTAttend.apply(q, k, v, indptr, idx)
