"""Gradient compression for the slow cross-pod axis, the port of
`repro.distributed.compression`.

    g_local  = all_reduce(g, axis="data")        # fast links, full precision
    q, scale = int8_quantize(g_local + error)    # error-feedback residual
    g_global = all_reduce_int8(q) * scale        # slow link, 4x fewer bytes
    error    = g_local - dequant(q)              # carried to the next step

Error feedback makes the quantization noise telescope: the sum of the
applied updates follows the sum of the true gradients (Karimireddy et al.,
2019).  The arithmetic is the reference's in f32 (round half to even, the
scale `max|x| / 127 + 1e-12`, every division a true one), so both
packages and both devices give the same bits.

Trees are nested dicts, lists and tuples of tensors.  `psum_compressed`
sums over a mesh axis with `torch.distributed.all_reduce` on the axis's
process group (int8 payload summed as int32, the scale shared by max);
`combine` is the same sum over the members' `(q, scale)` without a group.
"""
from __future__ import annotations

from typing import Any

import torch


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def _unzip(fn, grads, error) -> tuple[Any, Any]:
    """fn(g, e) -> (a, b) over the leaves, as the tree of a and of b."""
    outs: list = []
    _map(lambda g, e: outs.append(fn(g, e)), grads, error)
    firsts, seconds = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return (_map(lambda _: next(firsts), grads),
            _map(lambda _: next(seconds), grads))


def int8_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # 127 as a tensor on x's device: CUDA divides by a host scalar through
    # its f32 reciprocal, an ulp away from the quotient the CPU (and the
    # reference) computes for some maxima
    scale = x.abs().max() / x.new_full((), 127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _one(g: torch.Tensor, e: torch.Tensor):
    g32 = g.float() + e
    q, s = int8_quantize(g32)
    deq = int8_dequantize(q, s)
    return deq, g32 - deq


def compress_grads(grads: Any, error: Any) -> tuple[Any, Any]:
    """Quantize grads + error to int8; returns (dequantized, new_error).
    A pure function of its inputs, on their device."""
    return _unzip(_one, grads, error)


def init_error(params: Any) -> Any:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def combine(members: list[tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """The sum over an axis of its members' int8 payloads, as
    `psum_compressed` forms it: the q summed as int32, times the largest
    scale."""
    qsum = sum(q.to(torch.int32) for q, _ in members)
    smax = torch.stack([s for _, s in members]).max()
    return qsum.float() * smax


def psum_compressed(grads: Any, error: Any, mesh, axis: str = "pod"
                    ) -> tuple[Any, Any]:
    """Sum over mesh axis `axis` with an int8 payload and error feedback.

    grads enter already reduced over the fast axes; each leaf is quantized,
    summed over `axis` with an int32 accumulator and scaled by the axis's
    largest scale.  Without the axis, or where it has size 1, (grads, error)
    come back unchanged."""
    if axis not in mesh.shape or mesh.shape[axis] == 1:
        return grads, error
    import torch.distributed as dist
    group = mesh.device_mesh().get_group(axis)

    def body(g, e):
        g32 = g.float() + e
        q, s = int8_quantize(g32)
        qsum = q.to(torch.int32)
        smax = s.clone()
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        return qsum.float() * smax, g32 - int8_dequantize(q, s)

    return _unzip(body, grads, error)
