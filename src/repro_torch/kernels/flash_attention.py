"""Launcher of the CUDA `flash_attention` kernel (csrc/flash_attention.cu).

Counterpart of the Pallas kernel in `repro.kernels.flash_attention`:
softmax(q k^T * scale + mask) v with an online softmax, q (B, H, Sq, hd),
k and v (B, KV, Sk, hd), GQA, causal / sliding-window / kv-padding masks,
f32 statistics, 0 for a fully masked row.  It also takes `q_offset` (B,)
int32, the position of each sequence's first query (0 without it), which
the reference kernel lacks; the plain version is `ref.attention_ref`.

q, k and v go in through element strides: only the head dim must be
contiguous, so the transposed view of a (B, S, KV, hd) KV cache is read in
place.  Rows must start on 16 bytes (base pointers and the batch, head and
sequence strides in whole 16-byte words), which every tensor the model
passes satisfies.  The output has q's layout.  f32 and bf16; hd in
HEAD_DIMS.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(t: torch.Tensor) -> bool:
    words = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % words == 0 for s in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    q_offset: torch.Tensor | None = None) -> torch.Tensor:
    name = "flash_attention"
    tensors = [q, k, v] + ([q_offset] if q_offset is not None else [])
    dev = q.device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{name}: expected CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q (B, H, Sq, hd) and k, v "
                         f"(B, KV, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (H must be a multiple of KV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(3) != 1 or not _aligned(t) for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v need a contiguous head dim and "
                         f"rows on 16-byte boundaries")
    if q_offset is not None and (q_offset.dtype != torch.int32
                                 or q_offset.shape != (B,)
                                 or not q_offset.is_contiguous()):
        raise ValueError(f"{name}: q_offset must be contiguous ({B},) int32, "
                         f"got {tuple(q_offset.shape)} {q_offset.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")
    out = torch.empty_like(q)           # q's strides when q is dense
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else hd ** -0.5
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.function(name, "flash_attention_fwd",
                         (_build.P, _build.P, _build.P, _build.P, _build.P,
                          _build.I, _build.I, _build.I, _build.I, _build.I,
                          _build.I, _build.I, _build.I, _build.I,
                          ctypes.c_float, _build.P, _build.P))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    q_offset.data_ptr() if q_offset is not None else None,
                    _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, int(causal),
                    int(window) if window is not None else 0, scale,
                    ctypes.cast(strides, ctypes.c_void_p),
                    _build.stream(q)), name)
    _build.LAUNCHES[name] += 1
    return out
