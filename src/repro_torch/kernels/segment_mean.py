"""Launcher of the CUDA `segment_mean` kernel (csrc/segment_mean.cu).

Counterpart of the Pallas kernel in `repro.kernels.segment_mean`:
out[b] = mean_f feats[idx[b, f]], accumulated in f32 and cast to the
table's dtype.  Takes any D.  `idx` must hold rows of `feats`
(0 <= idx < N); the kernel does not check it.
"""
from __future__ import annotations

import torch

from . import _build

_FN = {torch.float32: "segment_mean_f32", torch.bfloat16: "segment_mean_bf16"}


def segment_mean(idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    _build.require_cuda("segment_mean", idx, feats)
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"segment_mean: idx must be (B, F) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if feats.dtype not in _FN or feats.dim() != 2:
        raise ValueError(f"segment_mean: feats must be (N, D) float32 or "
                         f"bfloat16, got {tuple(feats.shape)} {feats.dtype}")
    B, F = idx.shape
    D = feats.shape[1]
    out = torch.empty((B, D), dtype=feats.dtype, device=feats.device)
    if B == 0 or D == 0:
        return out
    fn = _build.function("segment_mean", _FN[feats.dtype],
                         (_build.P, _build.P, _build.P, _build.I, _build.I,
                          _build.I, _build.P))
    _build.check(fn(idx.data_ptr(), feats.data_ptr(), out.data_ptr(), B, F, D,
                    _build.stream(feats)), "segment_mean")
    _build.LAUNCHES["segment_mean"] += 1
    return out
