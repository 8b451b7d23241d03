"""Launchers of the CUDA row-copy kernels (csrc/tiered_gather.cu).

`tiered_gather` is the counterpart of `repro.kernels.tiered_gather.
tiered_gather`: out[i] = cache[slots[i]] if slots[i] >= 0 else staged[i],
bit-exact, any B and D, no padding copies.  `store_fill` writes the rows a
cache access filled into the row store (in place).  Slots and fillers must
index real rows; the kernels do not check them.  `tiered_gather_unique`
and `frontier_gather` wait for later slices (ROADMAP.md Queue 2).
"""
from __future__ import annotations

import torch

from . import _build


def _check_rows(name: str, **tensors: torch.Tensor) -> None:
    dims = {k: t.shape[1] for k, t in tensors.items() if t.dim() == 2}
    dtypes = {t.dtype for t in tensors.values()}
    if len(dims) != len(tensors) or len(set(dims.values())) != 1 \
            or len(dtypes) != 1:
        raise ValueError(f"{name}: expected 2-D row tables of one width and "
                         f"dtype, got " + ", ".join(
                             f"{k} {tuple(t.shape)} {t.dtype}"
                             for k, t in tensors.items()))


def tiered_gather(slots: torch.Tensor, cache: torch.Tensor,
                  staged: torch.Tensor) -> torch.Tensor:
    _build.require_cuda("tiered_gather", slots, cache, staged)
    _check_rows("tiered_gather", cache=cache, staged=staged)
    if slots.dtype != torch.int32 or slots.shape != (staged.shape[0],):
        raise ValueError(f"tiered_gather: slots must be ({staged.shape[0]},) "
                         f"int32, got {tuple(slots.shape)} {slots.dtype}")
    out = torch.empty_like(staged)
    B = staged.shape[0]
    row_bytes = staged.shape[1] * staged.element_size()
    if B == 0 or row_bytes == 0:
        return out
    fn = _build.function("tiered_gather", "tiered_gather",
                         (_build.P, _build.P, _build.P, _build.P, _build.LL,
                          _build.LL, _build.P))
    _build.check(fn(slots.data_ptr(), cache.data_ptr(), staged.data_ptr(),
                    out.data_ptr(), B, row_bytes, _build.stream(staged)),
                 "tiered_gather")
    _build.LAUNCHES["tiered_gather"] += 1
    return out


def store_fill(rows: torch.Tensor, last_filler: torch.Tensor,
               staged: torch.Tensor) -> None:
    _build.require_cuda("store_fill", rows, last_filler, staged)
    _check_rows("store_fill", rows=rows, staged=staged)
    if last_filler.dtype != torch.int32 \
            or last_filler.shape != (rows.shape[0],):
        raise ValueError(f"store_fill: last_filler must be ({rows.shape[0]},)"
                         f" int32, got {tuple(last_filler.shape)} "
                         f"{last_filler.dtype}")
    L = rows.shape[0]
    row_bytes = rows.shape[1] * rows.element_size()
    if L == 0 or row_bytes == 0:
        return
    fn = _build.function("tiered_gather", "store_fill",
                         (_build.P, _build.P, _build.P, _build.LL, _build.LL,
                          _build.P))
    _build.check(fn(last_filler.data_ptr(), staged.data_ptr(),
                    rows.data_ptr(), L, row_bytes, _build.stream(rows)),
                 "store_fill")
    _build.LAUNCHES["store_fill"] += 1
