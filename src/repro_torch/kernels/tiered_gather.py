"""Launchers of the CUDA row- and word-copy kernels (csrc/tiered_gather.cu,
csrc/frontier_gather.cu), counterparts of `repro.kernels.tiered_gather`.

`tiered_gather`: out[i] = cache[slots[i]] if slots[i] >= 0 else staged[i],
bit-exact, any B and D, no padding copies.  `tiered_gather_unique`: the
same over U unique rows, expanded to N output rows by an (N,) inverse
without building the duplicated staged buffer.  `store_fill` writes the
rows a cache access filled into the row store (in place).  Each of the
three takes an optional `staged_map` (one int32 per request): the staged
buffer then holds only the rows read from it, compacted, and request r's
row is staged[staged_map[r]] (-1 where the row store serves r).
`frontier_gather`: one word per edge read, from its hot page or its staged
page, in the adjacency's int32 or int64 words.  `frontier_read`: one word
per raw edge position, from its hot page on the device or from the
adjacency in pinned host memory, read in place at the position through
its device mapping.  Slots, inverses, maps, offsets, positions, page tables and
fillers must index real rows; the kernels do not check them.
"""
from __future__ import annotations

import ctypes

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


def _check_index(name: str, what: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.int32 or t.shape != (n,):
        raise ValueError(f"{name}: {what} must be ({n},) int32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _staged_map(name: str, staged: torch.Tensor,
                staged_map: torch.Tensor | None, n: int) -> int:
    """Check the staged buffer against `n` requests: (n, D) without a map,
    else any number of rows with an (n,) int32 map on its device.  Returns
    the map's address, 0 (null) without one."""
    if staged_map is None:
        if staged.shape[0] != n:
            raise ValueError(f"{name}: staged must hold {n} rows without a "
                             f"staged_map, got {tuple(staged.shape)}")
        return 0
    _build.require_cuda(name, staged_map, staged)
    _check_index(name, "staged_map", staged_map, n)
    return staged_map.data_ptr()


def tiered_gather(slots: torch.Tensor, cache: torch.Tensor,
                  staged: torch.Tensor,
                  staged_map: torch.Tensor | None = None) -> torch.Tensor:
    name = "tiered_gather"
    _build.require_cuda(name, slots, cache, staged)
    _check_rows(name, cache=cache, staged=staged)
    B = slots.numel()
    _check_index(name, "slots", slots, B)
    map_ptr = _staged_map(name, staged, staged_map, B)
    out = torch.empty((B, staged.shape[1]), dtype=staged.dtype,
                      device=staged.device)
    row_bytes = staged.shape[1] * staged.element_size()
    if B == 0 or row_bytes == 0:
        return out
    fn = _build.function("tiered_gather", name,
                         (_build.P, _build.P, _build.P, _build.P, _build.P,
                          _build.LL, _build.LL, _build.P))
    _build.check(fn(slots.data_ptr(), cache.data_ptr(), staged.data_ptr(),
                    map_ptr, out.data_ptr(), B, row_bytes,
                    _build.stream(staged)), name)
    _build.LAUNCHES[name] += 1
    return out


def tiered_gather_unique(slots: torch.Tensor, cache: torch.Tensor,
                         staged: torch.Tensor, inverse: torch.Tensor,
                         staged_map: torch.Tensor | None = None
                         ) -> torch.Tensor:
    name = "tiered_gather_unique"
    _build.require_cuda(name, slots, cache, staged, inverse)
    _check_rows(name, cache=cache, staged=staged)
    U = slots.numel()
    _check_index(name, "slots", slots, U)
    map_ptr = _staged_map(name, staged, staged_map, U)
    N = inverse.numel()
    _check_index(name, "inverse", inverse, N)
    out = torch.empty((N, staged.shape[1]), dtype=staged.dtype,
                      device=staged.device)
    row_bytes = staged.shape[1] * staged.element_size()
    if N == 0 or row_bytes == 0:
        return out
    fn = _build.function("tiered_gather", name,
                         (_build.P, _build.P, _build.P, _build.P, _build.P,
                          _build.P, _build.LL, _build.LL, _build.P))
    _build.check(fn(slots.data_ptr(), inverse.data_ptr(), cache.data_ptr(),
                    staged.data_ptr(), map_ptr, out.data_ptr(), N, row_bytes,
                    _build.stream(staged)), name)
    _build.LAUNCHES[name] += 1
    return out


_WORDS = (torch.int32, torch.int64)


def frontier_gather(page_slots: torch.Tensor, hot: torch.Tensor,
                    staged: torch.Tensor, inverse: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    name = "frontier_gather"
    _build.require_cuda(name, page_slots, hot, staged, inverse, offsets)
    _check_rows(name, hot=hot, staged=staged)
    if hot.dtype not in _WORDS:
        raise ValueError(f"{name}: pages must be int32 or int64 words, got "
                         f"{hot.dtype}")
    _check_index(name, "page_slots", page_slots, staged.shape[0])
    N = inverse.numel()
    _check_index(name, "inverse", inverse, N)
    _check_index(name, "offsets", offsets, N)
    out = torch.empty((N,), dtype=hot.dtype, device=hot.device)
    if N == 0:
        return out
    fn = _build.function("frontier_gather", name,
                         (_build.P, _build.P, _build.P, _build.P, _build.P,
                          _build.P, _build.LL, _build.LL, _build.I,
                          _build.P))
    _build.check(fn(page_slots.data_ptr(), hot.data_ptr(), staged.data_ptr(),
                    inverse.data_ptr(), offsets.data_ptr(), out.data_ptr(), N,
                    hot.shape[1], hot.element_size(), _build.stream(hot)),
                 name)
    _build.LAUNCHES[name] += 1
    return out


def mapped_pointer(host: torch.Tensor) -> int:
    """The device address of a pinned host tensor, through which a kernel
    reads it in place over PCIe; raises if the card cannot address it
    (there is no staging fallback)."""
    if host.device.type != "cpu" or not host.is_contiguous() \
            or not host.is_pinned():
        raise ValueError("frontier_read: the host words must be a "
                         "contiguous pinned host tensor")
    ptr = ctypes.c_void_p()
    fn = _build.function("frontier_gather", "frontier_mapped_pointer",
                         (_build.P, ctypes.POINTER(ctypes.c_void_p)))
    err = fn(host.data_ptr(), ctypes.byref(ptr))
    if err != 0 or not ptr.value:
        raise RuntimeError(
            f"frontier_read: the pinned host words at {host.data_ptr():#x} "
            f"has no device mapping (CUDA error {err})")
    return ptr.value


def frontier_read(pos: torch.Tensor, page_table: torch.Tensor,
                  hot: torch.Tensor, words: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Words `pos` (N,) int64 of the paged adjacency: `page_table` (n_pages,)
    int32 and `hot` (H, W) on the card, the whole adjacency `words` (E,)
    pinned on the host; into `out` (N,) on the card where given."""
    name = "frontier_read"
    _build.require_cuda(name, pos, page_table, hot)
    if hot.dim() != 2 or hot.dtype not in _WORDS:
        raise ValueError(f"{name}: hot pages must be (H, W) int32 or int64 "
                         f"words, got {tuple(hot.shape)} {hot.dtype}")
    if words.dim() != 1 or words.dtype != hot.dtype:
        raise ValueError(f"{name}: host words {tuple(words.shape)} "
                         f"{words.dtype} are not (E,) {hot.dtype}")
    if pos.dtype != torch.int64 or pos.dim() != 1:
        raise ValueError(f"{name}: pos must be (N,) int64, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    _check_index(name, "page_table", page_table, page_table.numel())
    N = pos.numel()
    if out is None:
        out = torch.empty((N,), dtype=hot.dtype, device=hot.device)
    elif out.shape != (N,) or out.dtype != hot.dtype \
            or out.device != hot.device or not out.is_contiguous():
        raise ValueError(f"{name}: out must be ({N},) {hot.dtype} on "
                         f"{hot.device}, got {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}")
    if N == 0:
        return out
    words_dev = mapped_pointer(words)
    fn = _build.function("frontier_gather", name,
                         (_build.P, _build.P, _build.P, _build.P, _build.P,
                          _build.LL, _build.LL, _build.I, _build.P))
    _build.check(fn(pos.data_ptr(), page_table.data_ptr(), hot.data_ptr(),
                    words_dev, out.data_ptr(), N, hot.shape[1],
                    hot.element_size(), _build.stream(hot)), name)
    _build.LAUNCHES[name] += 1
    return out


def store_fill(rows: torch.Tensor, last_filler: torch.Tensor,
               staged: torch.Tensor,
               staged_map: torch.Tensor | None = None) -> None:
    """`staged_map`, where given, maps request indices (the fillers) to
    rows of the compacted `staged`; any length, as the fillers index it."""
    name = "store_fill"
    _build.require_cuda(name, rows, last_filler, staged)
    _check_rows(name, rows=rows, staged=staged)
    _check_index(name, "last_filler", last_filler, rows.shape[0])
    map_ptr = 0
    if staged_map is not None:
        map_ptr = _staged_map(name, staged, staged_map, staged_map.numel())
    L = rows.shape[0]
    row_bytes = rows.shape[1] * rows.element_size()
    if L == 0 or row_bytes == 0:
        return
    fn = _build.function("tiered_gather", name,
                         (_build.P, _build.P, _build.P, _build.P, _build.LL,
                          _build.LL, _build.P))
    _build.check(fn(last_filler.data_ptr(), staged.data_ptr(), map_ptr,
                    rows.data_ptr(), L, row_bytes, _build.stream(rows)),
                 name)
    _build.LAUNCHES["store_fill"] += 1
