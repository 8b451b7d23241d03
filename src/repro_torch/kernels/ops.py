"""Entry points of the port's kernels, dispatched on the tensors' device.

CPU tensors take the plain PyTorch version in `ref`; CUDA tensors take the
hand-written kernel, which raises on what it does not accept.  There is no
switch between the two and no fallback: the device decides.  Counterpart
of `repro.kernels.ops`.
"""
from __future__ import annotations

import torch

from . import flash_attention as _flash_attention
from . import ref
from . import segment_mean as _segment_mean
from . import tiered_gather as _tiered_gather


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True on the CPU, False on the card; a meta tensor has no values for
    a kernel to read, so it raises instead of reaching a launch."""
    if any(t.device.type == "meta" for t in tensors):
        raise ValueError("a meta tensor reached a kernel of the port; the "
                         "dry-run runs attention as attn_impl 'einsum' or "
                         "'flash_stub'")
    return all(t.device.type == "cpu" for t in tensors)


def _maybe(t: torch.Tensor | None) -> tuple[torch.Tensor, ...]:
    return () if t is None else (t,)


def tiered_gather(slots: torch.Tensor, cache: torch.Tensor,
                  staged: torch.Tensor,
                  staged_map: torch.Tensor | None = None) -> torch.Tensor:
    """Each request's row from the row store (slots >= 0) or staged: with
    `staged_map` (B,) int32 the staged buffer holds only the rows read
    from it, request i's at staged_map[i]."""
    if _on_cpu(slots, cache, staged, *_maybe(staged_map)):
        return ref.tiered_gather_ref(slots, cache, staged, staged_map)
    return _tiered_gather.tiered_gather(slots, cache, staged, staged_map)


def tiered_gather_unique(slots: torch.Tensor, cache: torch.Tensor,
                         staged: torch.Tensor, inverse: torch.Tensor,
                         staged_map: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Gather over a merged window's U unique rows, expanded to one batch's
    N rows: `slots`/`staged` cover the unique rows, `inverse` (N,) int32
    maps each output row to its unique row (the merged-window executor,
    `core.device_store.device_gather_merged`); `staged_map` (U,) as in
    `tiered_gather`."""
    tensors = (slots, cache, staged, inverse, *_maybe(staged_map))
    if _on_cpu(*tensors):
        return ref.tiered_gather_unique_ref(slots, cache, staged, inverse,
                                            staged_map)
    return _tiered_gather.tiered_gather_unique(slots, cache, staged, inverse,
                                               staged_map)


def tiered_frontier_gather(page_slots: torch.Tensor, hot: torch.Tensor,
                           staged: torch.Tensor, inverse: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """One sampling hop's adjacency words: read n is word offsets[n] of
    unique page inverse[n], served from the hot pages or its staged page.
    The JAX package's contract; the topology store reads through
    `frontier_read` instead."""
    if _on_cpu(page_slots, hot, staged, inverse, offsets):
        return ref.frontier_gather_ref(page_slots, hot, staged, inverse,
                                       offsets)
    return _tiered_gather.frontier_gather(page_slots, hot, staged, inverse,
                                          offsets)


def frontier_read(pos: torch.Tensor, page_table: torch.Tensor,
                  hot: torch.Tensor, words: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The adjacency words at edge positions `pos` (N,) int64 of a paged
    store: `page_table` maps each page to a hot row (>= 0) or to none (-1),
    and a word off the hot pages is read from the whole adjacency `words`
    (E,) at its position.  On CUDA, `pos`, `page_table`, `hot` and `out`
    lie on the card and `words` in pinned host memory, read in place; the
    result lands in `out` where given
    (`core.topology.TieredTopologyStore.frontier_gather`)."""
    if _on_cpu(pos, page_table, hot, words):
        got = ref.frontier_read_ref(pos, page_table, hot, words)
        return got if out is None else out.copy_(got)
    return _tiered_gather.frontier_read(pos, page_table, hot, words, out)


def segment_mean(idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    if _on_cpu(idx, feats):
        return ref.segment_mean_ref(idx, feats)
    return _segment_mean.segment_mean(idx, feats)


def store_fill(rows: torch.Tensor, last_filler: torch.Tensor,
               staged: torch.Tensor,
               staged_map: torch.Tensor | None = None) -> None:
    """Write each line's last filler's staged row into the row store, in
    place (the row-store update of `core.device_store.device_gather`);
    `staged_map` as in `tiered_gather`."""
    if _on_cpu(rows, last_filler, staged, *_maybe(staged_map)):
        ref.store_fill_ref(rows, last_filler, staged, staged_map)
    else:
        _tiered_gather.store_fill(rows, last_filler, staged, staged_map)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of q (B, H, Sq, hd) over k, v (B, KV, Sk, hd); query i of
    sequence b sits at position q_offset[b] + i (0 + i without it), which
    the causal and window masks count from.

    Forward only, on both devices: neither package defines a backward for
    the kernel, so a call that autograd would record raises instead of
    returning an output with no graph behind it (and the CPU's plain
    version must not train a model the card cannot)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only: neither the JAX package nor "
            "the port defines a backward for the kernel; train with "
            "attn_impl='einsum', or call it under torch.no_grad() or "
            "torch.inference_mode()")
    tensors = (q, k, v) + ((q_offset,) if q_offset is not None else ())
    if _on_cpu(*tensors):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return _flash_attention.flash_attention(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset)
