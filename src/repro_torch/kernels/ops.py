"""Entry points of the port's kernels, dispatched on the tensors' device.

CPU tensors take the plain PyTorch version in `ref`; CUDA tensors take the
hand-written kernel, which raises on what it does not accept.  There is no
switch between the two and no fallback: the device decides.  Counterpart
of `repro.kernels.ops` (`flash_attention` waits for the LM slice,
ROADMAP.md Queue 2).
"""
from __future__ import annotations

import torch

from . import ref
from . import segment_mean as _segment_mean
from . import tiered_gather as _tiered_gather


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def tiered_gather(slots: torch.Tensor, cache: torch.Tensor,
                  staged: torch.Tensor) -> torch.Tensor:
    if _on_cpu(slots, cache, staged):
        return ref.tiered_gather_ref(slots, cache, staged)
    return _tiered_gather.tiered_gather(slots, cache, staged)


def tiered_gather_unique(slots: torch.Tensor, cache: torch.Tensor,
                         staged: torch.Tensor,
                         inverse: torch.Tensor) -> torch.Tensor:
    """Gather over a merged window's U unique rows, expanded to one batch's
    N rows: `slots`/`staged` cover the unique rows, `inverse` (N,) int32
    maps each output row to its unique row (the merged-window executor,
    `core.device_store.device_gather_merged`)."""
    if _on_cpu(slots, cache, staged, inverse):
        return ref.tiered_gather_unique_ref(slots, cache, staged, inverse)
    return _tiered_gather.tiered_gather_unique(slots, cache, staged, inverse)


def tiered_frontier_gather(page_slots: torch.Tensor, hot: torch.Tensor,
                           staged: torch.Tensor, inverse: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """One sampling hop's adjacency words: read n is word offsets[n] of
    unique page inverse[n], served from the hot pages or its staged page
    (`core.topology.TieredTopologyStore.frontier_gather`)."""
    if _on_cpu(page_slots, hot, staged, inverse, offsets):
        return ref.frontier_gather_ref(page_slots, hot, staged, inverse,
                                       offsets)
    return _tiered_gather.frontier_gather(page_slots, hot, staged, inverse,
                                          offsets)


def segment_mean(idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    if _on_cpu(idx, feats):
        return ref.segment_mean_ref(idx, feats)
    return _segment_mean.segment_mean(idx, feats)


def store_fill(rows: torch.Tensor, last_filler: torch.Tensor,
               staged: torch.Tensor) -> None:
    """Write each line's last filler's staged row into the row store, in
    place (the row-store update of `core.device_store.device_gather`)."""
    if _on_cpu(rows, last_filler, staged):
        ref.store_fill_ref(rows, last_filler, staged)
    else:
        _tiered_gather.store_fill(rows, last_filler, staged)
