"""Plain PyTorch versions of the port's kernels: the CPU path of every
entry point in `ops`, and what `chip_smoke.py` holds each kernel against on
the card.  Counterpart of `repro.kernels.ref` plus the oracles inside
`repro.kernels.ops` (`attention_ref` waits for the LM slice)."""
from __future__ import annotations

import torch


def tiered_gather_ref(slots: torch.Tensor, cache: torch.Tensor,
                      staged: torch.Tensor) -> torch.Tensor:
    from_cache = cache[slots.clamp_min(0).long()]
    return torch.where((slots >= 0)[:, None], from_cache, staged)


def tiered_gather_unique_ref(slots: torch.Tensor, cache: torch.Tensor,
                             staged: torch.Tensor,
                             inverse: torch.Tensor) -> torch.Tensor:
    """The (N, D) expansion of a gather over U unique rows: row n is unique
    row inverse[n] of `tiered_gather_ref(slots, cache, staged)`."""
    return tiered_gather_ref(slots, cache, staged)[inverse.long()]


def frontier_gather_ref(page_slots: torch.Tensor, hot: torch.Tensor,
                        staged: torch.Tensor, inverse: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Word offsets[n] of page inverse[n], each page served from the hot
    pages (page_slots >= 0) or its staged row."""
    pages = tiered_gather_ref(page_slots, hot, staged)
    return pages[inverse.long(), offsets.long()]


def segment_mean_ref(idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    rows = feats[idx.long()]                      # (B, F, D)
    return rows.float().mean(dim=1).to(feats.dtype)


def store_fill_ref(rows: torch.Tensor, last_filler: torch.Tensor,
                   staged: torch.Tensor) -> None:
    """rows[l] = staged[last_filler[l]] wherever last_filler[l] >= 0, in
    place."""
    filled = last_filler >= 0
    rows[filled] = staged[last_filler[filled].long()]
