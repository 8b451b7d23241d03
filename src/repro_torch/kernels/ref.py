"""Plain PyTorch versions of the port's kernels: the CPU path of every
entry point in `ops`, and what `chip_smoke.py` holds each kernel against on
the card.  Counterpart of `repro.kernels.ref` (`attention_ref` waits for
the LM slice)."""
from __future__ import annotations

import torch


def tiered_gather_ref(slots: torch.Tensor, cache: torch.Tensor,
                      staged: torch.Tensor) -> torch.Tensor:
    from_cache = cache[slots.clamp_min(0).long()]
    return torch.where((slots >= 0)[:, None], from_cache, staged)


def segment_mean_ref(idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    rows = feats[idx.long()]                      # (B, F, D)
    return rows.float().mean(dim=1).to(feats.dtype)


def store_fill_ref(rows: torch.Tensor, last_filler: torch.Tensor,
                   staged: torch.Tensor) -> None:
    """rows[l] = staged[last_filler[l]] wherever last_filler[l] >= 0, in
    place."""
    filled = last_filler >= 0
    rows[filled] = staged[last_filler[filled].long()]
