"""Plain PyTorch versions of the port's kernels: the CPU path of every
entry point in `ops`, and what `chip_smoke.py` holds each kernel against on
the card.  Counterpart of `repro.kernels.ref` plus the oracles inside
`repro.kernels.ops`."""
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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None,
                  q_offset: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v in f32, cast to q's dtype.

    q (B, H, Sq, dh); k, v (B, KV, Sk, dh), q head h reading kv head
    h // (H / KV).  `q_offset` (B,) int32 places query i of sequence b at
    position q_offset[b] + i (default 0): the causal mask keeps k <= that
    position, a window w keeps k > position - w.  Fully masked rows give 0.
    """
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    scale = scale if scale is not None else dh ** -0.5
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[None, :]            # (1|B, Sq)
    if q_offset is not None:
        q_pos = q_pos + q_offset.to(q.device).long()[:, None]
    q_pos = q_pos[:, None, :, None]
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones_like(q_pos + k_pos, dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(p.isnan(), 0.0, p)               # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
