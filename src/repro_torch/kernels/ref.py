"""Plain PyTorch versions of the port's kernels: the CPU path of every
entry point in `ops`, and what `chip_smoke.py` holds each kernel against on
the card.  Counterpart of `repro.kernels.ref` plus the oracles inside
`repro.kernels.ops`."""
from __future__ import annotations

import torch


def _staged_rows(staged: torch.Tensor, staged_map: torch.Tensor | None,
                 requests: torch.Tensor) -> torch.Tensor:
    """The staged rows of `requests` (request indices): staged[requests]
    without a map, else staged[staged_map[requests]], rows of the
    compacted buffer."""
    if staged_map is not None:
        requests = staged_map[requests]
    return staged[requests.long()]


def tiered_gather_ref(slots: torch.Tensor, cache: torch.Tensor,
                      staged: torch.Tensor,
                      staged_map: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = cache[slots[i]] where slots[i] >= 0, else request i's staged
    row: staged[i], or staged[staged_map[i]] with a map."""
    hit = slots >= 0
    out = torch.empty((len(slots), staged.shape[1]), dtype=staged.dtype,
                      device=staged.device)
    out[hit] = cache[slots[hit].long()]
    out[~hit] = _staged_rows(staged, staged_map, (~hit).nonzero()[:, 0])
    return out


def tiered_gather_unique_ref(slots: torch.Tensor, cache: torch.Tensor,
                             staged: torch.Tensor, inverse: torch.Tensor,
                             staged_map: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The (N, D) expansion of a gather over U unique rows: row n is unique
    row inverse[n] of `tiered_gather_ref(slots, cache, staged, staged_map)`."""
    return tiered_gather_ref(slots, cache, staged, staged_map)[inverse.long()]


def frontier_gather_ref(page_slots: torch.Tensor, hot: torch.Tensor,
                        staged: torch.Tensor, inverse: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Word offsets[n] of page inverse[n], each page served from the hot
    pages (page_slots >= 0) or its staged row."""
    pages = tiered_gather_ref(page_slots, hot, staged)
    return pages[inverse.long(), offsets.long()]


def frontier_read_ref(pos: torch.Tensor, page_table: torch.Tensor,
                      hot: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Word pos[n] % W of page pos[n] // W (W = hot.shape[1]) from hot row
    page_table[page] where that is >= 0, else words[pos[n]]."""
    W = hot.shape[1]
    pos = pos.long()
    s = page_table[pos // W].long()
    return torch.where(s >= 0, hot[s.clamp_min(0), pos % W], words[pos])


def segment_mean_ref(idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    rows = feats[idx.long()]                      # (B, F, D)
    return rows.float().mean(dim=1).to(feats.dtype)


def store_fill_ref(rows: torch.Tensor, last_filler: torch.Tensor,
                   staged: torch.Tensor,
                   staged_map: torch.Tensor | None = None) -> None:
    """rows[l] = the staged row of request last_filler[l] wherever that is
    >= 0, in place (through `staged_map` where given)."""
    filled = last_filler >= 0
    rows[filled] = _staged_rows(staged, staged_map, last_filler[filled])


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


NEG_INF = -1e30


def _packed_rows(q: torch.Tensor, KV: int) -> torch.Tensor:
    """q (B, H, Sq, hd) as (B, KV, Sq * group, hd), row r = i * group + g
    holding query i of head kv * group + g (the kernels' GQA packing)."""
    B, H, Sq, hd = q.shape
    group = H // KV
    return (q.reshape(B, KV, group, Sq, hd).transpose(2, 3)
            .reshape(B, KV, Sq * group, hd))


def flash_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    splits: int, chunk: int, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    q_offset: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The split-KV partials of `flash_attention_split`: split s covers kv
    rows [s * chunk, min((s + 1) * chunk, Sk)); for each packed row r <
    Sq * group, ml[b, kv, s, r] = (m, l), the largest visible scaled score
    and the sum of exp(score - m) over the split's visible keys, and
    acc[b, kv, s, r] the unnormalised sum of exp(score - m) v, all f32.  A
    split that sees no key holds the neutral (NEG_INF, 0, 0); so do the
    padding rows up to the kernel's 16 (`SPLIT_ROWS`)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    rows = Sq * group
    rows_pad = 16
    scale = scale if scale is not None else hd ** -0.5
    qp = _packed_rows(q.float(), KV)
    s = torch.einsum("bkrd,bksd->bkrs", qp, k.float()) * scale
    q_pos = (torch.arange(rows, device=q.device) // group)[None, :]
    if q_offset is not None:
        q_pos = q_pos + q_offset.to(q.device).long()[:, None]
    q_pos = q_pos[:, None, :, None]                        # (B|1, 1, rows, 1)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones_like(q_pos + k_pos, dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    mask = mask.expand(B, KV, rows, Sk)
    ml = torch.zeros((B, KV, splits, rows_pad, 2), dtype=torch.float32,
                     device=q.device)
    ml[..., 0] = NEG_INF
    acc = torch.zeros((B, KV, splits, rows_pad, hd), dtype=torch.float32,
                      device=q.device)
    for sp in range(splits):
        lo, hi = sp * chunk, min(sp * chunk + chunk, Sk)
        if lo >= hi:
            continue
        seen = mask[..., lo:hi]
        ss = s[..., lo:hi].masked_fill(~seen, NEG_INF)
        m = ss.amax(dim=-1)
        p = torch.where(seen, torch.exp(ss - m[..., None]), 0.0)
        ml[:, :, sp, :rows, 0] = m
        ml[:, :, sp, :rows, 1] = p.sum(dim=-1)
        acc[:, :, sp, :rows] = torch.einsum("bkrs,bksd->bkrd", p,
                                            v[:, :, lo:hi].float())
    return ml, acc


def live_splits(q_offset: torch.Tensor, Sq: int, Sk: int, chunk: int,
                splits: int, causal: bool = True,
                window: int | None = None) -> torch.Tensor:
    """(B, splits) bool: whether split s of sequence b holds a key some
    query of b sees, as the kernels' `kv_band` decides it.  Queries
    q_offset[b] .. q_offset[b] + Sq - 1 see keys [begin, end) with end =
    min(Sk, q_offset[b] + Sq) under the causal mask (Sk without it) and
    begin = max(0, q_offset[b] - window + 1) under a window (0 without
    it); split s (rows [s * chunk, (s + 1) * chunk)) is live when it meets
    that band.  A dead split holds the neutral partial, and the fused
    kernel's merge does not read it."""
    off = q_offset.long()
    end = (off + Sq).clamp(max=Sk) if causal else torch.full_like(off, Sk)
    begin = ((off - window + 1).clamp(min=0) if window is not None
             else torch.zeros_like(off))
    lo = torch.arange(splits, device=off.device) * chunk
    return ((begin < end)[:, None] & (lo[None] < end[:, None])
            & (lo[None] + chunk > begin[:, None]))


def flash_combine_ref(ml: torch.Tensor, acc: torch.Tensor, H: int, Sq: int,
                      dtype: torch.dtype,
                      live: torch.Tensor | None = None) -> torch.Tensor:
    """Log-sum-exp merge of split partials into (B, H, Sq, hd): out =
    sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the splits with
    l_s > 0 (M their largest m), 0 where none saw a key.  The sums run over
    the splits in order, as the kernels' fmaf chains do.  With `live` (B,
    splits) bool, as `live_splits` gives it, a dead split is not read: it
    adds nothing where it would have added an exact 0, which is how the
    fused kernel's merge skips it."""
    B, KV, S = ml.shape[:3]
    hd = acc.shape[-1]
    group = H // KV
    rows = Sq * group
    m, l = ml[..., :rows, 0], ml[..., :rows, 1]          # (B, KV, S, rows)
    read = l > 0
    if live is not None:
        live = live.to(ml.device)
        read &= live[:, None, :, None]
    M = torch.where(read, m, NEG_INF).amax(dim=2, keepdim=True) if S else 0.0
    w = torch.where(read, torch.exp(m - M), 0.0)
    L = torch.zeros((B, KV, rows), dtype=torch.float32, device=ml.device)
    o = torch.zeros((B, KV, rows, hd), dtype=torch.float32, device=ml.device)
    for s in range(S):
        L_s = L + w[:, :, s] * l[:, :, s]
        o_s = o + w[:, :, s, :, None] * acc[:, :, s, :rows, :]
        if live is None:
            L, o = L_s, o_s
        else:
            keep = live[:, s, None, None]
            L = torch.where(keep, L_s, L)
            o = torch.where(keep[..., None], o_s, o)
    o = o * (1.0 / L.clamp_min(1e-30))[..., None]
    return (o.reshape(B, KV, Sq, group, hd).transpose(2, 3)
            .reshape(B, H, Sq, hd).to(dtype))
