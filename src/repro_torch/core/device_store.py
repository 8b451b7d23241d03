"""Device-resident GIDS feature tier, the port's counterpart of
`repro.core.device_store`: cache metadata (`cache_device`) + a row store
on the device + the `tiered_gather` kernel.

One `device_gather` call runs the cache access, serves every requested row
from the row store or the staged rows, and then writes the filled lines
into the row store.  The row store and the metadata are updated IN PLACE
(the JAX version returns a new store).

The order differs from the reference on purpose: rows are served before
this call's fills land.  The reference fills first and gathers after, so a
hit on a line that a later miss of the same call evicts and refills is
served the later request's row (ROADMAP.md Queue 3).  Here a hit is served
from the row store only when no earlier request of the call filled its
line, and otherwise from its staged row, which holds the same bytes; a line
filled more than once keeps the row of its last filler, the tag that
stands.  The cache metadata equals the reference's bit for bit, and the
rows always equal `features[ids]`.

`device_gather_merged` is the same step for a merged window: one cache
access over the window's U unique ids, one `tiered_gather_unique` per
batch expanding the unique rows through that batch's inverse, and then one
fill.  Every expansion reads the row store before the window's fills land,
so each batch's rows equal `features[batch nodes]`.  (The reference has no
such function: its merged executor expands the probe's rows with numpy.)

Both take the staged rows either as a tensor with one row per request (the
reference's contract) or as a staging callable, which is asked for them
once the cache access has run: `stage(need, hits)` gets the (B,) bool
masks of the requests read from staged rows (serve slot -1: the misses,
the bypasses and any hit on a line an earlier request of the call filled)
and of the hits, and returns `(staged, staged_map)`: `staged` holds only
the needed requests' rows, compacted, and `staged_map` (B,) int32 gives
each request's row in it (-1 where not needed).  The device tier stages
and copies that way only the rows the card reads.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from . import cache_device


class DeviceStore(NamedTuple):
    cache: cache_device.CacheState
    rows: torch.Tensor              # (num_lines, D) device row storage


def init_store(num_lines: int, dim: int, ways: int = 8,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> DeviceStore:
    dev = resolve_device(device)
    return DeviceStore(cache=cache_device.init_cache(num_lines, ways, dev),
                       rows=torch.zeros((num_lines, dim), dtype=dtype,
                                        device=dev))


#: `stage(need, hits) -> (staged, staged_map)`, as set out above.
StageRows = Callable[[torch.Tensor, torch.Tensor],
                     tuple[torch.Tensor, torch.Tensor]]


def _no_mark(stage: str) -> None:
    del stage


def _staged_rows(staged: torch.Tensor | StageRows,
                 res: cache_device.AccessResult):
    """(staged, staged_map) for the gather and the fill: a tensor as it is,
    a staging callable asked with this access's masks."""
    if isinstance(staged, torch.Tensor):
        return staged, None
    return staged(res.serve_slots < 0, res.hits)


def device_gather(store: DeviceStore, ids: torch.Tensor,
                  staged: torch.Tensor | StageRows,
                  future_counts: torch.Tensor,
                  mark: Callable[[str], None] = _no_mark):
    """ids: (B,) int32 node ids (-1 pad); staged: (B, D) host-fetched rows
    of the ids, or a staging callable (above); future_counts: (B,) int32
    window-buffer reuse counts.  `mark(stage)` is called right before the
    access's first launch ("access", once the host has prepared it) and
    after each of the three steps ("cache_access", "gather", "fill"), for
    timing; a staging callable runs between the first two steps.

    Returns (store, rows (B, D), hit_mask); `store` is the same object,
    updated in place."""
    res = cache_device.access(store.cache, ids, future_counts,
                              lambda: mark("access"))
    mark("cache_access")
    rows, rows_map = _staged_rows(staged, res)
    out = ops.tiered_gather(res.serve_slots, store.rows, rows, rows_map)
    mark("gather")
    ops.store_fill(store.rows, res.last_filler, rows, rows_map)
    mark("fill")
    return store, out, res.hits


def device_gather_merged(store: DeviceStore, ids_u: torch.Tensor,
                         staged_u: torch.Tensor | StageRows,
                         fc_u: torch.Tensor, inverses,
                         mark: Callable[[str], None] = _no_mark):
    """ids_u: (U,) int32 unique node ids of a window; staged_u: (U, D)
    their host-fetched rows, or a staging callable (above); fc_u: (U,)
    int32 reuse counts in the next window; inverses: one (N_i,) int32
    device tensor per batch mapping its rows to unique rows.  `mark` is
    called before the access ("access"), and after "cache_access", "gather"
    (all the expansions) and "fill".

    Returns (store, [rows_i (N_i, D)], hit_mask (U,)); `store` is updated
    in place."""
    res = cache_device.access(store.cache, ids_u, fc_u,
                              lambda: mark("access"))
    mark("cache_access")
    rows, rows_map = _staged_rows(staged_u, res)
    outs = [ops.tiered_gather_unique(res.serve_slots, store.rows, rows, inv,
                                     rows_map) for inv in inverses]
    mark("gather")
    ops.store_fill(store.rows, res.last_filler, rows, rows_map)
    mark("fill")
    return store, outs, res.hits


push_window = cache_device.push_window
count_in_window = cache_device.count_in_window
