"""Device-resident window-buffered cache metadata, the port's counterpart
of `repro.core.cache_jax`.

Tags, reuse counters and the slot table live on the loader's device and are
updated in place (the JAX version threads them through jit as immutable
state).  The semantics are `cache_jax`'s bit for bit: the same set hash,
the same first-way choices, the same counters.  Padding node id = -1.

`access` dispatches on the device: CPU tensors run `access_ref`, a Python
loop that mirrors `cache_jax.access` request by request; CUDA tensors run
`cache_bucket` (a stable counting sort of the requests by set, one launch
of one cluster of blocks in shared memory) and then the `cache_access`
kernel (kernels/csrc/cache_access.cu), one warp per set walking its own
bucket in request order, launched so that it starts while the sort runs
and waits for it before it reads the buckets.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build

_HASH_MULT = 0x9E3779B9  # 32-bit Fibonacci hash, as the reference's
_MAX_WAYS = 64           # the kernel tracks filled ways in a 64-bit mask
#: the largest set count cache_bucket accepts, the kernel's kMaxSets.  The
#: three-kernel bucketing it replaced held a (sets + 1) int32 histogram
#: beside a 1024-key tile in one block's 227 KB of shared memory, which
#: gave 57087; the one-launch sort takes its keys in windows and has no such
#: ceiling, and keeps the value so every count accepted before still is
_MAX_SETS = 57087


class CacheState(NamedTuple):
    tags: torch.Tensor      # (num_sets, ways) int32 node id, -1 = empty
    reuse: torch.Tensor     # (num_sets, ways) int32 future-reuse counter
    slots: torch.Tensor     # (num_sets, ways) int32 row of the line in the
                            # device row store (constant layout set*ways+way)
    hits: torch.Tensor      # () int64 running counters
    misses: torch.Tensor    # ()
    bypasses: torch.Tensor  # ()


class AccessResult(NamedTuple):
    hits: torch.Tensor         # (B,) bool
    slots: torch.Tensor        # (B,) int32 line of a hit or fill, else -1
    serve_slots: torch.Tensor  # (B,) int32 line to serve request i from:
                               # a hit whose line no earlier request of this
                               # call filled, else -1 (serve the staged row)
    last_filler: torch.Tensor  # (num_lines,) int32 request whose row the
                               # line holds after the call, -1 if unfilled


def init_cache(num_lines: int, ways: int = 8,
               device: str | torch.device = "cuda") -> CacheState:
    if num_lines % ways:
        raise ValueError(f"num_lines {num_lines} is not a multiple of "
                         f"ways {ways}")
    if not 0 < ways <= _MAX_WAYS:
        raise ValueError(f"ways must be in 1..{_MAX_WAYS}, got {ways}")
    dev = resolve_device(device)
    num_sets = num_lines // ways
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    return CacheState(
        tags=torch.full((num_sets, ways), -1, **i32),
        reuse=torch.zeros((num_sets, ways), **i32),
        slots=torch.arange(num_lines, **i32).reshape(num_sets, ways),
        hits=torch.zeros((), **i64),
        misses=torch.zeros((), **i64),
        bypasses=torch.zeros((), **i64),
    )


def _set_of(ids: torch.Tensor, num_sets: int) -> torch.Tensor:
    """((uint32)id * 0x9E3779B9 mod 2^32) >> 8, mod num_sets, as int32.
    Computed in int64 on the id's low 32 bits, split into 16-bit halves so
    no product exceeds 2^48: exact for -1 and for ids past 2^31."""
    a = ids.to(torch.int64) & 0xFFFFFFFF
    lo = a & 0xFFFF
    hi = a >> 16
    h = (lo * _HASH_MULT + (((hi * _HASH_MULT) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return ((h >> 8) % num_sets).to(torch.int32)


def push_window(state: CacheState, nodes: torch.Tensor) -> CacheState:
    """Bump the reuse counter of every cached line whose tag appears in
    `nodes` (a future batch, -1 padded), once per occurrence, in place.
    Exact against the reference's sequential loop: increments commute and
    touch no tag."""
    num_sets, ways = state.tags.shape
    nodes = nodes.to(device=state.tags.device, dtype=torch.int32)
    sets = _set_of(nodes, num_sets).long()
    match = (state.tags[sets] == nodes[:, None]) & (nodes >= 0)[:, None]
    lines = sets[:, None] * ways + torch.arange(ways, device=sets.device)
    state.reuse.view(-1).index_add_(0, lines.reshape(-1),
                                    match.reshape(-1).to(torch.int32))
    return state


def count_in_window(nodes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """future_counts[i] = occurrences of nodes[i] in `window` (W, B) of
    future batches (padded with -1)."""
    flat = window.reshape(-1)
    eq = (nodes[:, None] == flat[None, :]) & (nodes >= 0)[:, None]
    return eq.sum(dim=1).to(torch.int32)


def access_ref(state: CacheState, nodes: torch.Tensor,
               future_counts: torch.Tensor) -> AccessResult:
    """Plain version of `access` for CPU tensors: the reference's
    `cache_jax.access` loop, request by request, updating the state in
    place, plus the serve slots and last fillers of `AccessResult`."""
    if state.tags.device.type != "cpu":
        raise ValueError("access_ref runs on CPU tensors; CUDA tensors go "
                         "through access()")
    tags = state.tags.numpy()        # views: writes land in the state
    reuse = state.reuse.numpy()
    slot_table = state.slots.numpy()
    num_sets, ways = tags.shape
    ids = nodes.to(torch.int32).numpy()
    fcs = future_counts.to(torch.int32).numpy()
    sets = _set_of(nodes, num_sets).numpy()
    B = len(ids)
    hit_mask = np.zeros(B, bool)
    slot_out = np.full(B, -1, np.int32)
    serve = np.full(B, -1, np.int32)
    last_filler = np.full(num_sets * ways, -1, np.int32)
    filled = np.zeros(num_sets * ways, bool)
    hits = misses = bypasses = 0
    for i in range(B):
        n, s, fc = ids[i], sets[i], fcs[i]
        if n < 0:                                   # padding: no effect
            continue
        row_tags, row_reuse = tags[s], reuse[s]
        match = row_tags == n
        if match.any():
            way = int(np.argmax(match))             # first matching way
            row_reuse[way] = max(row_reuse[way] - 1, 0)
            hits += 1
            hit_mask[i] = True
            line = slot_table[s, way]
            slot_out[i] = line
            if not filled[line]:
                serve[i] = line
            continue
        misses += 1
        empty = row_tags == -1
        safe = row_reuse == 0
        if not (empty.any() or safe.any()):
            bypasses += 1
            continue
        way = int(np.argmax(empty)) if empty.any() else int(np.argmax(safe))
        row_tags[way] = n
        row_reuse[way] = fc
        line = slot_table[s, way]
        slot_out[i] = line
        filled[line] = True
        last_filler[line] = i
    state.hits.add_(hits)
    state.misses.add_(misses)
    state.bypasses.add_(bypasses)
    return AccessResult(torch.from_numpy(hit_mask), torch.from_numpy(slot_out),
                        torch.from_numpy(serve), torch.from_numpy(last_filler))


def bucket_by_set_ref(ids: torch.Tensor,
                      num_sets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `cache_bucket`: `order` (B,) int32 is the stable
    argsort of key = set of the id, or num_sets for padding (id < 0), so
    each set's requests keep their request order and padding lands in a
    trailing bucket of its own; `start` (num_sets + 2,) int32 holds each
    bucket's first position, start[num_sets + 1] = B."""
    key = torch.where(ids >= 0, _set_of(ids, num_sets).long(), num_sets)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = torch.bincount(key, minlength=num_sets + 1)
    start = torch.zeros(num_sets + 2, dtype=torch.int64, device=ids.device)
    start[1:] = counts.cumsum(0)
    return order, start.to(torch.int32)


def _bucket_launch(ids: torch.Tensor, num_sets: int):
    """Checks `cache_bucket`'s input and allocates its output: returns
    (order, start, launch), `launch()` enqueuing the kernel."""
    _build.require_cuda("cache_bucket", ids)
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"cache_bucket: ids must be (B,) int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if not 0 < num_sets <= _MAX_SETS:
        raise ValueError(f"cache_bucket: num_sets must be in "
                         f"1..{_MAX_SETS}, got {num_sets}")
    B = ids.shape[0]
    order = torch.empty(B, dtype=torch.int32, device=ids.device)
    start = torch.empty(num_sets + 2, dtype=torch.int32, device=ids.device)
    P, I = _build.P, _build.I
    fn = _build.function("cache_access", "cache_bucket", (P, I, I, P, P, P))
    args = (ids.data_ptr(), B, num_sets, order.data_ptr(), start.data_ptr(),
            _build.stream(ids))

    def launch() -> None:
        _build.check(fn(*args), "cache_bucket")
        _build.LAUNCHES["cache_bucket"] += 1
    return order, start, launch


def _bucket_cuda(ids: torch.Tensor,
                 num_sets: int) -> tuple[torch.Tensor, torch.Tensor]:
    order, start, launch = _bucket_launch(ids, num_sets)
    launch()
    return order, start


def bucket_by_set(ids: torch.Tensor,
                  num_sets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The requests' stable order by set and each bucket's start: CPU
    tensors take `bucket_by_set_ref`, CUDA tensors the `cache_bucket`
    kernel."""
    if ids.device.type == "cpu":
        return bucket_by_set_ref(ids, num_sets)
    return _bucket_cuda(ids, num_sets)


def _access_cuda(state: CacheState, nodes: torch.Tensor,
                 future_counts: torch.Tensor,
                 before_launch: Callable[[], None]) -> AccessResult:
    _build.require_cuda("cache_access", nodes, future_counts, *state)
    for name, t in (("nodes", nodes), ("future_counts", future_counts),
                    ("tags", state.tags), ("reuse", state.reuse),
                    ("slots", state.slots)):
        if t.dtype != torch.int32:
            raise ValueError(f"cache_access: {name} must be int32, got "
                             f"{t.dtype}")
    for name in ("hits", "misses", "bypasses"):
        if getattr(state, name).dtype != torch.int64:
            raise ValueError(f"cache_access: {name} counter must be int64")
    B = nodes.shape[0]
    if nodes.dim() != 1 or future_counts.shape != (B,):
        raise ValueError("cache_access: nodes and future_counts must be "
                         "(B,) each")
    num_sets, ways = state.tags.shape
    if ways > _MAX_WAYS or state.slots.shape != state.tags.shape \
            or state.reuse.shape != state.tags.shape:
        raise ValueError(f"cache_access: tags, reuse and slots must share "
                         f"one (num_sets, ways <= {_MAX_WAYS}) shape")
    order, start, launch_bucket = _bucket_launch(nodes, num_sets)
    dev = nodes.device
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    slot = torch.empty(B, dtype=torch.int32, device=dev)
    serve = torch.empty(B, dtype=torch.int32, device=dev)
    last_filler = torch.empty(num_sets * ways, dtype=torch.int32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("cache_access", "cache_access",
                         (P, P, P, P, I, P, P, P, I, I, P, P, P, P, P, P, P,
                          P))
    args = (nodes.data_ptr(), future_counts.data_ptr(), order.data_ptr(),
            start.data_ptr(), B, state.tags.data_ptr(),
            state.reuse.data_ptr(), state.slots.data_ptr(), num_sets, ways,
            hit.data_ptr(), slot.data_ptr(), serve.data_ptr(),
            last_filler.data_ptr(), state.hits.data_ptr(),
            state.misses.data_ptr(), state.bypasses.data_ptr(),
            _build.stream(nodes))
    # the two launches back to back, once everything above is done: the
    # walk is launched while the bucketing runs (programmatic dependent
    # launch), and `before_launch` can time the card's work alone
    before_launch()
    launch_bucket()
    _build.check(fn(*args), "cache_access")
    _build.LAUNCHES["cache_access"] += 1
    return AccessResult(hit, slot, serve, last_filler)


def _nothing() -> None:
    pass


def access(state: CacheState, nodes: torch.Tensor,
           future_counts: torch.Tensor,
           before_launch: Callable[[], None] = _nothing) -> AccessResult:
    """Lookup + fill for the current batch (already popped off the window),
    updating `state` in place.  future_counts[i] = occurrences of nodes[i]
    in the remaining window.  CPU tensors take `access_ref`, CUDA tensors
    the kernel.  `before_launch()` is called once the host has checked the
    inputs and allocated the outputs, right before the first launch (on the
    CPU, before the reference runs)."""
    if all(t.device.type == "cpu" for t in (nodes, future_counts, *state)):
        before_launch()
        return access_ref(state, nodes, future_counts)
    return _access_cuda(state, nodes, future_counts, before_launch)
