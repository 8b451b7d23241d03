"""Window-buffered software-defined cache (paper §3.4, Fig. 6), the port's
copy of `repro.core.software_cache`: the numpy metadata of the host planes'
cache tier (`tiers.DeviceCacheTier`, which keeps the matching row store on
the device).

The window buffer holds the sampled node ids of the next W mini-batches;
a resident line's counter counts its node's future reuses, and a line with
counter > 0 ("USE") cannot be evicted.  Each reuse decrements the counter.
`window_depth = 0` is the BaM baseline: random eviction, no pinning.

Geometry: `num_sets x ways`, the set chosen by a 32-bit Fibonacci hash of
the node id.  `access` is a loop in request order, because fills and
evictions depend on it; `lookup` and `_bump_counters`, whose results do not
depend on order, are vectorised and equal the reference's loops bit for
bit.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

# 32-bit Fibonacci hash, shared bit for bit with `cache_device._set_of`
_HASH_MULT = np.uint32(0x9E3779B9)


def _hash_ids(ids: np.ndarray, num_sets: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (ids.astype(np.uint32) * _HASH_MULT) >> np.uint32(8)
    return (h % np.uint32(num_sets)).astype(np.int64)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    fills: int = 0
    bypasses: int = 0   # miss with no evictable way (contention)
    evictions: int = 0

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_ratio(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0


class WindowBufferedCache:
    """Set-associative software cache with future-reuse pinning."""

    def __init__(self, num_lines: int, ways: int = 8, window_depth: int = 0,
                 seed: int = 0, evict: str = "random"):
        if num_lines % ways:
            raise ValueError(f"{num_lines} lines is not a whole number of "
                             f"{ways}-way sets")
        if evict not in ("random", "first"):
            raise ValueError(f"unknown eviction {evict!r}: random or first")
        self.num_sets = num_lines // ways
        self.ways = ways
        self.window_depth = window_depth
        self.evict = evict
        self._seed = seed
        self.tags = np.full((self.num_sets, ways), -1, dtype=np.int64)
        self.reuse = np.zeros((self.num_sets, ways), dtype=np.int64)
        self.window: deque[np.ndarray] = deque()
        self.stats = CacheStats()
        self._rng = np.random.default_rng(seed)

    def reset(self) -> None:
        """Return to the exact post-construction state: metadata, stats,
        window and the eviction rng."""
        self.tags.fill(-1)
        self.reuse.fill(0)
        self.window.clear()
        self.stats = CacheStats()
        self._rng = np.random.default_rng(self._seed)

    # -- window management ---------------------------------------------------
    def push_window(self, future_nodes: np.ndarray) -> None:
        """Insert the (deduplicated) node list of a future iteration and
        count one more reuse on each of its resident lines."""
        if self.window_depth == 0:
            return
        self.window.append(future_nodes)
        if len(self.window) > self.window_depth:
            raise RuntimeError(f"window overfull: {len(self.window)} entries "
                               f"for depth {self.window_depth}")
        self._bump_counters(future_nodes, +1)

    def _bump_counters(self, nodes: np.ndarray, delta: int) -> None:
        """reuse = max(0, reuse + delta) once per resident node; a node
        listed k times moves its counter k times, as the loop does, since
        max(0, . + delta) applied k times is max(0, . + k * delta)."""
        nodes = np.asarray(nodes)
        sets = _hash_ids(nodes, self.num_sets)
        match = self.tags[sets] == nodes[:, None]
        found = match.any(axis=1)
        s, w = sets[found], match[found].argmax(axis=1)
        np.add.at(self.reuse, (s, w), delta)
        self.reuse[s, w] = np.maximum(self.reuse[s, w], 0)

    def _future_count(self, node: int) -> int:
        return sum(int((w == node).sum()) for w in self.window)

    # -- access path -----------------------------------------------------------
    def access(self, nodes: np.ndarray,
               multiplicity: np.ndarray | None = None) -> np.ndarray:
        """Process one mini-batch's (deduplicated) feature requests and
        return the hit mask.  On entry the window's front is this batch; it
        leaves the window now, and each hit consumes one reuse.

        With `multiplicity` (merged-window semantics, `access_merged`) the
        window is not popped, since the caller already retired the consumed
        entries, and each hit consumes its full multiplicity."""
        if multiplicity is None and self.window_depth > 0 and self.window:
            self.window.popleft()
        sets = _hash_ids(nodes, self.num_sets)
        hits = np.zeros(len(nodes), dtype=bool)
        for i, (s, n) in enumerate(zip(sets, nodes)):
            ways = self.tags[s]
            w = np.nonzero(ways == n)[0]
            if len(w):
                hits[i] = True
                self.stats.hits += 1
                j = int(w[0])
                dec = 1 if multiplicity is None else int(multiplicity[i])
                self.reuse[s, j] = max(0, int(self.reuse[s, j]) - dec)
                continue
            self.stats.misses += 1
            self._fill(s, int(n))
        return hits

    def access_merged(self, nodes: np.ndarray,
                      multiplicity: np.ndarray) -> np.ndarray:
        """One deduplicated probe for a whole window of batches: each
        resident node's counter consumes its full window multiplicity at
        once.  The caller retires the consumed window entries and pushes
        the next window's before this access, so fills pin lines by the
        upcoming window's reuse."""
        return self.access(nodes, multiplicity=multiplicity)

    def _fill(self, s: int, node: int) -> None:
        ways = self.tags[s]
        empty = np.nonzero(ways == -1)[0]
        if len(empty):
            w = int(empty[0])
        else:
            safe = np.nonzero(self.reuse[s] == 0)[0]
            if len(safe) == 0:
                self.stats.bypasses += 1   # all ways pinned: serve uncached
                return
            # random among the safe ways (BaM); "first" is the
            # deterministic twin of the device cache
            w = int(self._rng.choice(safe)) if self.evict == "random" \
                else int(safe[0])
            self.stats.evictions += 1
        self.tags[s, w] = node
        self.stats.fills += 1
        if self.window_depth > 0:
            self.reuse[s, w] = self._future_count(node)
        else:
            self.reuse[s, w] = 0

    # -- introspection ---------------------------------------------------------
    def lookup(self, nodes: np.ndarray) -> np.ndarray:
        """Resident line index (set * ways + way) per node, -1 if absent.
        Read-only: no stats, no fills."""
        nodes = np.asarray(nodes)
        sets = _hash_ids(nodes, self.num_sets)
        match = self.tags[sets] == nodes[:, None]
        return np.where(match.any(axis=1),
                        sets * self.ways + match.argmax(axis=1), -1)

    def pinned_lines(self) -> int:
        return int((self.reuse > 0).sum())

    def occupancy(self) -> float:
        return float((self.tags >= 0).mean())


def run_trace(cache: WindowBufferedCache, batches: list[np.ndarray]
              ) -> CacheStats:
    """Feed per-iteration (deduplicated) node lists through the cache with
    look-ahead: prime the window with the first W batches, then each
    access pops itself off the front and pushes batch i + W."""
    W = cache.window_depth
    for b in batches[:W]:
        cache.push_window(b)
    for i, b in enumerate(batches):
        cache.access(b)
        if W > 0 and i + W < len(batches):
            cache.push_window(batches[i + W])
    return cache.stats
