"""Tiered graph-topology store, the port's subset of `repro.core.topology`:
hybrid placement of the CSR adjacency (`graph.indices`) in 4 KB edge pages
across three tiers,

  hbm      device-resident hot adjacency (`hot_pages()`, one device tensor)
  host     pinned host memory, read zero-copy over PCIe
  storage  storage-backed CSR pages, priced through `StorageTimeline`

placed by an admission policy from a registry (`degree`, `range`,
`random`).  `hop_report` prices one sampling hop's edge reads from its
unique pages per tier; `frontier_gather` is the device data path: one
`frontier_read` kernel reads each position's word where its tier keeps it,
from the hot pages in device memory or, in place over PCIe, from the
adjacency in pinned host memory at the position itself.

The port keeps no storage device: storage-tier words are read from the
same pinned adjacency as host-tier words (in this port they were always
host memory, never a storage read).  What a storage read costs stays the
priced `StorageTimeline` time of `hop_report`, which is unchanged.

Assignments, page slots, scores, reports and priced times are bit-identical
to the reference.  The `adaptive` admission (`TouchTable`), sharded page
queues, fault injectors and the metrics hook wait for their slices
(ROADMAP.md Queue 1: sharded, host, fault and adaptive planes; obs).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from .storage_sim import (INTEL_OPTANE, IO_BYTES, SSDSpec, StorageTimeline,
                          host_sampling_hop_time)

#: Topology tier indices, fastest first (aligned with `tiers.LATENCY_CLASSES`).
TOPO_TIER_NAMES = ("hbm", "host", "storage")
TIER_HBM, TIER_HOST, TIER_STORAGE = 0, 1, 2

_UNPORTED = "ROADMAP.md Queue 1: sharded, host, fault and adaptive planes"


@dataclasses.dataclass(frozen=True)
class TopologyGatherReport:
    """Per-hop edge-page telemetry from one tiered sampling hop.

    n_frontier:     destination nodes sampled this hop
    n_edge_reads:   adjacency words actually read (degree-0 destinations
                    read nothing)
    pages_by_tier:  unique 4 KB edge pages touched, split (hbm, host,
                    storage); the storage entry is the hop's coalesced IOs
    reads_by_tier:  the same edge reads split by serving tier
    shard_pages:    per-shard storage pages; empty (unsharded)
    time_s:         modelled hop time (`StorageTimeline.price_topology_hop`)
    """

    hop: int
    n_frontier: int
    n_edge_reads: int
    pages_by_tier: tuple[int, int, int]
    reads_by_tier: tuple[int, int, int]
    shard_pages: tuple[int, ...] = ()
    time_s: float = 0.0

    @property
    def n_pages(self) -> int:
        return sum(self.pages_by_tier)

    @property
    def n_storage_ios(self) -> int:
        """Coalesced storage IOs: one per unique storage-tier page."""
        return self.pages_by_tier[TIER_STORAGE]

    @property
    def coalesce_factor(self) -> float:
        return self.reads_by_tier[TIER_STORAGE] / max(self.n_storage_ios, 1)


# -- admission-policy registry -------------------------------------------------

AdmissionFactory = Callable[..., np.ndarray]
_ADMISSIONS: dict[str, AdmissionFactory] = {}


def register_admission(name: str) -> Callable[[AdmissionFactory],
                                              AdmissionFactory]:
    """Register a factory ``(n_pages, *, gpu_pages, host_pages, page_score,
    seed) -> (n_pages,) int8 assignment`` (values `TIER_*`)."""
    def deco(fn: AdmissionFactory) -> AdmissionFactory:
        _ADMISSIONS[name] = fn
        return fn
    return deco


def admission_names() -> tuple[str, ...]:
    return tuple(sorted(_ADMISSIONS))


def make_admission(name: str, n_pages: int, *, gpu_pages: int,
                   host_pages: int, page_score: np.ndarray | None = None,
                   seed: int = 0) -> np.ndarray:
    if name == "adaptive":
        raise NotImplementedError(
            f"admission 'adaptive' (TouchTable feedback) is not ported yet "
            f"({_UNPORTED})")
    try:
        factory = _ADMISSIONS[name]
    except KeyError:
        raise KeyError(f"unknown admission policy {name!r}; registered: "
                       f"{admission_names()}") from None
    assignment = np.asarray(factory(
        n_pages, gpu_pages=gpu_pages, host_pages=host_pages,
        page_score=page_score, seed=seed), np.int8)
    if assignment.shape != (n_pages,):
        raise ValueError(f"admission {name!r} returned shape "
                         f"{assignment.shape}, expected ({n_pages},)")
    return assignment


def _fill_by_order(order: np.ndarray, n_pages: int, gpu_pages: int,
                   host_pages: int) -> np.ndarray:
    """The first `gpu_pages` of `order` go to HBM, the next `host_pages` to
    pinned host, the rest to storage (nested prefixes: a larger budget only
    ever moves a page to a faster tier)."""
    assignment = np.full(n_pages, TIER_STORAGE, np.int8)
    assignment[order[:gpu_pages]] = TIER_HBM
    assignment[order[gpu_pages:gpu_pages + host_pages]] = TIER_HOST
    return assignment


@register_admission("degree")
def _degree_admission(n_pages: int, *, gpu_pages: int, host_pages: int,
                      page_score=None, **_ctx) -> np.ndarray:
    """Hottest pages (by expected sampled-edge touches) claim the fastest
    tiers."""
    if page_score is None:
        raise ValueError("degree admission needs per-page scores (build the "
                         "store via TieredTopologyStore.from_graph)")
    order = np.argsort(-np.asarray(page_score), kind="stable")
    return _fill_by_order(order, n_pages, gpu_pages, host_pages)


@register_admission("range")
def _range_admission(n_pages: int, *, gpu_pages: int, host_pages: int,
                     **_ctx) -> np.ndarray:
    return _fill_by_order(np.arange(n_pages), n_pages, gpu_pages, host_pages)


@register_admission("random")
def _random_admission(n_pages: int, *, gpu_pages: int, host_pages: int,
                      seed=0, **_ctx) -> np.ndarray:
    order = np.random.default_rng(seed).permutation(n_pages)
    return _fill_by_order(order, n_pages, gpu_pages, host_pages)


def _page_geometry(indices: np.ndarray, page_bytes: int) -> tuple[int, int]:
    """(words per page, page count) for one CSR indices array."""
    page_words = max(1, page_bytes // indices.dtype.itemsize)
    return page_words, _n_pages(len(indices), page_words)


def _n_pages(n_words: int, page_words: int) -> int:
    return max(1, -(-n_words // page_words))


def page_scores(indptr: np.ndarray, indices: np.ndarray,
                page_words: int) -> np.ndarray:
    """Expected sampled-edge touches per page, up to the shared fanout
    constant: each word scores (indeg(owner) + 1) / outdeg(owner), summed
    per page (the +1 smooths zero-in-degree owners)."""
    n = len(indptr) - 1
    outdeg = np.diff(indptr)
    indeg = np.bincount(indices, minlength=n)
    owner = np.repeat(np.arange(n, dtype=np.int64), outdeg)
    word_score = (indeg[owner] + 1.0) / np.maximum(outdeg[owner], 1)
    page = np.arange(len(indices), dtype=np.int64) // page_words
    return np.bincount(page, weights=word_score,
                       minlength=_n_pages(len(indices), page_words))


# -- the store -----------------------------------------------------------------

class TieredTopologyStore:
    """Page-granular hybrid placement of one CSR adjacency.

    `assignment[p]` is the tier of edge page `p` (words
    `indices[p*page_words : (p+1)*page_words]`); `page_slot[p]` is its row
    in the compacted hot-page array, -1 off the HBM tier.  The store owns
    its own `StorageTimeline`: the edge-page namespace drains its own
    queues.  `device` is where the hot pages and `page_table` live and the
    kernel runs; the adjacency that cold words are read from stays on the
    host (one pinned copy on CUDA).
    """

    def __init__(self, graph, assignment: np.ndarray, *,
                 page_bytes: int = IO_BYTES, policy: str = "degree",
                 ssd: SSDSpec = INTEL_OPTANE, n_ssd: int = 1,
                 device: str | torch.device = "cuda"):
        self.graph = graph
        self.indptr = graph.indptr
        self.indices = graph.indices
        self.device = resolve_device(device)
        self.page_bytes = int(page_bytes)
        self.page_words, self.n_pages = _page_geometry(self.indices,
                                                       self.page_bytes)
        assignment = np.asarray(assignment, np.int8)
        if assignment.shape != (self.n_pages,):
            raise ValueError(f"assignment shape {assignment.shape} does not "
                             f"match {self.n_pages} edge pages")
        self.assignment = assignment
        self.policy = policy
        self.timeline = StorageTimeline(ssd, n_ssd)
        gpu_pages = np.nonzero(self.assignment == TIER_HBM)[0]
        self.page_slot = np.full(self.n_pages, -1, np.int32)
        self.page_slot[gpu_pages] = np.arange(len(gpu_pages), dtype=np.int32)
        # the data path, built once: the page table and the hot pages on
        # the device; cold words are read by position from the host
        # adjacency (one pinned copy on CUDA, read in place)
        self.page_table = torch.from_numpy(self.page_slot).to(self.device)
        self._hot_pages_dev = torch.from_numpy(
            self._page_rows(gpu_pages)).to(self.device)
        words = torch.from_numpy(self.indices)
        self._host_words = (words.pin_memory()
                            if self.device.type == "cuda" else words)
        # reused per-call buffers on CUDA (pinned in/out, device in/out)
        self._io: tuple[torch.Tensor, ...] = ()

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_graph(cls, graph, *, admission: str = "degree",
                   gpu_fraction: float = 0.25, host_fraction: float = 0.5,
                   page_bytes: int = IO_BYTES, ssd: SSDSpec = INTEL_OPTANE,
                   n_ssd: int = 1, n_shards: int = 1, seed: int = 0,
                   device: str | torch.device = "cuda"
                   ) -> "TieredTopologyStore":
        """Budgeted build: `gpu_fraction` / `host_fraction` of the edge pages
        go to the HBM / pinned-host tiers (clipped to a partition), placed by
        the registered `admission` policy; the rest is storage-backed."""
        if n_shards != 1:
            raise NotImplementedError(
                f"a {n_shards}-shard topology store is not ported yet "
                f"({_UNPORTED})")
        page_words, n_pages = _page_geometry(graph.indices, page_bytes)
        gpu_pages = int(np.clip(round(gpu_fraction * n_pages), 0, n_pages))
        host_pages = int(np.clip(round(host_fraction * n_pages), 0,
                                 n_pages - gpu_pages))
        # the O(E) score pass only where a policy ranks by it
        score = None
        if admission not in ("range", "random"):
            score = page_scores(graph.indptr, graph.indices, page_words)
        assignment = make_admission(admission, n_pages, gpu_pages=gpu_pages,
                                    host_pages=host_pages, page_score=score,
                                    seed=seed)
        return cls(graph, assignment, page_bytes=page_bytes,
                   policy=admission, ssd=ssd, n_ssd=n_ssd, device=device)

    # -- telemetry -------------------------------------------------------------
    def tier_pages(self) -> tuple[int, int, int]:
        """Edge pages resident per tier (hbm, host, storage)."""
        counts = np.bincount(self.assignment, minlength=3)
        return tuple(int(c) for c in counts[:3])

    def tier_bytes(self) -> tuple[int, int, int]:
        return tuple(c * self.page_bytes for c in self.tier_pages())

    def hop_report(self, edge_positions: np.ndarray, *, hop: int = 0,
                   n_frontier: int = 0) -> TopologyGatherReport:
        """Price one hop's adjacency reads: map each read to its page,
        dedupe pages (a page is one 4 KB IO line), split by tier, and model
        the hop time."""
        pos = np.asarray(edge_positions, np.int64)
        if len(pos) == 0:
            return TopologyGatherReport(
                hop=hop, n_frontier=int(n_frontier), n_edge_reads=0,
                pages_by_tier=(0, 0, 0), reads_by_tier=(0, 0, 0))
        pages, read_counts = np.unique(pos // self.page_words,
                                       return_counts=True)
        tiers = self.assignment[pages]
        pages_by_tier = tuple(
            int(c) for c in np.bincount(tiers, minlength=3)[:3])
        reads_by_tier = tuple(
            int(c) for c in np.bincount(tiers, weights=read_counts,
                                        minlength=3)[:3])
        report = TopologyGatherReport(
            hop=hop, n_frontier=int(n_frontier), n_edge_reads=len(pos),
            pages_by_tier=pages_by_tier, reads_by_tier=reads_by_tier)
        return dataclasses.replace(
            report, time_s=self.timeline.price_topology_hop(report))

    # -- device data path ------------------------------------------------------
    def hot_pages(self) -> torch.Tensor:
        """The compacted HBM-resident hot-page array on the store's device,
        (H, page_words) in the adjacency dtype, uploaded once: row
        `page_slot[p]` holds page p.  A zero-budget store holds one dummy
        row so that the plain version's clamped rows stay in bounds."""
        return self._hot_pages_dev

    def host_words(self) -> torch.Tensor:
        """The adjacency (E,) on the host that cold words are read from by
        their raw position: one pinned copy on CUDA, `graph.indices` itself
        on the CPU.  Hot pages' words are never read from it."""
        return self._host_words

    def _page_rows(self, pages: np.ndarray) -> np.ndarray:
        """Whole pages from the host CSR (the tail page padded by clamping:
        offsets never address past the real edge count); one zero row for
        no pages."""
        if len(pages) == 0:
            return np.zeros((1, self.page_words), self.indices.dtype)
        idx = (np.asarray(pages, np.int64)[:, None] * self.page_words
               + np.arange(self.page_words, dtype=np.int64)[None, :])
        return self.indices[np.minimum(idx, len(self.indices) - 1)]

    def _buffers(self, n: int) -> tuple[torch.Tensor, ...]:
        """Pinned positions and words on the host, and their device twins,
        of at least n entries; grown by doubling, reused across calls."""
        if not self._io or self._io[0].numel() < n:
            cap = max(1 << max(n - 1, 1).bit_length(), 4096)
            words = self._hot_pages_dev.dtype
            self._io = (
                torch.empty(cap, dtype=torch.int64, pin_memory=True),
                torch.empty(cap, dtype=words, pin_memory=True),
                torch.empty(cap, dtype=torch.int64, device=self.device),
                torch.empty(cap, dtype=words, device=self.device))
        return tuple(t[:n] for t in self._io)

    def frontier_gather(self, edge_positions: np.ndarray) -> np.ndarray:
        """The sampled words `graph.indices[edge_positions]`, read through
        the tiered page store: the `frontier_read` kernel maps each
        position to its page and reads its word from `hot_pages()` or, in
        place at the position, from `host_words()`.  On CUDA one call is one H2D copy of
        the positions, one launch and one D2H copy of the words, through
        reused pinned buffers.  Returns host numpy in the adjacency dtype,
        shaped like `edge_positions`; bit-identical to
        `graph.indices[edge_positions]`."""
        pos = np.asarray(edge_positions, np.int64)
        flat = pos.reshape(-1)
        if len(flat) == 0:
            return np.empty(pos.shape, self.indices.dtype)
        lo, hi = flat.min(), flat.max()
        if lo < 0 or hi >= len(self.indices):
            raise IndexError(f"edge positions [{lo}, {hi}] outside the "
                             f"{len(self.indices)} adjacency words")
        if self.device.type == "cpu":
            out = ops.frontier_read(torch.from_numpy(flat), self.page_table,
                                    self._hot_pages_dev, self._host_words)
            return out.numpy().reshape(pos.shape)
        pos_host, out_host, pos_dev, out_dev = self._buffers(len(flat))
        # the previous call synchronised after its copies, so the pinned
        # buffers are free to overwrite
        pos_host.numpy()[:] = flat
        pos_dev.copy_(pos_host, non_blocking=True)
        ops.frontier_read(pos_dev, self.page_table, self._hot_pages_dev,
                          self._host_words, out=out_dev)
        out_host.copy_(out_dev, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return out_host.numpy().copy().reshape(pos.shape)


def host_sampling_time(reports) -> float:
    """The CPU-sampling baseline priced over the same hops a tiered run
    reported (`storage_sim.host_sampling_hop_time` per hop)."""
    return sum(host_sampling_hop_time(r.n_edge_reads, r.n_frontier)
               for r in reports)
