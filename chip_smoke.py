#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Card and set-up: the `nvidia-smi` name and power limit, TF32 off, and
   the build of every CUDA kernel of the port from src/repro_torch/kernels/
   csrc (one nvcc per source, all started together, into build/kernels/).
2. Per-kernel parity and timing at the main paths' shapes: each kernel
   against its plain PyTorch version on the same inputs (gathers, word
   gather, word reads, row-store fill, cache bucketing and cache access
   exact; segment_mean within 1e-6 in f32 and 2e-2 in bf16, also at
   fanouts 1, 3, 9 and 33 and at row widths 1000 and 1001; flash_attention
   within 3e-4 in f32 and 3e-2 in bf16, and every output row within 1e-4
   (f32) or 1e-2 (bf16) of its reference row in norm, at the sweep of
   tests/test_kernels.py, at the serving path's prefill, decode and a
   sliding-window shape, at decode edges (offsets 0 and Sk - 1, and one
   sequence) in both types, and on the tensor-core path at hd 16, 32 and
   a ragged Sq of 1000 in bf16; the split-KV merge flash_combine within
   1e-5 in f32 and 1e-2 in bf16).  cache_access runs uniform rounds at
   B 8192 and 28000 and a round whose ids all hash into 4 sets, and
   cache_bucket runs at its largest set count and refuses one more.
   frontier_read runs one batch's two hops of sampled positions through
   real topology stores (and int64 words, all-cold and all-hot stores),
   with the whole store call's host time beside the kernel's, and a bound
   that counts the cold words' 32-byte sectors at the peak PCIe Gen5 x16
   rate (the pinned H2D copy rate the run measures is printed beside it,
   `pcie_h2d_gbps`).  Times
   are CUDA-event medians of 20 launches after warm-up, with a 256 MB
   buffer written and a short device sleep before each launch, so that
   every launch starts from a cold L2 and the host's enqueue time is
   never timed.
3. The first main path: GraphSAGE training at the full width of
   examples/train_gnn_igb_torch.py (100k-node RMAT graph, 1024-d features,
   hidden 4096, batch 512, fanouts (10, 5)) through the `gids-device` data
   plane, for STEPS steps.  Every batch's features must equal the host
   features of its nodes bit for bit, step 0's loss must agree with the
   loss computed through the plain versions to rtol 1e-5, every loss must
   be finite, the cache must hit, and every kernel's launch count over the
   run must be positive.
4. The second main path: the same model and graph through
   `DataPlaneSpec.preset("gids-device", merge_execute=True, topology=True)`
   for MERGED_STEPS steps (two merged windows of 8 batches): each window's
   unique rows go through the device store once and are expanded per batch
   by `tiered_gather_unique`, and every sampling hop reads its adjacency
   words through the tiered edge-page store with one `frontier_read`
   launch (hot pages on the card, the rest read in place from the
   adjacency in pinned host memory).  Every batch's features must equal the host features bit
   for bit, every hop's words must equal `graph.indices[pos]`, step 0's
   loss must agree with the plain versions' to rtol 1e-5, every loss must
   be finite, every batch must carry priced sampling time, each of the
   path's kernels must be launched, and `frontier_read` exactly once per
   hop.  Each window prints the host time of its `frontier_gather` calls
   and their median (`frontier_call_ms`).
5. LM serving at the full published width of qwen2-1.5b (28 layers,
   d_model 1536, 12 heads, GQA kv 2, hd 128, d_ff 8960, padded vocab
   153600, 1,546,270,208 parameters) with `attn_impl="flash"`, weights
   drawn on the card from a fixed CUDA generator.  Gates in f32 with TF32
   off: teacher-forced logits of one GATE["prompt"]-token prompt through
   `forward`, and through `prefill` plus GATE["steps"] decode steps, on the
   flash path against the einsum path's `forward` within GATE["tol"]; then
   3 prompts through a 2-slot `ServeEngine` give the tokens of
   single-request greedy decoding.  Then it serves in bf16 (the config's
   dtypes): SERVE["requests"] requests with prompt lengths from
   `default_rng(0).integers(64, 1025, 16)` and SERVE["new_tokens"] new
   tokens each through `EngineConfig(slots=8, max_seq=2048)`.  Every
   request must retire with its tokens, the slot pool must end empty,
   every logit must be finite, and `flash_attention` must have launched
   exactly 28 x (prefills + decode ticks) times and `flash_combine` 28 x
   decode ticks (every tick splits the kv range).  Prints prefill ms per
   request against prompt length, decode ms per tick, tokens/s and peak
   memory.  After the counted run, `torch.profiler` traces one 1024-token
   prefill and PROFILE_TICKS decode ticks at 8 active slots and prints the
   card's busy time per tick and its top kernels.
6. One JSON line `{"kernels": [...]}` and, last, one JSON line naming the
   device.

    python3 chip_smoke.py --plant-fault band_edge|full_lo

builds flash_attention.cu with a known fault planted (FAULTS) into a
temporary directory, and shows that phase 2's bf16 gate passes the sound
kernel and rejects the faulty one on the same inputs.

    python3 chip_smoke.py --segment-mean-variants

times the segment_mean kernel beside copies of it built with another
order of its work, another batch of loads in flight or another scalar
chunk, and beside the block-per-destination kernel it replaced
(SEGMENT_MEAN_VARIANTS), in turns on the same inputs at every phase-2
segment_mean row.

The script imports torch, numpy and the port (src/repro_torch) only.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
STEPS = 8
MERGED_STEPS = 16
#: the full width of examples/train_gnn_igb_torch.py, where phases 3 and 4
#: train, and the card they train on
FULL = dict(nodes=100_000, dim=1024, hidden=4096, batch=512,
            cache_lines=1 << 14)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores, same
BF16_FLOPS_PER_S = 989e12     # bf16 tensor cores, dense, same
#: PCIe Gen5 x16, one direction, after 128b/130b encoding (the data sheet's
#: 128 GB/s counts both directions): the peak for reads of host memory
PCIE_H2D_BYTES_PER_S = 63e9
#: phase 5: the f32 gate and the bf16 serving run
GATE = dict(prompt=512, steps=16, tol=1e-3)
SERVE = dict(slots=8, max_seq=2048, requests=16, new_tokens=32)
PROFILE_TICKS = 4
REPS, WARMUP = 20, 3
SLEEP_CYCLES = 1_000_000      # ~0.5 ms of device time before each timed call


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# -- phase 1 -------------------------------------------------------------------

def card_and_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.SOURCES:
        _build.library(name)
    seconds = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "compiled": sorted(logs), "ptxas": ptxas})


# -- phase 2 -------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, over REPS calls after WARMUP,
    with `setup()` (untimed) and an L2 flush before each call.  A short
    device-side sleep after the flush keeps the card busy while the host
    enqueues the call, so the events time the device's work and never the
    wrapper's Python (the flush alone did not always cover it)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, setup=None, reps=REPS) -> float:
        torch = self.torch
        args = setup() if setup else ()
        for _ in range(WARMUP):
            fn(*args)
            args = setup() if setup else ()
        times = []
        for _ in range(reps):
            args = setup() if setup else ()
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def host_ms(fn, setup, reps=3) -> float:
    times = []
    for _ in range(reps):
        args = setup()
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: int, flops: int = 0,
          flops_per_s: float = F32_FLOPS_PER_S) -> dict:
    """The least time the card could take for the work: the bytes it must
    move over the memory rate, or its operations over the peak rate for
    their type (f32 on the vector units by default), whichever is
    larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


SUMMARY_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")


def summary(rows: list[dict]) -> dict:
    """One kernel's numbers per training step: the sum over the launches
    a step makes at the main path's shapes."""
    return {"ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                         else "operations"),
            "library_ms": (None if rows[0]["library_ms"] is None
                           else sum(r["library_ms"] for r in rows)),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


#: segment_mean's rows: (B, F, D), the first two layer 0's aggregations
#: per training step over an (8192, 1024) table; then fanouts across the
#: kernel's batch of 8 neighbours (1, 3, 9, 33), a 1000-wide row (16-byte
#: loads) and a 1001-wide one (the scalar path)
SEGMENT_MEAN_CASES = ((512, 10, 1024), (5120, 5, 1024), (512, 1, 1024),
                      (512, 3, 1024), (512, 9, 1024), (512, 33, 1024),
                      (512, 10, 1000), (512, 10, 1001))


def kernel_segment_mean(torch, timer, gen):
    """SEGMENT_MEAN_CASES in f32 and bf16 over 8192-row tables, within 1e-6
    (f32) and 2e-2 (bf16) of the plain version; the main path's numbers
    are the first two cases in f32."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    N = 8192
    tables = {D: torch.randn((N, D), generator=gen, device="cuda")
              for D in sorted({c[2] for c in SEGMENT_MEAN_CASES})}
    main = []
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        for B, Fo, D in SEGMENT_MEAN_CASES:
            feats = tables[D].to(dtype)
            idx = torch.randint(0, N, (B, Fo), generator=gen, device="cuda",
                                dtype=torch.int32)
            out = ops.segment_mean(idx, feats)
            want = ref.segment_mean_ref(idx, feats)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            check(torch.allclose(out.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"segment_mean {dtype} ({B},{Fo},{D}) max_abs_err {err}")
            idx64 = idx.long()
            nbytes = (int(torch.unique(idx).numel()) * D
                      * feats.element_size()
                      + B * D * feats.element_size() + idx.numel() * 4)
            row = {"phase": "kernel", "name": "segment_mean",
                   "dtype": str(dtype).removeprefix("torch."),
                   "shape": [B, Fo, N, D], "max_abs_err": err,
                   "kernel_ms": timer(lambda: ops.segment_mean(idx, feats)),
                   "plain_ms": timer(
                       lambda: ref.segment_mean_ref(idx, feats)),
                   "library_ms": timer(lambda: F.embedding_bag(
                       idx64, feats, mode="mean")),
                   **bound(nbytes, flops=B * Fo * D + B * D)}
            emit(row)
            if dtype == torch.float32 and len(main) < 2:   # the main path's
                main.append(row)
            del feats
    return summary(main)


def kernel_tiered_gather(torch, timer, gen):
    """B = 8192 requests, about half hits, over a 16384-line row store of
    1024-d f32 rows; then ragged widths and an odd B, exact."""
    from repro_torch.kernels import ops, ref
    main = None
    for B, L, D, dtype in ((8192, 16384, 1024, torch.float32),
                           (8191, 4096, 1000, torch.float32),
                           (1001, 512, 1001, torch.float32),
                           (1001, 512, 1001, torch.bfloat16)):
        cache = torch.randn((L, D), generator=gen, device="cuda").to(dtype)
        staged = torch.randn((B, D), generator=gen, device="cuda").to(dtype)
        slots = torch.randint(0, L, (B,), generator=gen, device="cuda",
                              dtype=torch.int32)
        miss = torch.rand((B,), generator=gen, device="cuda") < 0.5
        slots = slots.masked_fill(miss, -1)
        out = ops.tiered_gather(slots, cache, staged)
        want = ref.tiered_gather_ref(slots, cache, staged)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"tiered_gather ({B},{L},{D}) {dtype}")
        nbytes = 2 * B * D * cache.element_size() + B * 4
        row = {"phase": "kernel", "name": "tiered_gather",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": [B, L, D], "max_abs_err": 0.0,
               "kernel_ms": timer(lambda: ops.tiered_gather(slots, cache,
                                                            staged)),
               "plain_ms": timer(lambda: ref.tiered_gather_ref(slots, cache,
                                                               staged)),
               "library_ms": None, **bound(nbytes)}
        emit(row)
        main = main or summary([row])        # the first is the main path's
    return main


def kernel_tiered_gather_unique(torch, timer, gen):
    """One batch's expansion of a merged window: U = 28000 unique rows,
    about half hits in a 16384-line row store of 1024-d f32 rows, N = 8192
    output rows through a unique inverse; then a ragged width with an odd
    N, and bf16; exact."""
    from repro_torch.kernels import ops, ref
    main = None
    for U, L, D, N, dtype in ((28000, 16384, 1024, 8192, torch.float32),
                              (28000, 16384, 1000, 8191, torch.float32),
                              (28000, 16384, 1024, 8192, torch.bfloat16)):
        cache = torch.randn((L, D), generator=gen, device="cuda").to(dtype)
        staged = torch.randn((U, D), generator=gen, device="cuda").to(dtype)
        slots = torch.randint(0, L, (U,), generator=gen, device="cuda",
                              dtype=torch.int32)
        miss = torch.rand((U,), generator=gen, device="cuda") < 0.5
        slots = slots.masked_fill(miss, -1)
        # a batch's rows are distinct unique rows of its window
        inverse = torch.randperm(U, generator=gen, device="cuda")[:N] \
            .to(torch.int32)
        out = ops.tiered_gather_unique(slots, cache, staged, inverse)
        want = ref.tiered_gather_unique_ref(slots, cache, staged, inverse)
        torch.cuda.synchronize()
        check(torch.equal(out, want),
              f"tiered_gather_unique ({U},{L},{D},{N}) {dtype}")
        nbytes = 2 * N * D * cache.element_size() + 8 * N
        row = {"phase": "kernel", "name": "tiered_gather_unique",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": [U, L, D, N], "max_abs_err": 0.0,
               "kernel_ms": timer(lambda: ops.tiered_gather_unique(
                   slots, cache, staged, inverse)),
               "plain_ms": timer(lambda: ref.tiered_gather_unique_ref(
                   slots, cache, staged, inverse)),
               "library_ms": None, **bound(nbytes)}
        emit(row)
        main = main or summary([row])        # the first is the main path's
    return main


def kernel_frontier_gather(torch, timer, gen):
    """The two hops of one batch on the topology plane: hop 1 (P = 830
    unique pages, N = 15070 reads) and hop 0 (P = 210, N = 2950) over the
    H = 278 hot pages of 1024 int32 words, about a third of the pages hot;
    then int64 words and a zero-budget store (one dummy hot row, every slot
    -1); exact.  Bytes count what the reads need: inverse and offset per
    read, one slot per page, each distinct word once, the output."""
    from repro_torch.kernels import ops, ref
    rows = []
    for H, P, N, dtype in ((278, 830, 15070, torch.int32),
                           (278, 210, 2950, torch.int32),
                           (278, 830, 15070, torch.int64),
                           (1, 830, 15070, torch.int32)):
        W = 1024
        hot = torch.randint(0, 1 << 30, (H, W), generator=gen,
                            device="cuda").to(dtype)
        staged = torch.randint(0, 1 << 30, (P, W), generator=gen,
                               device="cuda").to(dtype)
        slots = torch.randint(0, H, (P,), generator=gen, device="cuda",
                              dtype=torch.int32)
        if H == 1:
            slots.fill_(-1)
        else:
            slots = slots.masked_fill(
                torch.rand((P,), generator=gen, device="cuda") < 0.66, -1)
        inverse = torch.randint(0, P, (N,), generator=gen, device="cuda",
                                dtype=torch.int32)
        offsets = torch.randint(0, W, (N,), generator=gen, device="cuda",
                                dtype=torch.int32)
        args = (slots, hot, staged, inverse, offsets)
        out = ops.tiered_frontier_gather(*args)
        want = ref.frontier_gather_ref(*args)
        torch.cuda.synchronize()
        check(out.dtype == dtype and torch.equal(out, want),
              f"frontier_gather ({H},{P},{N}) {dtype}")
        w = hot.element_size()
        words = int(torch.unique(inverse.long() * W + offsets).numel())
        nbytes = N * 8 + P * 4 + words * w + N * w
        row = {"phase": "kernel", "name": "frontier_gather",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": [H, W, P, N], "max_abs_err": 0.0,
               "kernel_ms": timer(lambda: ops.tiered_frontier_gather(*args)),
               "plain_ms": timer(lambda: ref.frontier_gather_ref(*args)),
               "library_ms": None, **bound(nbytes)}
        emit(row)
        rows.append(row)
    return summary(rows[:2])                 # the two hops of one batch


def pcie_h2d_gbps(torch) -> float:
    """The card's pinned host-to-device copy rate in GB/s: the median of 5
    CUDA-event timed copies of 256 MB."""
    n = 256 << 20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return n / (statistics.median(times[1:]) * 1e-3) / 1e9


def _hop_positions(np, graph):
    """The edge positions of one batch's two hops, as the sampler hands
    them to `frontier_gather`: 512 seeds, fanouts (10, 5)."""
    from repro_torch.sampling.neighbor import run_sample_hops
    rng = np.random.default_rng(0)
    seeds = rng.choice(graph.num_nodes, FULL["batch"], replace=False)
    hops = []

    def read(pos):
        hops.append(pos)
        return graph.indices[pos]
    run_sample_hops(graph, seeds, (10, 5), rng, read_words=read)
    return hops


def kernel_frontier_read(torch, timer, np):
    """One batch's two hops through real topology stores over phase 3's
    graph (100k nodes, 1,136,958 edges): hop 1 (5120 x 5 positions) and
    hop 0 (512 x 10) on phase 4's store (degree admission, 0.25 hbm / 0.5
    host); then hop 1 with int64 words (512-word pages), on a store with no
    hot page (all cold) and on one with every page hot.  Exact against the
    plain version (on the card, the host words copied to the card) and
    against graph.indices.  `call_ms` is the host clock around the store's whole
    `frontier_gather` call (H2D, launch, D2H), median of 20.  The bound
    counts device-memory bytes (each position, page-table entry and
    distinct hot word read once, each word written once) at 3.35 TB/s and
    the distinct 32-byte sectors of the host words read over PCIe at the
    link's peak (PCIE_H2D_BYTES_PER_S), and takes the larger; the run's
    own pinned H2D copy rate is printed beside it.  Also shows that the
    C entry point refuses pageable host memory (cudaErrorInvalidValue, 1)
    and returns the device mapping of pinned memory."""
    import ctypes
    import dataclasses
    from repro_torch.core.topology import TieredTopologyStore
    from repro_torch.graph.synthetic import rmat_graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import tiered_gather as ttg
    gbps = pcie_h2d_gbps(torch)
    emit({"phase": "kernel", "name": "pcie_h2d", "pcie_h2d_gbps": gbps})
    graph = rmat_graph(FULL["nodes"], 12, FULL["dim"], seed=0)
    wide = dataclasses.replace(graph, indices=graph.indices.astype(np.int64))
    hop0, hop1 = _hop_positions(np, graph)
    cases = (("hop1", graph, 0.25, 0.5, hop1), ("hop0", graph, 0.25, 0.5, hop0),
             ("hop1_int64", wide, 0.25, 0.5, hop1),
             ("hop1_all_cold", graph, 0.0, 0.5, hop1),
             ("hop1_all_hot", graph, 1.0, 0.0, hop1))
    rows = []
    for case, g, gpu, host, pos_np in cases:
        store = TieredTopologyStore.from_graph(
            g, gpu_fraction=gpu, host_fraction=host, device="cuda")
        table, hot, words = store.page_table, store.hot_pages(), \
            store.host_words()
        check(words.is_pinned(),
              f"frontier_read {case}: host words not pinned")
        pos = torch.from_numpy(pos_np.reshape(-1)).cuda()
        want_np = g.indices[pos_np.reshape(-1)]
        words_dev = words.cuda()
        out = ops.frontier_read(pos, table, hot, words)
        want = ref.frontier_read_ref(pos, table, hot, words_dev)
        torch.cuda.synchronize()
        check(out.dtype == want.dtype and torch.equal(out, want)
              and np.array_equal(out.cpu().numpy(), want_np),
              f"frontier_read {case}")
        check(np.array_equal(store.frontier_gather(pos_np),
                             g.indices[pos_np]),
              f"frontier_read {case}: the store's call")
        W, w = store.page_words, hot.element_size()
        page = pos // W
        s = table[page].long()
        hot_words = int(torch.unique((s * W + pos % W)[s >= 0]).numel())
        sectors = int(torch.unique(pos[s < 0] * w // 32).numel())
        hbm_bytes = (pos.numel() * 8 + int(torch.unique(page).numel()) * 4
                     + hot_words * w + pos.numel() * w)
        hbm_ms = hbm_bytes / HBM_BYTES_PER_S * 1e3
        pcie_ms = sectors * 32 / PCIE_H2D_BYTES_PER_S * 1e3
        for _ in range(WARMUP):
            store.frontier_gather(pos_np)
        row = {"phase": "kernel", "name": "frontier_read", "case": case,
               "dtype": str(hot.dtype).removeprefix("torch."),
               "shape": [pos.numel(), W, hot.shape[0], words.shape[0]],
               "cold_reads": int((s < 0).sum()), "max_abs_err": 0.0,
               "kernel_ms": timer(lambda: ops.frontier_read(pos, table, hot,
                                                            words)),
               "plain_ms": timer(lambda: ref.frontier_read_ref(
                   pos, table, hot, words_dev)),
               "call_ms": host_ms(lambda: store.frontier_gather(pos_np),
                                  lambda: (), reps=REPS),
               "library_ms": None, "bytes": hbm_bytes,
               "pcie_sectors": sectors, "pcie_h2d_gbps": gbps,
               "hbm_bound_ms": hbm_ms, "pcie_bound_ms": pcie_ms,
               "bound_ms": max(hbm_ms, pcie_ms), "bound_by": "bytes",
               "bound_link": "hbm" if hbm_ms >= pcie_ms else "pcie"}
        emit(row)
        rows.append(row)
        del store, words_dev
    # the device mapping: pinned memory has one, pageable memory none
    fn = _build.function("frontier_gather", "frontier_mapped_pointer",
                         (_build.P, ctypes.POINTER(ctypes.c_void_p)))
    pageable = np.zeros(1 << 16, np.int32)
    err = fn(pageable.ctypes.data, ctypes.byref(ctypes.c_void_p()))
    pinned = torch.zeros(1 << 16, dtype=torch.int32, pin_memory=True)
    check(err == 1 and ttg.mapped_pointer(pinned) != 0,
          f"frontier_mapped_pointer returned {err} for pageable memory")
    emit({"phase": "kernel", "name": "frontier_read", "case": "mapping",
          "pageable_refused_with": err})
    main = summary(rows[:2])                 # the two hops of one batch
    main.update({"call_ms": rows[0]["call_ms"] + rows[1]["call_ms"],
                 "pcie_h2d_gbps": gbps})
    return main


def kernel_store_fill(torch, timer, gen):
    """The row-store fill of one step: about 30% of 16384 lines refilled
    from an (8192, 1024) f32 staged buffer, in place, exact."""
    from repro_torch.kernels import ops, ref
    L, B, D = 16384, 8192, 1024
    rows = torch.randn((L, D), generator=gen, device="cuda")
    staged = torch.randn((B, D), generator=gen, device="cuda")
    filler = torch.randint(0, B, (L,), generator=gen, device="cuda",
                           dtype=torch.int32)
    keep = torch.rand((L,), generator=gen, device="cuda") >= 0.3
    last_filler = filler.masked_fill(keep, -1)
    got, want = rows.clone(), rows.clone()
    ops.store_fill(got, last_filler, staged)
    ref.store_fill_ref(want, last_filler, staged)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "store_fill")
    n_filled = int((last_filler >= 0).sum())
    nbytes = 2 * n_filled * D * 4 + L * 4
    row = {"phase": "kernel", "name": "store_fill", "dtype": "float32",
           "shape": [L, B, D], "filled": n_filled, "max_abs_err": 0.0,
           "kernel_ms": timer(lambda r: ops.store_fill(r, last_filler, staged),
                              setup=lambda: (rows.clone(),)),
           "plain_ms": timer(lambda r: ref.store_fill_ref(r, last_filler,
                                                          staged),
                             setup=lambda: (rows.clone(),)),
           "library_ms": None, **bound(nbytes)}
    emit(row)
    return summary([row])


def _clone_state(state, device):
    return type(state)(*(t.clone().to(device) for t in state))


def _hot_ids(torch, num_sets, hot_sets, n):
    """The first n ids that hash into sets 0 .. hot_sets - 1 (hashed on
    the card)."""
    from repro_torch.core import cache_device as cd
    cand = torch.arange(1 << 25, device="cuda")
    ids = cand[cd._set_of(cand, num_sets) < hot_sets][:n]
    check(ids.numel() == n, f"only {ids.numel()} ids hash into {hot_sets} sets")
    return ids.to(torch.int32).cpu().numpy()


def kernel_cache_access(torch, timer, np, B=8192, id_range=40_000,
                        hot_sets=None):
    """B requests into 2048 sets x 8 ways over three rounds that repeat ids
    under window pinning (duplicates and -1 pads in the last), exact
    against access_ref on CPU tensors.  B = 8192 is one batch of the first
    path, B = 28000 one merged window's unique ids on the second.  With
    `hot_sets`, every id hashes into that many sets (drawn from 4 x B ids
    that do, with duplicates and 2 % -1 pads in every round): the serial
    walk of a hot set.  The bucketing pass (`cache_bucket`) is also held
    and timed on its own against `bucket_by_set_ref` on the card; its time
    is part of cache_access's."""
    from repro_torch.core import cache_device as cd
    lines, ways = 16384, 8
    num_sets = lines // ways
    rng = np.random.default_rng(7)
    gpu = cd.init_cache(lines, ways, device="cuda")
    cpu = cd.init_cache(lines, ways, device="cpu")
    pool = (_hot_ids(torch, num_sets, hot_sets, 4 * B) if hot_sets
            else np.arange(id_range, dtype=np.int32))
    prev = rng.choice(pool, B, replace=False)
    for rnd in range(3):
        fresh = rng.choice(pool, B, replace=False)
        ids = np.where(rng.random(B) < 0.5, prev, fresh).astype(np.int32)
        if rnd == 2 or hot_sets:
            ids[rng.random(B) < 0.02] = -1
            ids[:64] = ids[64:128]
        fc = rng.integers(0, 3, B).astype(np.int32)
        window = np.unique(rng.choice(ids, B // 2)).astype(np.int32)
        for st in (gpu, cpu):
            cd.push_window(st, torch.from_numpy(window).to(st.tags.device))
        ids_t, fc_t = torch.from_numpy(ids), torch.from_numpy(fc)
        snap_gpu = _clone_state(gpu, "cuda")
        snap_cpu = _clone_state(cpu, "cpu")
        got = cd.access(gpu, ids_t.cuda(), fc_t.cuda())
        want = cd.access(cpu, ids_t, fc_t)
        torch.cuda.synchronize()
        for field, a, b in zip(got._fields, got, want):
            check(torch.equal(a.cpu(), b), f"cache_access round {rnd} {field}")
        for field, a, b in zip(gpu._fields, gpu, cpu):
            check(torch.equal(a.cpu(), b), f"cache_access round {rnd} {field}")
        prev = ids
    check(int(cpu.hits) > 0, "cache_access: the rounds never hit")
    ids_d, fc_d = ids_t.cuda(), fc_t.cuda()
    nbytes = B * 8 + lines * 4 * 4 + lines * 4 + B * 9 + lines * 4 + 24
    row = {"phase": "kernel", "name": "cache_access", "dtype": "int32",
           "shape": [B, num_sets, ways], "hot_sets": hot_sets,
           "max_abs_err": 0.0,
           "hits": int(cpu.hits), "misses": int(cpu.misses),
           "bypasses": int(cpu.bypasses),
           "largest_bucket": int(np.bincount(
               cd._set_of(ids_t[ids_t >= 0], num_sets).numpy()).max()),
           "kernel_ms": timer(lambda st: cd.access(st, ids_d, fc_d),
                              setup=lambda: (_clone_state(snap_gpu, "cuda"),)),
           "plain_ms": host_ms(lambda st: cd.access(st, ids_t, fc_t),
                               setup=lambda: (_clone_state(snap_cpu, "cpu"),)),
           "plain_on": "host CPU (access_ref is a Python loop)",
           "library_ms": None, **bound(nbytes)}
    emit(row)
    order, start = cd.bucket_by_set(ids_d, num_sets)
    want_order, want_start = cd.bucket_by_set_ref(ids_d, num_sets)
    torch.cuda.synchronize()
    check(torch.equal(order, want_order) and torch.equal(start, want_start),
          f"cache_bucket B {B} hot_sets {hot_sets}")
    bucket = {"phase": "kernel", "name": "cache_bucket", "dtype": "int32",
              "shape": [B, num_sets], "hot_sets": hot_sets,
              "max_abs_err": 0.0,
              "kernel_ms": timer(lambda: cd.bucket_by_set(ids_d, num_sets)),
              "plain_ms": timer(lambda: cd.bucket_by_set_ref(ids_d,
                                                             num_sets)),
              "library_ms": None,
              **bound(B * 4 + B * 4 + (num_sets + 2) * 4)}
    emit(bucket)
    return summary([row]), summary([bucket])


def cache_bucket_limit(torch) -> None:
    """cache_bucket at the largest set count its wrapper accepts (the
    histogram and the key tile fill a block's 227 KB of shared memory),
    exact against bucket_by_set_ref; one set more, the C entry point
    refuses with cudaErrorInvalidValue (1) before it launches."""
    from repro_torch.core import cache_device as cd
    from repro_torch.kernels import _build
    ids = torch.arange(-64, 4096, dtype=torch.int32, device="cuda")
    order, start = cd.bucket_by_set(ids, cd._MAX_SETS)
    want_order, want_start = cd.bucket_by_set_ref(ids, cd._MAX_SETS)
    torch.cuda.synchronize()
    check(torch.equal(order, want_order) and torch.equal(start, want_start),
          f"cache_bucket at {cd._MAX_SETS} sets")
    over = cd._MAX_SETS + 1
    scratch = torch.empty(ids.numel() + 5 * (over + 1), dtype=torch.int32,
                          device="cuda")
    start = torch.empty(over + 2, dtype=torch.int32, device="cuda")
    P, I = _build.P, _build.I
    fn = _build.function("cache_access", "cache_bucket",
                         (P, I, I, P, P, P, P))
    err = fn(ids.data_ptr(), ids.numel(), over, scratch.data_ptr(),
             order.data_ptr(), start.data_ptr(), _build.stream(ids))
    check(err == 1, f"cache_bucket at {over} sets returned {err}, not 1")
    emit({"phase": "kernel", "name": "cache_bucket", "case": "set_limit",
          "accepted_sets": cd._MAX_SETS, "refused_sets": over,
          "refused_with": err})


def _visible(torch, B, Sq, Sk, causal, window, offsets):
    """(B, Sq, Sk) mask of the (query, key) pairs attention computes, query
    i of sequence b at position offsets[b] + i."""
    q_pos = (torch.arange(Sq, device="cuda")[None, :, None]
             + offsets.long()[:, None, None])
    k_pos = torch.arange(Sk, device="cuda")[None, None, :]
    ok = torch.ones((B, Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


#: (row name, B, H, KV, Sq, Sk, hd, causal, window, dtypes); the sweep of
#: tests/test_kernels.py:124-129, then the serving path's shapes
FLASH_CASES = (
    [(f"sweep_{n}", *c, ("float32", "bfloat16")) for n, c in (
        ("mha", (2, 4, 4, 128, 128, 64, True, None)),
        ("gqa", (2, 8, 2, 128, 128, 64, True, None)),
        ("mqa", (1, 4, 1, 256, 256, 128, True, None)),
        ("window", (2, 4, 2, 128, 128, 64, True, 32)),
        ("padded", (2, 4, 4, 100, 164, 64, False, None)),
        ("long_kv", (1, 2, 2, 64, 512, 64, True, None)))]
    + [("prefill", 1, 12, 2, 1024, 2048, 128, True, None,
        ("bfloat16", "float32")),
       ("decode", 8, 12, 2, 1, 2048, 128, True, None,
        ("bfloat16", "float32")),
       ("window_danube", 1, 32, 8, 8192, 8192, 80, True, 4096,
        ("bfloat16", "float32")),
       # split-KV edges: offsets 0 (one visible row) and Sk - 1, so most
       # splits are empty; one sequence, every split of one kv head busy
       ("decode_edge", 8, 12, 2, 1, 2048, 128, True, None,
        ("bfloat16", "float32")),
       ("decode_b1", 1, 12, 2, 1, 2048, 128, True, None,
        ("bfloat16", "float32")),
       # the tensor-core path at the small head dims and a ragged Sq
       ("prefill_hd16", 2, 4, 2, 1000, 1000, 16, True, None, ("bfloat16",)),
       ("prefill_hd32", 2, 8, 2, 1000, 1100, 32, True, None, ("bfloat16",)),
       ("prefill_ragged", 1, 12, 2, 1000, 2048, 128, True, None,
        ("bfloat16",))])

#: flash_attention's gate per dtype: allclose's rtol = atol, and the
#: largest error of one output row relative to its reference row
FLASH_TOL = {"float32": 3e-4, "bfloat16": 3e-2}
FLASH_ROW_REL = {"float32": 1e-4, "bfloat16": 1e-2}

#: per-sequence offsets of the decode rows, read through the cache's view
DECODE_OFFSETS = {
    "decode": lambda torch, B, Sk: torch.linspace(64, 1900, B, device="cuda"),
    "decode_edge": lambda torch, B, Sk: torch.tensor([0.0, Sk - 1] * (B // 2),
                                                     device="cuda"),
    "decode_b1": lambda torch, B, Sk: torch.full((B,), Sk - 1.0,
                                                 device="cuda")}


def _flash_inputs(torch, gen, case, dtype):
    """q, k, v and the keyword arguments of one FLASH_CASES row; the decode
    rows read K/V through the transposed view of the cache's (B, S, KV, hd)
    layout, at their per-sequence offsets."""
    name, B, H, KV, Sq, Sk, hd, causal, window, _ = case
    offsets = None
    if name in DECODE_OFFSETS:
        cache_k = torch.randn((B, Sk, KV, hd), generator=gen,
                              device="cuda").to(dtype)
        cache_v = torch.randn((B, Sk, KV, hd), generator=gen,
                              device="cuda").to(dtype)
        k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda"
                        ).to(dtype).transpose(1, 2)
        offsets = DECODE_OFFSETS[name](torch, B, Sk).round().to(torch.int32)
    else:
        q = torch.randn((B, H, Sq, hd), generator=gen,
                        device="cuda").to(dtype)
        k = torch.randn((B, KV, Sk, hd), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((B, KV, Sk, hd), generator=gen,
                        device="cuda").to(dtype)
    return q, k, v, dict(causal=causal, window=window, q_offset=offsets)


def _flash_errors(torch, out, want) -> dict:
    """The two readings of the flash_attention gate: the largest absolute
    error, held to FLASH_TOL by allclose, and the largest error of one
    output row relative to that row, ||out - want|| / ||want|| over hd,
    held to FLASH_ROW_REL.  The second scales with the output: with
    N(0, 1) inputs a row that sees n keys has elements of about
    sqrt(e / n), 0.026 at a 4096-key window, which a 3e-2 allclose cannot
    tell from 0.  One bf16 rounding of a row is about 2e-3 of it; a key
    dropped or added at a band edge moves a row by about 1e-2 or more.  A
    row whose reference is 0 (nothing visible) must be 0."""
    dtype_name = str(want.dtype).removeprefix("torch.")
    d, w = out.float() - want.float(), want.float()
    row_rel = (d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max().item()
    tol = FLASH_TOL[dtype_name]
    return {"max_abs_err": d.abs().max().item(), "row_rel_err": row_rel,
            "allclose_ok": torch.allclose(out.float(), w, rtol=tol, atol=tol),
            "row_rel_ok": row_rel <= FLASH_ROW_REL[dtype_name]}


def kernel_flash_attention(torch, timer, gen):
    """Each FLASH_CASES row against attention_ref: allclose 3e-4 in f32 and
    3e-2 in bf16, and every output row within 1e-4 (f32) or 1e-2 (bf16) of
    its reference row in norm (`_flash_errors`).
    "decode" is one decode tick of the serving path: 8 slots at offsets
    spread over 64-1900 of a 2048-row cache, read through the transposed
    view of its (B, S, KV, hd) layout.  Bytes count q and o once and the
    K/V rows some query sees once; operations count 4 hd per visible
    (query, key) pair per head, at the input type's peak rate.  The
    library yardstick is scaled_dot_product_attention with GQA (an explicit
    mask where offsets or a window apply)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    rows = {}
    for case in FLASH_CASES:
        name, B, H, KV, Sq, Sk, hd, causal, window, dtypes = case
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            q, k, v, kw = _flash_inputs(torch, gen, case, dtype)
            offsets = kw["q_offset"]
            out = ops.flash_attention(q, k, v, **kw)
            want = ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            errs = _flash_errors(torch, out, want)
            err = errs["max_abs_err"]
            check(errs["allclose_ok"] and errs["row_rel_ok"],
                  f"flash_attention {name} {dtype_name} max_abs_err {err} "
                  f"row_rel_err {errs['row_rel_err']}")
            del want
            zero = torch.zeros(B, dtype=torch.int32, device="cuda")
            seen = _visible(torch, B, Sq, Sk, causal, window,
                            offsets if offsets is not None else zero)
            pairs = int(seen.sum())
            kv_rows = int(seen.any(dim=1).sum())
            el = q.element_size()
            nbytes = 2 * q.numel() * el + 2 * kv_rows * KV * hd * el
            flops = 4 * pairs * hd * H
            rate = (F32_FLOPS_PER_S if dtype == torch.float32
                    else BF16_FLOPS_PER_S)
            if offsets is None and window is None:
                mask, is_causal = None, causal
            else:
                mask, is_causal = seen[:, None], False
            del seen
            reps = 5 if name == "window_danube" else REPS
            row = {"phase": "kernel", "name": "flash_attention",
                   "case": name, "dtype": dtype_name,
                   "shape": [B, H, KV, Sq, Sk, hd], "causal": causal,
                   "window": window, "max_abs_err": err,
                   "row_rel_err": errs["row_rel_err"], "pairs": pairs,
                   "kernel_ms": timer(lambda: ops.flash_attention(
                       q, k, v, **kw)),
                   "plain_ms": timer(lambda: ref.attention_ref(
                       q, k, v, **kw), reps=reps),
                   "library_ms": timer(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, is_causal=is_causal,
                       enable_gqa=True), reps=reps),
                   **bound(nbytes, flops, rate)}
            emit(row)
            rows[(name, dtype_name)] = row
            del q, k, v, out, mask
    torch.cuda.empty_cache()
    # the serving path's numbers: one decode tick's launch, and beside it
    # one prefill launch at a 1024-token prompt
    main = summary([rows[("decode", "bfloat16")]])
    pre = rows[("prefill", "bfloat16")]
    main.update({"prefill_ms": pre["kernel_ms"],
                 "prefill_bound_ms": pre["bound_ms"],
                 "prefill_bound_by": pre["bound_by"],
                 "prefill_plain_ms": pre["plain_ms"],
                 "prefill_library_ms": pre["library_ms"],
                 "max_abs_err": max(r["max_abs_err"] for r in rows.values())})
    return main


#: faults that `--plant-fault` builds into a copy of flash_attention.cu, as
#: (old, new) text in flash_mma_kernel, the bf16 tensor-core path: the
#: partial kv tile at the lower (window) edge of a q-tile's band dropped,
#: and the lower edge of the unmasked-tile shortcut 4 keys too early
FAULTS = {
    "band_edge": ("const int kt_begin = lo / kBK,",
                  "const int kt_begin = (lo + kBK - 1) / kBK,"),
    "full_lo": ("max(0, wq_hi - p.window + 1)",
                "max(0, wq_hi - p.window - 3)"),
}


def _variant_libs(tmp: Path, kernel: str, sources: dict) -> dict:
    """Build each {name: text} copy of csrc/<kernel>.cu into `tmp`, one nvcc
    each, all started together; returns {name: ctypes.CDLL}."""
    import ctypes
    from repro_torch.kernels import _build
    jobs = {}
    for name, text in sources.items():
        (tmp / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp / f"{name}.so"),
             str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, job in jobs.items():
        log = job.communicate()[0]
        check(job.returncode == 0, f"nvcc failed on {kernel} {name}:\n{log}")
    return {name: ctypes.CDLL(str(tmp / f"{name}.so")) for name in jobs}


#: segment_mean.cu's warp-to-work order and batch choice, and what
#: `--segment-mean-variants` puts in their place: the shipped kernel takes
#: 512-byte chunks column stripe by column stripe and batches 8 or 2
#: neighbours by grid size, and on the scalar path (a row width that is not
#: a multiple of 16 bytes) 2 neighbours of 64-column chunks; the variants
#: take the chunks row by row, batch 8 always, batch 2 always, row by row
#: with 8 over 1 KB chunks, or 32 or 128 scalar columns per chunk; `block`
#: is the block-per-destination kernel the shipped one replaced (a whole
#: source, csrc/variants/segment_mean_block.cu)
_CHUNK_MAJOR = ("const int64_t b = w % B;                               "
                "// chunk-major\n  const int g0 = static_cast<int>(w / B) "
                "* 32 * GROUPS + lane;")
_ROW_MAJOR = ("const int64_t b = w / chunks;\n  const int g0 = "
              "static_cast<int>(w % chunks) * 32 * GROUPS + lane;")
_ADAPTIVE = "if (deep) {"
_SCALAR = "return launch_as<T, 1, 2>("
SEGMENT_MEAN_VARIANTS = {
    "row_major": ((_CHUNK_MAJOR, _ROW_MAJOR),),
    "batch_8": ((_ADAPTIVE, "if (true) {"),),
    "batch_2": ((_ADAPTIVE, "if (false) {"),),
    "row_major_batch_8_1kb": (
        (_CHUNK_MAJOR, _ROW_MAJOR), (_ADAPTIVE, "if (true) {"),
        ("return launch_as<T, kVec, 1>(", "return launch_as<T, kVec, 2>(")),
    "scalar_32": ((_SCALAR, "return launch_as<T, 1, 1>("),),
    "scalar_128": ((_SCALAR, "return launch_as<T, 1, 4>("),),
    "block": "src/repro_torch/kernels/csrc/variants/segment_mean_block.cu",
}


def segment_mean_variants(torch) -> int:
    """Times the shipped segment_mean kernel beside SEGMENT_MEAN_VARIANTS,
    built into a temporary directory, in turns on the same inputs at every
    SEGMENT_MEAN_CASES row over an 8192-row table, f32 and bf16, each held
    to the plain version (1e-6 f32, 2e-2 bf16).  Returns 0 if every variant
    agrees with the plain version."""
    import shutil
    import tempfile
    from repro_torch.kernels import _build, ops, ref
    source = (ROOT / SOURCES["segment_mean"][0]).read_text()
    texts = {}
    for name, edits in SEGMENT_MEAN_VARIANTS.items():
        if isinstance(edits, str):
            texts[name] = (ROOT / edits).read_text()
            continue
        text = source
        for old, new in edits:
            check(text.count(old) == 1, f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        texts[name] = text
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_variants_"))
    ok = True
    try:
        sound = _build.library("segment_mean")
        libs = {"shipped": sound, **_variant_libs(tmp, "segment_mean", texts)}
        timer = Timer(torch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        tables = {D: torch.randn((8192, D), generator=gen, device="cuda")
                  for D in sorted({c[2] for c in SEGMENT_MEAN_CASES})}
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            for B, Fo, D in SEGMENT_MEAN_CASES:
                feats = tables[D].to(dtype)
                idx = torch.randint(0, 8192, (B, Fo), generator=gen,
                                    device="cuda", dtype=torch.int32)
                want = ref.segment_mean_ref(idx, feats)
                row = {"phase": "segment_mean_variants",
                       "dtype": str(dtype).removeprefix("torch."),
                       "shape": [B, Fo, 8192, D]}
                # in turns: shipped, variants, shipped again
                for name in ("shipped", *texts, "shipped_again"):
                    _build._libs["segment_mean"] = libs[
                        name.removesuffix("_again")]
                    out = ops.segment_mean(idx, feats)
                    torch.cuda.synchronize()
                    agrees = torch.allclose(out.float(), want.float(),
                                            rtol=tol, atol=tol)
                    ok &= agrees
                    row[name] = {"ms": timer(
                        lambda: ops.segment_mean(idx, feats)),
                        "agrees": agrees}
                emit(row)
                del feats
        _build._libs["segment_mean"] = sound
    finally:
        shutil.rmtree(tmp)
    return 0 if ok else 1


def plant_fault(torch, fault: str) -> int:
    """Shows that phase 2's flash_attention gate rejects FAULTS[fault]: the
    faulty source is built into a temporary directory beside the sound
    one, and every bf16 FLASH_CASES row runs through both libraries on the
    same inputs against attention_ref.  Prints both readings per row (and
    whether allclose and the row-relative test pass); returns 0 if the
    gate passes the sound kernel on every row and rejects the fault on
    some row, else 1."""
    import shutil
    import tempfile
    from repro_torch.kernels import _build, ops, ref
    old, new = FAULTS[fault]
    source = (ROOT / SOURCES["flash_attention"][0]).read_text()
    check(source.count(old) == 1,
          f"--plant-fault {fault}: {old!r} is not in the source once")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fault_"))
    try:
        libs = {"sound": _build.library("flash_attention"),
                **_variant_libs(tmp, "flash_attention",
                                {fault: source.replace(old, new)})}
        gen = torch.Generator(device="cuda").manual_seed(0)
        sound_ok, caught = True, []
        for case in FLASH_CASES:
            if "bfloat16" not in case[-1]:
                continue
            q, k, v, kw = _flash_inputs(torch, gen, case, torch.bfloat16)
            want = ref.attention_ref(q, k, v, **kw)
            row = {"phase": "plant_fault", "case": case[0]}
            for lib_name, lib in libs.items():
                _build._libs["flash_attention"] = lib
                row[lib_name] = _flash_errors(
                    torch, ops.flash_attention(q, k, v, **kw), want)
            emit(row)
            sound_ok &= row["sound"]["allclose_ok"] and \
                row["sound"]["row_rel_ok"]
            if not (row[fault]["allclose_ok"] and row[fault]["row_rel_ok"]):
                caught.append(case[0])
            del q, k, v, want
        _build._libs["flash_attention"] = libs["sound"]
    finally:
        shutil.rmtree(tmp)
    emit({"phase": "plant_fault", "fault": fault, "sound_passes": sound_ok,
          "rejected_in": caught})
    return 0 if sound_ok and caught else 1


def kernel_flash_combine(torch, timer, gen):
    """The split-KV merge at the decode row's shapes (B 8, H 12, KV 2, hd
    128, offsets 64-1900 of 2048, split_plan's splits): partials from
    `ref.flash_split_ref` on the card, then the combine kernel against
    `ref.flash_combine_ref` on the same partials, 1e-5 in f32 and 1e-2 in
    bf16 (one rounding of the output apart).  Bytes count the partials of
    the rows it reads and the output once."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, H, KV, Sk, hd = 8, 12, 2, 2048, 128
    q = torch.randn((B, H, 1, hd), generator=gen, device="cuda")
    k = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda")
    v = torch.randn((B, KV, Sk, hd), generator=gen, device="cuda")
    offsets = torch.linspace(64, 1900, B, device="cuda").round().to(
        torch.int32)
    splits, chunk = fa.split_plan(Sk, B, KV, torch.cuda.get_device_properties(
        0).multi_processor_count)
    ml, acc = ref.flash_split_ref(q, k, v, splits, chunk, q_offset=offsets)
    rows = []
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        out = torch.empty((B, H, 1, hd), dtype=dtype, device="cuda")
        fa.flash_combine(ml, acc, out)
        want = ref.flash_combine_ref(ml, acc, H, 1, dtype)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        check(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol),
              f"flash_combine {dtype} max_abs_err {err}")
        group = H // KV
        nbytes = (B * KV * splits * group * (2 + hd) * 4
                  + out.numel() * out.element_size())
        row = {"phase": "kernel", "name": "flash_combine",
               "dtype": str(dtype).removeprefix("torch."),
               "shape": [B, H, KV, splits, hd], "max_abs_err": err,
               "kernel_ms": timer(lambda: fa.flash_combine(ml, acc, out)),
               "plain_ms": timer(lambda: ref.flash_combine_ref(
                   ml, acc, H, 1, dtype)),
               "library_ms": None,
               **bound(nbytes, 2 * B * H * splits * hd)}
        emit(row)
        rows.append(row)
    return summary(rows[:1])                 # bf16: the serving path's


# -- phase 3 -------------------------------------------------------------------

def workload(torch, np):
    """The full-width graph, labels, features and model of
    examples/train_gnn_igb_torch.py, from seed 0."""
    from repro_torch.graph.synthetic import rmat_graph
    from repro_torch.models.gnn import GNN, GNNConfig
    rng = np.random.default_rng(0)
    dim = FULL["dim"]
    graph = rmat_graph(FULL["nodes"], 12, dim, seed=0, name="igb-synthetic")
    n_classes = 47
    labels_all = rng.integers(0, n_classes, graph.num_nodes)
    feats = (np.eye(n_classes, dim)[labels_all] * 2.0
             + 0.5 * rng.standard_normal((graph.num_nodes, dim))
             ).astype(np.float32)
    cfg = GNNConfig(model="sage", in_dim=dim, hidden_dim=FULL["hidden"],
                    num_classes=n_classes, fanouts=(10, 5))
    gnn = GNN(cfg, generator=torch.Generator().manual_seed(0), device=DEVICE)
    return graph, labels_all, feats, cfg, gnn


def main_path(torch, np):
    from repro_torch.core import INTEL_OPTANE, GIDSDataLoader, LoaderConfig
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.gnn import hop_indices, sgd_step

    t0 = time.perf_counter()
    graph, labels_all, feats, cfg, gnn = workload(torch, np)
    loader = GIDSDataLoader(
        graph, feats,
        LoaderConfig(batch_size=FULL["batch"], fanouts=cfg.fanouts,
                     data_plane="gids-device",
                     cache_lines=FULL["cache_lines"],
                     window_depth=8, cbuf_fraction=0.1),
        ssd=INTEL_OPTANE, device="cuda")
    tier = loader.store.tiers[0]
    host_feats = torch.from_numpy(feats).cuda()
    labels_dev = torch.from_numpy(labels_all).cuda()
    emit({"phase": "setup", "seconds": round(time.perf_counter() - t0, 3),
          "params": sum(p.numel() for p in gnn.parameters()),
          "edges": graph.num_edges})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    steps = []
    for step in range(STEPS):
        t_start = time.perf_counter()
        plan = loader.plan_next()
        t_planned = time.perf_counter()
        batch = loader.execute(plan)          # ends synchronised
        t_executed = time.perf_counter()
        split = dict(tier.last_split_ms)
        nodes = torch.from_numpy(batch.blocks.all_nodes).cuda()
        hi = [torch.from_numpy(i).cuda() for i in hop_indices(batch.blocks)]
        y = labels_dev[torch.from_numpy(batch.blocks.seeds).cuda()]
        if step == 0:
            # launches made to compare with the plain versions do not count
            saved = dict(_build.LAUNCHES)
            with torch.no_grad():
                loss_kernel = gnn.loss(batch.features, hi, y).item()
                with mock.patch.object(ops, "segment_mean",
                                       ref.segment_mean_ref):
                    loss_plain = gnn.loss(batch.features, hi, y).item()
            _build.LAUNCHES.update(saved)
            rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
            emit({"phase": "step0_parity", "loss_kernel": loss_kernel,
                  "loss_plain": loss_plain, "rel_err": rel})
            check(rel <= 1e-5, f"step-0 loss {loss_kernel} vs plain "
                               f"{loss_plain}")
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        loss = sgd_step(gnn, batch.features, hi, y, 0.05)
        ev1.record()
        loss_v = loss.item()
        t_end = time.perf_counter()
        check(isinstance(batch.features, torch.Tensor)
              and batch.features.is_cuda, "features left the device")
        check(torch.equal(batch.features, host_feats[nodes]),
              f"step {step}: features differ from host_features[all_nodes]")
        check(np.isfinite(loss_v), f"step {step}: loss {loss_v}")
        cache = tier.store.cache
        hits, misses = int(cache.hits), int(cache.misses)
        steps.append({"phase": "step", "step": step, "loss": loss_v,
              "unique_rows": int(len(batch.blocks.all_nodes)),
              "tier_counts": list(batch.report.tier_counts),
              "wall_ms": (t_end - t_start) * 1e3,
              "sample_ms": (t_planned - t_start) * 1e3,
              "execute_ms": (t_executed - t_planned) * 1e3,
              **{f"{k}_ms": v for k, v in split.items()},
              "train_ms": ev0.elapsed_time(ev1),
              "prep_time_s": batch.prep_time_s,
              "hit_ratio": hits / max(hits + misses, 1)})
        emit(steps[-1])
    check(hits > 0, "the device cache never hit")
    launches = dict(_build.LAUNCHES)
    # step 0 pays the first cuBLAS call and the parity check
    median = {k: statistics.median(s[k] for s in steps[1:])
              for k, v in steps[1].items()
              if k.endswith(("_ms", "_s")) and isinstance(v, float)}
    emit({"phase": "main_path", "plane": "gids-device", "steps": STEPS,
          "launches": launches,
          "median_of_steps_1_on": median,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    for name in PATH_KERNELS["gids-device"]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the gids-device path")
    return launches


MERGED_PLANE = "gids-device+merge_execute+topology"


def merged_topology_path(torch, np):
    """Phase 4: MERGED_STEPS training steps on the merged-window, topology
    plane over the device store, through `loader.next_batch()`."""
    from repro_torch.core import INTEL_OPTANE, GIDSDataLoader, LoaderConfig
    from repro_torch.core.dataplane import DataPlaneSpec
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.gnn import hop_indices, sgd_step

    t0 = time.perf_counter()
    graph, labels_all, feats, cfg, gnn = workload(torch, np)
    spec = DataPlaneSpec.preset("gids-device", merge_execute=True,
                                topology=True)
    loader = GIDSDataLoader(
        graph, feats,
        LoaderConfig(batch_size=FULL["batch"], fanouts=cfg.fanouts,
                     data_plane=spec, cache_lines=FULL["cache_lines"],
                     window_depth=8, cbuf_fraction=0.1),
        ssd=INTEL_OPTANE, device=DEVICE)
    topo, tier = loader.topo, loader.store.tiers[0]
    host_feats = torch.from_numpy(feats).to(DEVICE)
    labels_dev = torch.from_numpy(labels_all).to(DEVICE)
    emit({"phase": "setup", "plane": MERGED_PLANE,
          "seconds": round(time.perf_counter() - t0, 3),
          "edges": graph.num_edges, "edge_pages": topo.n_pages,
          "pages_by_tier": list(topo.tier_pages()),
          "hot_pages_bytes": topo.hot_pages().numel()
          * topo.hot_pages().element_size()})

    # every hop's word reads as the sampler makes them, each held against
    # graph.indices; hop_report sees the same hops' real edge reads
    hops = {"gathers": 0, "reports": 0, "reads": 0, "words": 0,
            "gather_ms": 0.0}
    call_ms = []                     # host clock of each frontier_gather
    frontier_gather, hop_report = topo.frontier_gather, topo.hop_report

    def checked_frontier_gather(pos):
        t = time.perf_counter()
        out = frontier_gather(pos)
        call_ms.append((time.perf_counter() - t) * 1e3)
        hops["gather_ms"] += call_ms[-1]
        check(np.array_equal(out, graph.indices[pos]),
              f"frontier_gather differs from graph.indices on hop "
              f"{hops['gathers']}")
        hops["gathers"] += 1
        hops["words"] += int(np.size(pos))
        return out

    def counted_hop_report(read_pos, **kw):
        hops["reports"] += 1
        hops["reads"] += len(read_pos)
        return hop_report(read_pos, **kw)

    # the first batch's rows also through the plain expansion on the same
    # inputs (not a launch), for the step-0 loss parity
    plain0 = []
    gather_unique = ops.tiered_gather_unique

    def gather_unique_and_plain(slots, cache, staged, inverse):
        out = gather_unique(slots, cache, staged, inverse)
        if not plain0:
            plain0.append(ref.tiered_gather_unique_ref(slots, cache, staged,
                                                       inverse))
        return out

    # host clock around each window's two stages
    windows = []
    plan_window, execute_window = loader.plan_window, loader.execute_window

    def timed_plan_window():
        t, g, n = time.perf_counter(), hops["gather_ms"], len(call_ms)
        plans = plan_window()
        windows.append({"sample_ms": (time.perf_counter() - t) * 1e3,
                        "sample_frontier_gather_ms": hops["gather_ms"] - g,
                        "frontier_calls": len(call_ms) - n,
                        "frontier_call_ms": statistics.median(call_ms[n:])})
        return plans

    def timed_execute_window(plans):
        t = time.perf_counter()
        batches = execute_window(plans)
        windows[-1]["execute_ms"] = (time.perf_counter() - t) * 1e3
        return batches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with mock.patch.object(topo, "frontier_gather", checked_frontier_gather), \
            mock.patch.object(topo, "hop_report", counted_hop_report), \
            mock.patch.object(loader, "plan_window", timed_plan_window), \
            mock.patch.object(loader, "execute_window",
                              timed_execute_window):
        _build.reset_launches()
        for step in range(MERGED_STEPS):
            n_windows = len(windows)
            t_start = time.perf_counter()
            if step == 0:
                with mock.patch.object(ops, "tiered_gather_unique",
                                       gather_unique_and_plain):
                    batch = loader.next_batch()
            else:
                batch = loader.next_batch()
            t_batch = time.perf_counter()
            if len(windows) > n_windows:
                plan = loader.store.last_plan
                w = windows[-1]
                w.update({f"{k}_ms": v for k, v in tier.last_split_ms.items()})
                report = batch.report
                w.update({"phase": "window", "window": len(windows) - 1,
                          "batches": report.window_batches,
                          "requests": report.window_requests,
                          "unique_rows": report.n_unique,
                          "duplicates": report.n_duplicate,
                          "storage_unique": report.n_storage_unique,
                          "storage_lines": report.n_storage_lines,
                          "unique_tier_counts": [
                              int(c) for c in plan.counts()]})
            nodes = torch.from_numpy(batch.blocks.all_nodes).to(DEVICE)
            hi = [torch.from_numpy(i).to(DEVICE) for i in hop_indices(batch.blocks)]
            y = labels_dev[torch.from_numpy(batch.blocks.seeds).to(DEVICE)]
            if step == 0:
                saved = dict(_build.LAUNCHES)
                check(len(plain0) == 1 and torch.equal(plain0[0],
                                                       batch.features),
                      "step 0: tiered_gather_unique differs from its plain "
                      "version on the path")
                with torch.no_grad():
                    loss_kernel = gnn.loss(batch.features, hi, y).item()
                    with mock.patch.object(ops, "segment_mean",
                                           ref.segment_mean_ref):
                        loss_plain = gnn.loss(plain0[0], hi, y).item()
                _build.LAUNCHES.update(saved)
                plain0.clear()
                rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
                emit({"phase": "step0_parity", "plane": MERGED_PLANE,
                      "loss_kernel": loss_kernel, "loss_plain": loss_plain,
                      "rel_err": rel})
                check(rel <= 1e-5, f"merged step-0 loss {loss_kernel} vs "
                                   f"plain {loss_plain}")
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            loss = sgd_step(gnn, batch.features, hi, y, 0.05)
            ev1.record()
            loss_v = loss.item()
            t_end = time.perf_counter()
            check(isinstance(batch.features, torch.Tensor)
                  and batch.features.device.type == DEVICE,
                  "features left the device")
            check(torch.equal(batch.features, host_feats[nodes]),
                  f"merged step {step}: features differ from "
                  f"host_features[all_nodes]")
            check(np.isfinite(loss_v), f"merged step {step}: loss {loss_v}")
            check(batch.sample_time_s > 0,
                  f"merged step {step}: no priced sampling time")
            steps.append({"phase": "step", "plane": MERGED_PLANE,
                          "step": step, "loss": loss_v,
                          "unique_rows": int(len(batch.blocks.all_nodes)),
                          "tier_counts": list(batch.report.tier_counts),
                          "batch_ms": (t_batch - t_start) * 1e3,
                          "train_ms": ev0.elapsed_time(ev1),
                          "wall_ms": (t_end - t_start) * 1e3,
                          "prep_time_s": batch.prep_time_s,
                          "sample_time_s": batch.sample_time_s,
                          "hop_reports": [
                              {"pages_by_tier": list(r.pages_by_tier),
                               "reads": r.n_edge_reads, "time_s": r.time_s}
                              for r in batch.blocks.hop_reports]})
            emit(steps[-1])
        launches = dict(_build.LAUNCHES)
    for w in windows:
        emit(w)
    check(len(windows) == 2, f"expected 2 merged windows, ran {len(windows)}")
    check(hops["gathers"] == hops["reports"] > 0,
          f"{hops['gathers']} frontier gathers for {hops['reports']} hops")
    hops["frontier_call_ms"] = statistics.median(call_ms)
    cache = tier.store.cache
    hits, misses = int(cache.hits), int(cache.misses)
    check(hits > 0, "the device cache never hit on the merged path")
    median = {k: statistics.median(s[k] for s in steps[1:])
              for k in ("train_ms", "wall_ms", "prep_time_s",
                        "sample_time_s")}
    emit({"phase": "main_path", "plane": MERGED_PLANE,
          "steps": MERGED_STEPS, "launches": launches, "hops": hops,
          "hit_ratio": hits / max(hits + misses, 1),
          "median_of_steps_1_on": median,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    for name in PATH_KERNELS[MERGED_PLANE]:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the merged path")
    check(launches["frontier_read"] == hops["gathers"],
          f"{launches['frontier_read']} frontier_read launches for "
          f"{hops['gathers']} hops (one per hop expected)")
    return launches


LM_PATH = "lm-serve"


def _greedy(torch, model, params, prompt, n, max_seq):
    """n tokens of single-request greedy decoding through `model`."""
    cache = model.init_cache(1, max_seq)
    tokens = torch.from_numpy(prompt[None, :]).to(DEVICE)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    toks = [int(logits[0, -1].argmax())]
    for pos in range(len(prompt), len(prompt) + n - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[toks[-1]]], dtype=torch.int32,
                                 device=DEVICE), cache,
            torch.tensor([pos], dtype=torch.int32, device=DEVICE))
        toks.append(int(logits[0, -1].argmax()))
    return toks


def lm_gate_f32(torch, np):
    """Phase 5, f32 gates at full width: flash against einsum logits, and
    engine tokens against single-request greedy decoding.  GATE["tol"] is
    the reference's own bound for decode against teacher forcing
    (tests/test_decode_consistency.py:47); in f32 the two paths differ only
    in summation order (online softmax, other matmul shapes)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.transformer import LM
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    base = dataclasses.replace(configs.get("qwen2_1_5b"),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    flash = LM(dataclasses.replace(base, attn_impl="flash"), device=DEVICE)
    einsum = LM(base, device=DEVICE)
    params = flash.init(torch.Generator(device=DEVICE).manual_seed(0))
    P, E = GATE["prompt"], GATE["steps"]
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (1, P + E))
                            .astype(np.int32)).to(DEVICE)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = einsum.forward(params, {"tokens": toks})[0]
        fwd_err = (flash.forward(params, {"tokens": toks})[0] - want
                   ).abs().max().item()
        cache = flash.init_cache(1, P + E)
        lg, cache = flash.prefill(params, {"tokens": toks[:, :P]}, cache)
        errs = [(lg[0, -1] - want[P - 1]).abs().max().item()]
        for t in range(E):
            lg, cache = flash.decode_step(
                params, toks[:, P + t:P + t + 1], cache,
                torch.tensor([P + t], dtype=torch.int32, device=DEVICE))
            errs.append((lg[0, 0] - want[P + t]).abs().max().item())
        check(bool(torch.isfinite(want).all()), "f32 gate: non-finite logits")
        scale = want[:, :base.vocab_size].abs().max().item()
    emit({"phase": "lm_gate_f32", "prompt": P, "decode_steps": E,
          "forward_max_abs_err": fwd_err, "decode_max_abs_err": max(errs),
          "logit_max_abs": scale, "tol": GATE["tol"],
          "seconds": time.perf_counter() - t0})
    check(fwd_err <= GATE["tol"] and max(errs) <= GATE["tol"],
          f"f32 gate: flash forward {fwd_err}, prefill+decode {max(errs)} "
          f"vs einsum forward (tol {GATE['tol']})")

    prompts = [rng.integers(0, base.vocab_size, n).astype(np.int32)
               for n in (7, 11, 5)]
    N = 6
    with torch.inference_mode():
        engine = ServeEngine(flash, params, EngineConfig(slots=2, max_seq=64),
                             device=DEVICE)
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=N))
        done = engine.run_until_drained()
        greedy = {i: _greedy(torch, flash, params, p, N, 64)
                  for i, p in enumerate(prompts)}
    got = {r.rid: r.generated for r in done}
    emit({"phase": "lm_engine_gate_f32", "engine": got, "greedy": greedy})
    check(got == greedy and engine.kv_slots.occupancy == 0.0,
          "f32 engine gate: engine tokens differ from greedy decoding")


def lm_serve_path(torch, np):
    """Phase 5, the main path: SERVE["requests"] requests at full width in
    bf16 through ServeEngine, every attention layer through
    flash_attention."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import LM
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    cfg = dataclasses.replace(configs.get("qwen2_1_5b"), attn_impl="flash")
    model = LM(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [params["embed"], params["final_norm"]["scale"]] + [
        t for g in params["stacks"][0]["b0"].values() for t in g.values()]
    n_params = sum(t.numel() for t in leaves)
    check(n_params == 1_546_270_208, f"qwen2-1.5b has {n_params} params")
    engine = ServeEngine(model, params,
                         EngineConfig(slots=SERVE["slots"],
                                      max_seq=SERVE["max_seq"]),
                         device=DEVICE)
    lengths = np.random.default_rng(0).integers(64, 1025, SERVE["requests"])
    rng = np.random.default_rng(1)
    for i, n in enumerate(lengths):
        engine.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=SERVE["new_tokens"]))
    emit({"phase": "lm_setup", "model": cfg.name, "params": n_params,
          "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
          "kv_cache_bytes": engine.kv_slots.capacity_bytes,
          "init_s": init_s, "prompt_lengths": [int(n) for n in lengths]})

    prefills, ticks, finite = [], [], []
    prefill, decode = engine._prefill, engine._decode
    decode_step, model_prefill = model.decode_step, model.prefill

    def timed_prefill(prompt):
        t = time.perf_counter()
        out = prefill(prompt)                 # ends synchronised (argmax)
        prefills.append({"prompt": len(prompt),
                         "ms": (time.perf_counter() - t) * 1e3})
        return out

    def timed_decode():
        t = time.perf_counter()
        out = decode()                        # ends synchronised (.cpu())
        ticks.append({"active": sum(r is not None for r in engine.active),
                      "ms": (time.perf_counter() - t) * 1e3})
        return out

    def checked(fn):
        def call(*args):
            logits, cache = fn(*args)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return call

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(engine, "_prefill", timed_prefill), \
            mock.patch.object(engine, "_decode", timed_decode), \
            mock.patch.object(model, "decode_step", checked(decode_step)), \
            mock.patch.object(model, "prefill", checked(model_prefill)):
        _build.reset_launches()
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_tokens = sum(len(r.generated) for r in done)
    for p in prefills:
        emit({"phase": "lm_prefill", **p})
    decode_ms = [t["ms"] for t in ticks]
    emit({"phase": "main_path", "plane": LM_PATH, "model": cfg.name,
          "requests": len(done), "tokens": n_tokens, "prefills": len(prefills),
          "decode_ticks": len(ticks), "launches": launches,
          "wall_s": wall_s, "tokens_per_s": n_tokens / wall_s,
          "prefill_ms_total": sum(p["ms"] for p in prefills),
          "decode_ms_total": sum(decode_ms),
          "decode_ms_median": statistics.median(decode_ms),
          "decode_ms_by_tick": decode_ms,
          "decode_tokens_per_s": sum(t["active"] for t in ticks)
          / (sum(decode_ms) / 1e3),
          "peak_mem_bytes": peak})
    check(len(done) == SERVE["requests"]
          and all(r.done and len(r.generated) == SERVE["new_tokens"]
                  for r in done),
          "lm serve: not every request retired with its tokens")
    check(engine.kv_slots.occupancy == 0.0, "lm serve: slots still held")
    check(bool(torch.stack(finite).all()), "lm serve: non-finite logits")
    want = cfg.num_layers * (len(prefills) + len(ticks))
    check(len(prefills) == SERVE["requests"]
          and launches["flash_attention"] == want,
          f"lm serve: {launches['flash_attention']} flash_attention launches,"
          f" expected {cfg.num_layers} x ({len(prefills)} prefills + "
          f"{len(ticks)} decode ticks) = {want}")
    check(launches["flash_combine"] == cfg.num_layers * len(ticks),
          f"lm serve: {launches['flash_combine']} flash_combine launches, "
          f"expected one per decode-tick layer, {cfg.num_layers} x "
          f"{len(ticks)}")
    full_ticks = [t["ms"] for t in ticks if t["active"] == SERVE["slots"]]
    lm_profile(torch, np, engine, cfg, statistics.median(full_ticks))
    return launches


def _device_busy(trace_path: Path) -> dict:
    """Kernel, copy and memset intervals of a Chrome trace: their union in
    ms, their count, and the kernels' summed ms by name."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return {"busy_ms": busy / 1e3, "device_ops": len(spans),
            "kernel_ms_by_name": by_name}


def lm_profile(torch, np, engine, cfg, tick_ms: float) -> None:
    """Where phase 5's time goes on the card: `torch.profiler` over one
    1024-token prefill, then over PROFILE_TICKS decode ticks with all 8
    slots active.  Busy time is the union of the traced kernels, copies and
    memsets; the idle share of a tick is 1 - busy / `tick_ms`, the median
    unprofiled tick at 8 active slots from the counted run (the profiler
    slows the host, so its own wall time overstates idleness).  Runs after
    the launch counts were read, so it adds to none of them."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request
    rng = np.random.default_rng(2)
    slots = SERVE["slots"]
    for i in range(slots):
        engine.submit(Request(rid=1000 + i, prompt=rng.integers(
            0, cfg.vocab_size, 512).astype(np.int32),
            max_new_tokens=PROFILE_TICKS + 2))
    engine.step()                      # admits all 8, one decode tick
    check(all(r is not None for r in engine.active),
          "lm profile: slots not all active")
    prompt = rng.integers(0, cfg.vocab_size, 1024).astype(np.int32)
    trace = ROOT / "build" / "lm_profile_trace.json"
    trace.parent.mkdir(exist_ok=True)
    out = {"phase": "lm_profile", "tick_ms_unprofiled": tick_ms}
    for name, run in (("prefill_1024", lambda: engine._prefill(prompt)),
                      ("decode_ticks", lambda: [
                          engine.step() for _ in range(PROFILE_TICKS)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(trace))
        dev = _device_busy(trace)
        trace.unlink()
        n = PROFILE_TICKS if name == "decode_ticks" else 1
        top = sorted(dev["kernel_ms_by_name"].items(), key=lambda kv: -kv[1])
        flash = sum(ms for k, ms in dev["kernel_ms_by_name"].items()
                    if "flash_" in k)
        out[name] = {"profiled_wall_ms": wall_ms / n,
                     "busy_ms": dev["busy_ms"] / n,
                     "device_ops": dev["device_ops"] / n,
                     "flash_ms": flash / n,
                     "top_kernels_ms": [[k[:90], ms / n] for k, ms in top[:8]]}
    busy = out["decode_ticks"]["busy_ms"]
    out["decode_idle_share"] = (1 - busy / tick_ms) if busy > 0 else None
    emit(out)
    engine.run_until_drained()
    check(engine.kv_slots.occupancy == 0.0, "lm profile: slots still held")


#: the kernels each main path must launch
PATH_KERNELS = {
    "gids-device": ("segment_mean", "tiered_gather", "store_fill",
                    "cache_bucket", "cache_access"),
    MERGED_PLANE: ("segment_mean", "tiered_gather_unique", "frontier_read",
                   "store_fill", "cache_bucket", "cache_access"),
    LM_PATH: ("flash_attention", "flash_combine"),
}


#: name -> (source, the reference function it replaces, parity class)
SOURCES = {
    "segment_mean": ("src/repro_torch/kernels/csrc/segment_mean.cu",
                     "src/repro/kernels/segment_mean.py:40",
                     "allclose 1e-6 f32, 2e-2 bf16"),
    "tiered_gather": ("src/repro_torch/kernels/csrc/tiered_gather.cu",
                      "src/repro/kernels/tiered_gather.py:154", "exact"),
    "store_fill": ("src/repro_torch/kernels/csrc/tiered_gather.cu",
                   "src/repro/core/device_store.py:48", "exact"),
    "cache_bucket": ("src/repro_torch/kernels/csrc/cache_access.cu",
                     "src/repro/core/cache_jax.py:70", "exact"),
    "cache_access": ("src/repro_torch/kernels/csrc/cache_access.cu",
                     "src/repro/core/cache_jax.py:70", "exact"),
    "tiered_gather_unique": ("src/repro_torch/kernels/csrc/tiered_gather.cu",
                             "src/repro/kernels/tiered_gather.py:235",
                             "exact"),
    "frontier_gather": ("src/repro_torch/kernels/csrc/frontier_gather.cu",
                        "src/repro/kernels/tiered_gather.py:277", "exact"),
    "frontier_read": ("src/repro_torch/kernels/csrc/frontier_gather.cu",
                      "src/repro/kernels/tiered_gather.py:277", "exact"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:74",
                        "allclose 3e-4 f32, 3e-2 bf16; each row within "
                        "1e-4 f32, 1e-2 bf16 of its norm"),
    "flash_combine": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:30",
                      "allclose 1e-5 f32, 1e-2 bf16"),
}


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--plant-fault", choices=sorted(FAULTS),
                        help="instead of the run, show that phase 2's "
                        "flash_attention gate rejects this planted fault")
    parser.add_argument("--segment-mean-variants", action="store_true",
                        help="instead of the run, time the segment_mean "
                        "kernel beside its SEGMENT_MEAN_VARIANTS")
    args = parser.parse_args()
    # the run uses one card: keep only the first visible one, so that the
    # device count on the last line is the number of cards that did the work
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[0]
                                          if visible is not None else "0")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    check(torch.cuda.device_count() == 1,
          f"{torch.cuda.device_count()} cards visible after pinning to one")
    if args.plant_fault:
        return plant_fault(torch, args.plant_fault)
    if args.segment_mean_variants:
        return segment_mean_variants(torch)
    card_and_build(torch)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    measured = {"segment_mean": kernel_segment_mean(torch, timer, gen),
                "tiered_gather": kernel_tiered_gather(torch, timer, gen),
                "store_fill": kernel_store_fill(torch, timer, gen),
                "cache_access": None, "cache_bucket": None,
                "tiered_gather_unique": kernel_tiered_gather_unique(
                    torch, timer, gen),
                "frontier_gather": kernel_frontier_gather(torch, timer, gen),
                "frontier_read": kernel_frontier_read(torch, timer, np),
                "flash_attention": kernel_flash_attention(torch, timer, gen),
                "flash_combine": kernel_flash_combine(torch, timer, gen)}
    measured["cache_access"], measured["cache_bucket"] = kernel_cache_access(
        torch, timer, np)
    window_access, window_bucket = kernel_cache_access(
        torch, timer, np, B=28_000, id_range=100_000)
    hot_access, hot_bucket = kernel_cache_access(torch, timer, np,
                                                 hot_sets=4)
    cache_bucket_limit(torch)
    del timer
    by_path = {"gids-device": main_path(torch, np)}
    by_path[MERGED_PLANE] = merged_topology_path(torch, np)
    torch.cuda.empty_cache()
    lm_gate_f32(torch, np)
    torch.cuda.empty_cache()
    by_path[LM_PATH] = lm_serve_path(torch, np)
    kernels = []
    for name, (source, replaces, parity) in SOURCES.items():
        m = measured[name]
        launches = {path: n[name] for path, n in by_path.items()
                    if name in PATH_KERNELS[path]}
        if name in ("cache_access", "cache_bucket"):
            window, hot = ((window_access, hot_access)
                           if name == "cache_access"
                           else (window_bucket, hot_bucket))
            extra = {"merged_window_ms": window["ms"],
                     "merged_window_bound_ms": window["bound_ms"],
                     "hot_4_sets_ms": hot["ms"]}
        else:
            extra = {k: v for k, v in m.items() if k not in SUMMARY_KEYS}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "parity": parity,
                        "launches": sum(launches.values()),
                        "launches_by_path": launches, **extra,
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"],
                        "library_ms": m["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
