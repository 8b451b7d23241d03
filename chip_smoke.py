#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Card and set-up: the `nvidia-smi` name and power limit, TF32 off, and
   the build of every CUDA kernel of the port from src/repro_torch/kernels/
   csrc (one nvcc per source, all started together, into build/kernels/).
2. Per-kernel parity and timing at the main paths' shapes: each kernel
   against its plain PyTorch version on the same inputs (gathers, word
   gather, row-store fill and cache access exact; segment_mean within 1e-6
   in f32 and 2e-2 in bf16).  Times are CUDA-event medians of 20 launches
   after warm-up, with a 256 MB buffer written between launches so that
   every launch starts from a cold L2.
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
   words through the tiered edge-page store with `frontier_gather`.  Every
   batch's features must equal the host features bit for bit, every hop's
   words must equal `graph.indices[pos]`, step 0's loss must agree with the
   plain versions' to rtol 1e-5, every loss must be finite, every batch
   must carry priced sampling time, and each of the path's kernels must be
   launched.
5. One JSON line `{"kernels": [...]}` and, last, one JSON line naming the
   device.

The script imports torch, numpy and the port (src/repro_torch) only.
"""
from __future__ import annotations

import json
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
REPS, WARMUP = 20, 3


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
    with `setup()` (untimed) and an L2 flush before each call."""

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


def bound(nbytes: int, flops: int = 0) -> dict:
    """The least time the card could take for the work: the bytes it must
    move over the memory rate, or its f32 operations over the vector
    rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def kernel_segment_mean(torch, timer, gen):
    """(512, 10) and (5120, 5) over an (8192, 1024) table: layer 0's two
    aggregations per training step."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    N, D = 8192, 1024
    feats32 = torch.randn((N, D), generator=gen, device="cuda")
    main = []
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        feats = feats32.to(dtype)
        for B, Fo in ((512, 10), (5120, 5)):
            idx = torch.randint(0, N, (B, Fo), generator=gen, device="cuda",
                                dtype=torch.int32)
            out = ops.segment_mean(idx, feats)
            want = ref.segment_mean_ref(idx, feats)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            check(torch.allclose(out.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"segment_mean {dtype} ({B},{Fo}) max_abs_err {err}")
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
            if dtype == torch.float32:       # the main path's table type
                main.append(row)
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


def kernel_cache_access(torch, timer, np, B=8192, id_range=40_000):
    """B requests into 2048 sets x 8 ways over three rounds that repeat ids
    under window pinning (duplicates and -1 pads in the last), exact
    against access_ref on CPU tensors.  B = 8192 is one batch of the first
    path, B = 28000 one merged window's unique ids on the second."""
    from repro_torch.core import cache_device as cd
    lines, ways = 16384, 8
    rng = np.random.default_rng(7)
    gpu = cd.init_cache(lines, ways, device="cuda")
    cpu = cd.init_cache(lines, ways, device="cpu")
    prev = rng.choice(id_range, B, replace=False)
    for rnd in range(3):
        fresh = rng.choice(id_range, B, replace=False)
        ids = np.where(rng.random(B) < 0.5, prev, fresh).astype(np.int32)
        if rnd == 2:
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
           "shape": [B, lines // ways, ways], "max_abs_err": 0.0,
           "hits": int(cpu.hits), "misses": int(cpu.misses),
           "bypasses": int(cpu.bypasses),
           "kernel_ms": timer(lambda st: cd.access(st, ids_d, fc_d),
                              setup=lambda: (_clone_state(snap_gpu, "cuda"),)),
           "plain_ms": host_ms(lambda st: cd.access(st, ids_t, fc_t),
                               setup=lambda: (_clone_state(snap_cpu, "cpu"),)),
           "plain_on": "host CPU (access_ref is a Python loop)",
           "library_ms": None, **bound(nbytes)}
    emit(row)
    return summary([row])


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
    frontier_gather, hop_report = topo.frontier_gather, topo.hop_report

    def checked_frontier_gather(pos):
        t = time.perf_counter()
        out = frontier_gather(pos)
        hops["gather_ms"] += (time.perf_counter() - t) * 1e3
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
        t, g = time.perf_counter(), hops["gather_ms"]
        plans = plan_window()
        windows.append({"sample_ms": (time.perf_counter() - t) * 1e3,
                        "sample_frontier_gather_ms": hops["gather_ms"] - g})
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
    return launches


#: the kernels each main path must launch
PATH_KERNELS = {
    "gids-device": ("segment_mean", "tiered_gather", "store_fill",
                    "cache_access"),
    MERGED_PLANE: ("segment_mean", "tiered_gather_unique", "frontier_gather",
                   "store_fill", "cache_access"),
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
    "cache_access": ("src/repro_torch/kernels/csrc/cache_access.cu",
                     "src/repro/core/cache_jax.py:70", "exact"),
    "tiered_gather_unique": ("src/repro_torch/kernels/csrc/tiered_gather.cu",
                             "src/repro/kernels/tiered_gather.py:235",
                             "exact"),
    "frontier_gather": ("src/repro_torch/kernels/csrc/frontier_gather.cu",
                        "src/repro/kernels/tiered_gather.py:277", "exact"),
}


def main() -> int:
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

    card_and_build(torch)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    measured = {"segment_mean": kernel_segment_mean(torch, timer, gen),
                "tiered_gather": kernel_tiered_gather(torch, timer, gen),
                "store_fill": kernel_store_fill(torch, timer, gen),
                "cache_access": kernel_cache_access(torch, timer, np),
                "tiered_gather_unique": kernel_tiered_gather_unique(
                    torch, timer, gen),
                "frontier_gather": kernel_frontier_gather(torch, timer, gen)}
    window_access = kernel_cache_access(torch, timer, np, B=28_000,
                                        id_range=100_000)
    del timer
    by_path = {"gids-device": main_path(torch, np)}
    by_path[MERGED_PLANE] = merged_topology_path(torch, np)
    kernels = []
    for name, (source, replaces, parity) in SOURCES.items():
        m = measured[name]
        launches = {path: n[name] for path, n in by_path.items()
                    if name in PATH_KERNELS[path]}
        extra = ({"merged_window_ms": window_access["ms"],
                  "merged_window_bound_ms": window_access["bound_ms"]}
                 if name == "cache_access" else {})
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
