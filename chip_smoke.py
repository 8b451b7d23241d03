#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. Card and set-up: the `nvidia-smi` name and power limit, TF32 off, and
   the build of every CUDA kernel of the port from src/repro_torch/kernels/
   csrc (one nvcc per source, all started together, into build/kernels/).
2. Per-kernel parity and timing at the main path's shapes: each kernel
   against its plain PyTorch version on the same inputs (gathers, row-store
   fill and cache access exact; segment_mean within 1e-6 in f32 and 2e-2 in
   bf16).  Times are CUDA-event medians of 20 launches after warm-up, with
   a 256 MB buffer written between launches so that every launch starts
   from a cold L2.
3. The main path: GraphSAGE training at the full width of
   examples/train_gnn_igb_torch.py (100k-node RMAT graph, 1024-d features,
   hidden 4096, batch 512, fanouts (10, 5)) through the `gids-device` data
   plane, for STEPS steps.  Every batch's features must equal the host
   features of its nodes bit for bit, step 0's loss must agree with the
   loss computed through the plain versions to rtol 1e-5, every loss must
   be finite, the cache must hit, and every kernel's launch count over the
   run must be positive.
4. One JSON line `{"kernels": [...]}` and, last, one JSON line naming the
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


def kernel_cache_access(torch, timer, np):
    """B = 8192 requests into 2048 sets x 8 ways over three rounds that
    repeat ids under window pinning (duplicates and -1 pads in the last),
    exact against access_ref on CPU tensors."""
    from repro_torch.core import cache_device as cd
    lines, ways, B = 16384, 8, 8192
    rng = np.random.default_rng(7)
    gpu = cd.init_cache(lines, ways, device="cuda")
    cpu = cd.init_cache(lines, ways, device="cpu")
    prev = rng.choice(40_000, B, replace=False)
    for rnd in range(3):
        fresh = rng.choice(40_000, B, replace=False)
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

def main_path(torch, np):
    from repro_torch.core import INTEL_OPTANE, GIDSDataLoader, LoaderConfig
    from repro_torch.graph.synthetic import rmat_graph
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.gnn import GNN, GNNConfig, hop_indices, sgd_step

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    graph = rmat_graph(100_000, 12, 1024, seed=0, name="igb-synthetic")
    n_classes = 47
    labels_all = rng.integers(0, n_classes, graph.num_nodes)
    feats = (np.eye(n_classes, 1024)[labels_all] * 2.0
             + 0.5 * rng.standard_normal((graph.num_nodes, 1024))
             ).astype(np.float32)
    cfg = GNNConfig(model="sage", in_dim=1024, hidden_dim=4096,
                    num_classes=n_classes, fanouts=(10, 5))
    gnn = GNN(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    loader = GIDSDataLoader(
        graph, feats,
        LoaderConfig(batch_size=512, fanouts=cfg.fanouts,
                     data_plane="gids-device", cache_lines=1 << 14,
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
    emit({"phase": "main_path", "steps": STEPS, "launches": launches,
          "median_of_steps_1_on": median,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return launches


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
                "cache_access": kernel_cache_access(torch, timer, np)}
    del timer
    launches = main_path(torch, np)
    kernels = []
    for name, (source, replaces, parity) in SOURCES.items():
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "parity": parity,
                        "launches": launches[name],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"],
                        "library_ms": m["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
