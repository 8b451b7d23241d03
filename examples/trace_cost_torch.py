"""What tracing costs the port's GIDS loader: two loaders built alike from
one seed, one with the shared no-op tracer and one with a `Tracer`, stepped
in turns (untraced then traced, then traced then untraced, and so on), each
`next_batch` timed on the host clock.  Both draw the same batches, so each
pair of steps does the same work.  The host's own swings make a paired
difference noisy, so the tracer's work is also timed directly: the
per-batch priced span tree (`_trace_batch`, timed around each call) and
the wall spans (a span's cost, from a loop of them, times the spans a
step).  Then the traced loader's trace is written and its size read, and
the self time of every wall span a step is printed: where the host's time
in `plan_next` and `execute` goes.

The defaults are the loader settings of the benchmark configuration
`sage3-igbs`: an RMAT graph of 1,000,000 nodes and about 12 M edges,
1024-d float32 features on the host, the `gids-device` plane with 32,768
lines of 8 ways, a window of 8 batches, a 10 % constant buffer by reverse
PageRank, batch 1024 drawn from the nodes with an out-edge, fanouts
(10, 5, 5).

    PYTHONPATH=src python examples/trace_cost_torch.py
    PYTHONPATH=src python examples/trace_cost_torch.py --device cpu \\
        --nodes 5000 --feature-dim 32 --batch 64 --cache-lines 512 \\
        --steps 4 --warmup 2

Prints one JSON line per side (`side`: host ms a step, mean and median),
one per span name of the traced side (`span`: calls, ms and self ms a
step) and last a cost line: the median and quartiles of the paired
differences (traced less untraced) in ms and the median as a share of the
untraced median, the tracer's own ms a step timed directly
(`tree_ms_per_step`, `spans_ms_per_step`) and their share, and the written
trace's events and bytes.
"""
import argparse
import json
import os
import statistics
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import INTEL_OPTANE, GIDSDataLoader, LoaderConfig
from repro_torch.graph.synthetic import rmat_graph
from repro_torch.obs import HOT_PATH, Tracer


def _features(n: int, dim: int, seed: int) -> np.ndarray:
    """Standard normal float32 rows, drawn in slabs."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, dim), np.float32)
    step = max(1, n // 64)
    for i in range(0, n, step):
        out[i:i + step] = rng.standard_normal((min(step, n - i), dim),
                                              dtype=np.float32)
    return out


def _step_ms(loader, device) -> float:
    t = time.perf_counter()
    loader.next_batch()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def span_cost_s(n: int = 20_000) -> float:
    """Seconds one wall span costs: half opened as a stage, half recorded
    from clock reads inside it, on a tracer of their own."""
    tracer = Tracer()
    t = time.perf_counter()
    for _ in range(n // 2):
        with tracer.stage("stage", cat=HOT_PATH, rows=1):
            tracer.record("record", t, t, rows=1)
    return (time.perf_counter() - t) / n


def _timed(obj, method: str, acc: list) -> None:
    """Add the seconds of every call of `obj.method` to `acc[0]`."""
    inner = getattr(obj, method)

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t
    setattr(obj, method, timed)


def span_self_ms(tracer, steps: int) -> dict[str, dict]:
    """Calls, ms and self ms a step of every wall span name (a `probe` by
    its tier: `probe:<tier>`)."""
    out: dict[str, dict] = defaultdict(lambda: {"calls": 0, "ms": 0.0,
                                                "self_ms": 0.0})
    for w in tracer.wall_spans():
        tier = w.args.get("tier")
        row = out[w.name if tier is None else f"{w.name}:{tier}"]
        row["calls"] += 1
        row["ms"] += w.wall_dur * 1e3 / steps
        row["self_ms"] += w.self_time() * 1e3 / steps
    return dict(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--avg-degree", type=int, default=12)
    ap.add_argument("--feature-dim", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[10, 5, 5])
    ap.add_argument("--cache-lines", type=int, default=32_768)
    ap.add_argument("--steps", type=int, default=40,
                    help="timed steps a side")
    ap.add_argument("--warmup", type=int, default=5,
                    help="untimed steps a side first")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-out", default="",
                    help="where the trace is written (a temporary file "
                         "that is removed, by default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    graph = rmat_graph(args.nodes, args.avg_degree, args.feature_dim,
                       seed=args.seed, name="rmat")
    feats = _features(args.nodes, args.feature_dim, args.seed + 1)
    pool = np.flatnonzero(np.diff(graph.indptr) > 0)
    cfg = dict(batch_size=args.batch, fanouts=tuple(args.fanouts),
               data_plane="gids-device", cache_lines=args.cache_lines,
               cache_ways=8, window_depth=8, cbuf_fraction=0.1,
               cbuf_selection="pagerank", seed=args.seed)
    tracer = Tracer()
    loaders = {
        "untraced": GIDSDataLoader(graph, feats, LoaderConfig(**cfg),
                                   ssd=INTEL_OPTANE, train_ids=pool,
                                   device=device),
        "traced": GIDSDataLoader(graph, feats, LoaderConfig(**cfg),
                                 ssd=INTEL_OPTANE, train_ids=pool,
                                 device=device, tracer=tracer)}
    for _ in range(args.warmup):
        for loader in loaders.values():
            loader.next_batch()
    tracer.reset()
    tree_s = [0.0]
    _timed(loaders["traced"], "_trace_batch", tree_s)
    setup_s = time.perf_counter() - t0

    ms: dict[str, list[float]] = {"untraced": [], "traced": []}
    for i in range(args.steps):
        order = ("untraced", "traced") if i % 2 == 0 else ("traced",
                                                           "untraced")
        for side in order:
            ms[side].append(_step_ms(loaders[side], device))

    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    result = {"setup_s": setup_s, "device": card, "steps": args.steps}
    for side, vals in ms.items():
        row = {"side": side, "mean_ms": statistics.fmean(vals),
               "median_ms": statistics.median(vals),
               "min_ms": min(vals), "max_ms": max(vals)}
        result[side] = row
        print(json.dumps(row), flush=True)
    spans = span_self_ms(tracer, args.steps)
    for name, row in sorted(spans.items(), key=lambda kv: -kv[1]["ms"]):
        print(json.dumps({"span": name, **row}), flush=True)
    result["spans"] = spans

    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace_out or os.path.join(tmp, "trace.json")
        events = tracer.write(path)
        size = os.path.getsize(path)
    diffs = [b - a for a, b in zip(ms["untraced"], ms["traced"])]
    base = result["untraced"]["median_ms"]
    spans_a_step = len(tracer.wall_spans()) / args.steps
    direct_ms = {"tree_ms_per_step": tree_s[0] * 1e3 / args.steps,
                 "spans_ms_per_step": span_cost_s() * 1e3 * spans_a_step}
    cost = {"paired_diff_ms": statistics.median(diffs),
            "paired_diff_quartiles_ms": statistics.quantiles(diffs, n=4),
            "paired_diff_share": statistics.median(diffs) / base,
            "wall_spans_per_step": spans_a_step, **direct_ms,
            "direct_share": sum(direct_ms.values()) / base,
            "trace_events": len(events), "trace_bytes": size,
            "trace_bytes_per_step": size / args.steps,
            "setup_s": setup_s, "device": card}
    result["cost"] = cost
    print(json.dumps(cost), flush=True)
    return result


if __name__ == "__main__":
    main()
