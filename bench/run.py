"""Run one cell of the benchmark of `repro_torch` and print its result.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is one JSON object: `correct`,
`attempted` and `failed` (the window's steps, and those whose loss was not
finite), `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`: each number compared with the reference beside its limit.  The
checks are also the last lines of standard error, after a line with the
window's steps, seeds, rate and step p90 on the host clock.

Exits 2, printing no result, without a CUDA card, with fewer cards than the
cell asks for, or where the measured package (`src/repro_torch`) is not in
the checkout; exits 3 if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "unknown"


def end_to_end_values(w, setup_s: float) -> dict:
    """The end-to-end metrics of a window: `setup_s`, and where the device
    was traced, `device_ms_per_1k_seeds`: the seconds in which some
    operation ran on the card (the union of the trace's operations in the
    window) per thousand seeds of the window's steps, in ms."""
    values = {"setup_s": setup_s}
    seeds = sum(s.seeds for s in w.steps)
    if w.device_trace is not None and seeds:
        values["device_ms_per_1k_seeds"] = (
            w.device_trace.busy_s() * 1e3 / (seeds / 1e3))
    return values


def window_summary(w) -> str:
    """The window's steps, seeds, seconds, rate and 90th percentile of the
    step on the host clock, for standard error."""
    from . import yardstick
    seeds = sum(s.seeds for s in w.steps)
    p90 = yardstick.percentile([s.wall_s * 1e3 for s in w.steps], 90)
    return (f"bench: window {len(w.steps)} steps, {seeds} seeds, "
            f"{w.seconds:.3f} s, {seeds / w.seconds:.1f} seeds/s, "
            f"step p90 {p90:.1f} ms")


def result_line(cell, out: dict, traced: bool, device_info: dict) -> dict:
    """The result's JSON object, `checks` last."""
    from . import judge, spec
    w = out["window"]
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(w)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end_values(w, out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    line = {"correct": judge.passed(out["checks"]),
            "attempted": len(w.steps), "failed": out["nonfinite"],
            "metrics": metrics, "device": device_info}
    if traced and w.device_trace is not None:
        line["device"] |= {"busy_s": w.device_trace.busy_s(),
                           "window_s": w.device_trace.window_s}
        line["breakdown"] = {
            "device_ops": w.device_trace.top_ops(10),
            "idle_gaps": w.device_trace.idle_by_span(w.spans, 10)}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the measured package src/repro_torch is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import torch
    from . import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} are present", file=sys.stderr)
        return 2

    from . import cell as cell_run
    out = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        print("bench: JAX or the JAX package was loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 3
    card = _power_limit()
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": out["memory_peak_bytes"],
                   "card_and_power_limit": card}
    line = result_line(cell, out, bool(args.trace), device_info)
    print(f"bench: {cell.name} seed {args.seed} on {card}", file=sys.stderr)
    print(window_summary(out["window"]), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
