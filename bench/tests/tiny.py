"""A benchmark tree at a size the CPU tests can run: the repository's
BENCHMARK.json, traffic and metric readers, with each configuration cut to
a tiny graph and tiny widths."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench import spec

TINY = {"in_dim": 32, "hidden_dim": 16, "num_classes": 5,
        "fanouts": [3, 2, 2], "nodes": 3000, "edges": 24000}
TINY_LOADER = {"cache_lines": 512}
TINY_TRAFFIC = {"batch_size": 16, "window_sample": 3}


def make_tree(tmp: Path) -> tuple[Path, Path]:
    """(root, bench dir) of a copy of the benchmark with tiny
    configurations and mixes."""
    root = tmp / "checkout"
    bench_dir = root / "bench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (bench_dir / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg |= TINY
        cfg["loader"] |= TINY_LOADER
        path.write_text(json.dumps(cfg))
    for path in (bench_dir / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        path.write_text(json.dumps(traffic | TINY_TRAFFIC))
    return root, bench_dir


def tiny_cell(tmp: Path, name: str) -> spec.Cell:
    root, bench_dir = make_tree(tmp)
    return spec.load_cell(name, root=root, bench_dir=bench_dir)
