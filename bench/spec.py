"""Finds a cell's pieces by name: its entry in `BENCHMARK.json`, the
configuration file that entry names, the family module its configuration
names in `families/<name>.py`, the traffic mix in `traffic/<name>.json`, and
a reader for each of its per-layer metrics in `metrics/<name>.py`.

Nothing here knows a particular cell: a configuration, a family, a mix, a
metric or a cell is added as a file and an entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: the loops `cell.run` drives: "closed", one trainer that takes the next
#: batch when its step ends
LOOPS = ("closed",)
#: the family of a configuration that names none
DEFAULT_FAMILY = "gnn"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list[dict]     # the metrics this cell reports
    per_layer: list[dict]
    family: ModuleType         # families/<name>.py, loaded for this cell


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _by_name(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _module(path: Path, prefix: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_family(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module `families/<name>.py`: a configuration's model, graph,
    program and reference run (`bench/README.md`, "Adding to it")."""
    path = bench_dir / "families" / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name) or not path.is_file():
        raise ValueError(f"family {name!r} has no file families/{name}.py")
    return _module(path, "bench_family_", name)


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "configuration")
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic.get("loop") not in LOOPS:
        raise ValueError(f"mix {w['traffic']!r}: loop "
                         f"{traffic.get('loop')!r} is not one of {LOOPS}")
    family = load_family(config.get("family", DEFAULT_FAMILY), bench_dir)
    return Cell(name=name, chips=w["chips"], config_name=c["name"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                family=family)


def load_reader(metric: str, bench_dir: Path = BENCH_DIR
                ) -> Callable[[object], float | None]:
    """The `read(window)` function of `metrics/<metric>.py`."""
    return _module(bench_dir / "metrics" / f"{metric}.py", "bench_metric_",
                   metric).read
