"""The result's last line: its keys, in order, and the refusals that print
no result."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from bench import cell as cell_run
from bench import judge, run, spec, trace

from . import tiny


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(tmp_path, traced):
    cell = tiny.tiny_cell(tmp_path, "sage3-igbs.b1024")
    out = cell_run.run(cell, 2**31 + 99, 0.2, traced, torch.device("cpu"),
                       0.0)
    info = {"platform": "gpu", "kind": "test", "count": 1,
            "memory_peak_bytes": 0}
    line = run.result_line(cell, out, traced, info)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(out["window"].steps) > 0
    assert list(line["checks"]) == list(judge.NUMBERS)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if not traced:
        # a run off the card has no device trace to read
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end
                                        if m["source"] != "device_trace"}
    json.dumps(line, allow_nan=False)


def test_end_to_end_values_from_the_device_trace():
    """Every end-to-end metric of every cell has a value, and the device's
    time per thousand seeds is the union of the operations inside the
    window over the window's seeds."""
    ops = [("a", 0.5, 1.5), ("b", 1.2, 2.0),     # overlap: 1.0 to 2.0
           ("c", 3.0, 3.5), ("d", 9.0, 11.0)]    # d is cut at 10.0
    dt = trace.DeviceTrace(ops, 1.0, 10.0)
    steps = [cell_run.Step(wall_s=1.0, seeds=1024, staged_rows=1,
                           split_ms={}) for _ in range(4)]
    w = cell_run.Window(config={}, traffic={}, t0=1.0, t1=10.0, steps=steps,
                        spans=trace.Spans(False), device_trace=dt,
                        cache_hits=None, cache_misses=None)
    values = run.end_to_end_values(w, 12.5)
    assert values["setup_s"] == 12.5
    assert values["device_ms_per_1k_seeds"] == pytest.approx(
        2.5e3 / 4.096)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for c in bench["workloads"]:
        names = {m["name"] for m in spec.load_cell(c["name"]).end_to_end}
        assert names <= set(values)


def test_no_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "sage3-igbs.b1024", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_exit_without_a_result(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    got = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "sage3-igbs.b1024",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert got.returncode != 0 and got.stdout == ""
