"""`examples/trace_cost_torch.py` on the CPU at a tiny size: both sides
step alike, the written trace is counted, and the spans' self times add up
to the two stages they nest in."""
import runpy
from pathlib import Path

import pytest

pytest.importorskip("torch")

SCRIPT = Path(__file__).resolve().parents[1] / "examples" / \
    "trace_cost_torch.py"


def test_trace_cost_script_on_the_cpu(tmp_path):
    main = runpy.run_path(str(SCRIPT))["main"]
    trace = tmp_path / "trace.json"
    out = main(["--device", "cpu", "--nodes", "3000", "--feature-dim", "16",
                "--batch", "32", "--fanouts", "4", "3", "--cache-lines",
                "256", "--steps", "4", "--warmup", "2",
                "--trace-out", str(trace)])
    assert out["device"] == "cpu" and out["steps"] == 4
    for side in ("untraced", "traced"):
        assert 0 < out[side]["min_ms"] <= out[side]["median_ms"] \
            <= out[side]["max_ms"]
    cost = out["cost"]
    assert cost["trace_events"] > 0
    assert cost["trace_bytes"] == trace.stat().st_size > 0
    assert cost["tree_ms_per_step"] > 0 and cost["spans_ms_per_step"] > 0
    assert len(cost["paired_diff_quartiles_ms"]) == 3
    spans = out["spans"]
    assert spans["execute"]["calls"] == spans["plan_next"]["calls"] == 4
    for name in ("gather", "probe:device-store", "future_counts",
                 "stage_host", "probe_wait", "report", "price", "feedback",
                 "sample_blocks", "admit"):
        assert spans[name]["calls"] >= 4, name
        assert 0.0 <= spans[name]["self_ms"] <= spans[name]["ms"]
    assert cost["wall_spans_per_step"] == sum(
        r["calls"] for r in spans.values()) / 4
    # every span nests in plan_next or execute: their self times add up
    # to those two stages
    assert sum(r["self_ms"] for r in spans.values()) == pytest.approx(
        spans["plan_next"]["ms"] + spans["execute"]["ms"], rel=1e-9)
