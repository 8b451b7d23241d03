"""The harness finds configurations, mixes and per-layer metric readers by
name: new ones come as new files and entries, with no file edited."""
import json

import numpy as np
import pytest
import torch

from bench import cell as cell_run
from bench import run, spec

from . import tiny


def _add(root, bench_dir):
    """A new configuration, mix, metric and cell, as files and entries."""
    cfg = json.loads((bench_dir / "configs" / "sage3-igbs.json").read_text())
    cfg |= {"name": "sage2-new", "fanouts": [4, 3]}
    (bench_dir / "configs" / "sage2-new.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "b1024.json").read_text())
    mix |= {"name": "b8-new", "batch_size": 8}
    (bench_dir / "traffic" / "b8-new.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "new.seeds_per_step.py").write_text(
        "def read(w):\n"
        "    return sum(s.seeds for s in w.steps) / len(w.steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "sage2-new", "source": "https://arxiv.org/abs/2306.16384",
        "file": "bench/configs/sage2-new.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "sage2-new.b8-new", "config": "sage2-new",
        "traffic": "b8-new", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "new.seeds_per_step", "unit": "seeds", "better": "higher",
        "source": "host_clock", "layer": "loader planning",
        "moves": "device_ms_per_1k_seeds",
        "workloads": ["sage2-new.b8-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root, bench_dir = tiny.make_tree(tmp_path)
    before = {p: p.read_bytes() for p in bench_dir.rglob("*")
              if p.is_file()}
    _add(root, bench_dir)
    assert all(p.read_bytes() == b for p, b in before.items())

    cell = spec.load_cell("sage2-new.b8-new", root=root, bench_dir=bench_dir)
    assert cell.config["fanouts"] == [4, 3]
    assert cell.traffic["batch_size"] == 8
    assert "new.seeds_per_step" in [m["name"] for m in cell.per_layer]
    # the metric lists only its own cell
    old = spec.load_cell("sage3-igbs.b1024", root=root, bench_dir=bench_dir)
    assert "new.seeds_per_step" not in [m["name"] for m in old.per_layer]

    out = cell_run.run(cell, 5, 0.2, True, torch.device("cpu"), 0.0)
    readers = {m["name"]: spec.load_reader(m["name"], bench_dir)
               for m in cell.per_layer}
    assert readers["new.seeds_per_step"](out["window"]) == 8
    assert out["checks"]["bad_sample_ids"]["value"] == 0


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {
            "setup_s", "device_ms_per_1k_seeds"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    before = run.forbidden_modules()
    for name in ("repro_torch_like", "reprox.core", "jaxlike", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in run.forbidden_modules()


def test_every_loader_field_and_the_mix_reach_the_program(tmp_path):
    """A loader field no configuration sets yet reaches `LoaderConfig`, and
    a mix's labelled split narrows the seed pool, with no file edited."""
    from bench import trace as trace_mod
    cell = tiny.tiny_cell(tmp_path, "sage3-igbs.b1024")
    cell.config["loader"]["target_efficiency"] = 0.5
    cell.traffic["seed_pool"] = {"min_out_degree": 1, "fraction": 0.25}
    inp, prog, first, _ = cell_run.setup(cell, 4, torch.device("cpu"),
                                         trace_mod.Spans(False))
    assert prog.loader.config.target_efficiency == 0.5
    with_edge = (np.diff(inp.indptr) >= 1).sum()
    assert len(inp.seed_pool) == round(0.25 * with_edge)
    assert np.isin(first[0]["seeds"], inp.seed_pool).all()
    # the split belongs to the dataset: another --seed draws the same one
    again = cell.family.make_inputs(cell.config, cell.traffic, 5,
                                    torch.device("cpu"))
    np.testing.assert_array_equal(again.seed_pool, inp.seed_pool)


def test_a_loop_the_harness_cannot_run_is_refused(tmp_path):
    root, bench_dir = tiny.make_tree(tmp_path)
    path = bench_dir / "traffic" / "b1024.json"
    path.write_text(json.dumps(json.loads(path.read_text())
                               | {"loop": "open"}))
    with pytest.raises(ValueError, match="loop"):
        spec.load_cell("sage3-igbs.b1024", root=root, bench_dir=bench_dir)
