"""The `rgat` family at a tiny size on the CPU: a run comes out correct
through the loader's relational sampler, its program spans reach their
readers, the harness's graph is the program's, and the sample check counts
planted faults."""
import json

import numpy as np
import pytest
import torch

from bench import cell as cell_run
from bench import judge, spec
from bench import trace as trace_mod

from . import tiny

CELL = "rgat3-igbh.b1024"
#: IGBH's types and relations at a tiny size, tiny widths
TINY_RGAT = {"nodes": {"paper": 700, "author": 650, "institute": 6,
                       "fos": 20},
             "edges": {"cites": 3500, "written_by": 900, "topic": 1200,
                       "affiliated_to": 300},
             "num_heads": 4}


def tiny_rgat(tmp_path) -> spec.Cell:
    root, bench_dir = tiny.make_tree(tmp_path)
    path = bench_dir / "configs" / "rgat3-igbh.json"
    path.write_text(json.dumps(json.loads(path.read_text()) | TINY_RGAT))
    return spec.load_cell(CELL, root=root, bench_dir=bench_dir)


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    cell = tiny_rgat(tmp_path_factory.mktemp("rgat"))
    return cell, cell_run.run(cell, 2**31 + 41, 0.3, True,
                              torch.device("cpu"), 0.0)


def test_rgat_runs_correct_with_its_program_spans(traced_run):
    cell, out = traced_run
    assert cell.family.__file__.endswith("families/rgat.py")
    checks = out["checks"]
    assert checks["bad_sample_ids"]["value"] == 0
    assert judge.passed(checks), checks
    w = out["window"]
    assert w.step_flops is None
    assert all(set(s.kernels) == {"tiered_gather"} for s in w.steps)
    names = {n for n, _, _ in w.spans.records}
    assert {"sample_relations", "build_blocks", "plan_next"} <= names
    for metric in ("relational_sample.ms_per_step",
                   "block_build.ms_per_step"):
        assert metric in [m["name"] for m in cell.per_layer]
        assert spec.load_reader(metric)(w) > 0


def test_program_spans_read_nothing_where_the_program_has_none(traced_run):
    """A window without the program's spans (the parent's program, an
    untraced run) reads None, never a partial mean."""
    _, out = traced_run
    w = out["window"]
    kept = [r for r in w.spans.records
            if r[0] not in ("sample_relations", "build_blocks")]
    bare = cell_run.Window(config=w.config, traffic=w.traffic, t0=w.t0,
                           t1=w.t1, steps=w.steps,
                           spans=trace_mod.Spans(True), device_trace=None,
                           cache_hits=None, cache_misses=None)
    bare.spans.records = kept
    for metric in ("relational_sample.ms_per_step",
                   "block_build.ms_per_step"):
        assert spec.load_reader(metric)(bare) is None


def test_harness_graph_holds_the_configured_relations(tmp_path):
    """Each forward relation holds its configured count of distinct edges
    between its types' ids, its reverse the same edges the other way, and
    the data plane reads their union."""
    cell = tiny_rgat(tmp_path)
    cfg = cell.config
    inp = cell.family.make_inputs(cfg, cell.traffic, 3, torch.device("cpu"))
    graph = inp.extras["graph"]
    assert [r.name for r in graph.relations] == [
        name for _, name, _ in cfg["relations"]]

    def pairs(rel):
        lo = graph.type_range(rel.dst_type)[0]
        dst = np.repeat(np.arange(len(rel.indptr) - 1), rel.degrees()) + lo
        return set(zip(dst.tolist(), rel.indices.tolist()))
    by_name = {r.name: r for r in graph.relations}
    for name, n_edges in cfg["edges"].items():
        fwd = pairs(by_name[name])
        assert len(fwd) == by_name[name].num_edges == n_edges
        rev = by_name.get("rev_" + name)
        assert rev is None or pairs(rev) == {(s, d) for d, s in fwd}
    assert inp.indptr is graph.union().indptr
    assert inp.indptr[-1] == graph.num_edges
    assert 0 < len(inp.seed_pool) and inp.seed_pool.max() < cfg["nodes"][
        "paper"]


def _first_kept(cell, seed=5):
    inp, _, first, _ = cell_run.setup(cell, seed, torch.device("cpu"),
                                      trace_mod.Spans(False))
    return inp, [judge.to_host(k) for k in first]


@pytest.mark.parametrize("fault", ["cross_relation_id",
                                   "unmasked_degree_zero_slot"])
def test_bad_sample_ids_counts_a_planted_fault(tmp_path, fault):
    cell = tiny_rgat(tmp_path)
    inp, kept = _first_kept(cell)
    family, cfg, traffic = cell.family, cell.config, cell.traffic
    assert family.bad_sample_ids(cfg, traffic, inp, kept) == 0
    b = kept[0]
    names = [name for _, name, _ in cfg["relations"]]
    if fault == "cross_relation_id":
        # a cited paper's slot names an author, which lies in the next level
        blk = b["hops"][0][names.index("cites")]
        row, col = np.argwhere(blk["mask"])[0]
        author = int(next(v for v in b["levels"][1]
                          if v >= cfg["nodes"]["paper"]))
        blk["src"] = blk["src"].copy()
        blk["src"][row, col] = author
    else:
        # a slot unmasked at a destination with no edge in the relation
        hop = next(h for h in b["hops"] if any(
            (~r["mask"]).any() for r in h))
        blk = next(r for r in hop if (~r["mask"]).any())
        row = np.flatnonzero(~blk["mask"].any(axis=1))[0]
        blk["mask"] = blk["mask"].copy()
        blk["mask"][row, 0] = True
        blk["src"] = blk["src"].copy()
        blk["src"][row, 0] = blk["dst"][row]
    assert family.bad_sample_ids(cfg, traffic, inp, kept) >= 1


def test_reordered_reads_like_the_reference(tmp_path):
    """The control's witness: the same batch with every destination's
    slots reversed gives the same loss to round-off."""
    cell = tiny_rgat(tmp_path)
    inp, kept = _first_kept(cell, seed=6)
    family = cell.family
    cpu = torch.device("cpu")
    a = family.follow(cell.config, inp, kept, cpu)
    b = family.follow(cell.config, inp,
                      [family.reordered(k, cell.config) for k in kept], cpu)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
