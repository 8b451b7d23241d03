"""The `hgt` family at a tiny size on the CPU: a run comes out correct
through the loader's relational sampler and its program spans reach their
reader, a planted fault is caught, its inputs are the `rgat` family's bit
for bit, `hgt_attend`'s byte and launch counts are the hand count, and
each new reader reads nothing where the program left nothing."""
import json

import numpy as np
import pytest
import torch

from bench import cell as cell_run
from bench import judge, spec, yardstick
from bench import trace as trace_mod

from . import tiny
from .test_bench_rgat import TINY_RGAT

CELL = "hgt3-igbh.b1024"
METRICS = ("hgt_attend.ms_per_step", "hgt_attend_roofline",
           "hgt_slots.ms_per_step")


def tiny_tree(tmp_path):
    """(root, bench dir) with `hgt3-igbh` and `rgat3-igbh` both cut to
    IGBH's types at a tiny size (the same graph), tiny widths."""
    root, bench_dir = tiny.make_tree(tmp_path)
    for name in ("hgt3-igbh", "rgat3-igbh"):
        path = bench_dir / "configs" / f"{name}.json"
        path.write_text(json.dumps(json.loads(path.read_text())
                                   | TINY_RGAT))
    return root, bench_dir


def tiny_hgt(tmp_path) -> spec.Cell:
    root, bench_dir = tiny_tree(tmp_path)
    return spec.load_cell(CELL, root=root, bench_dir=bench_dir)


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    cell = tiny_hgt(tmp_path_factory.mktemp("hgt"))
    return cell, cell_run.run(cell, 2**31 + 43, 0.3, True,
                              torch.device("cpu"), 0.0)


def test_hgt_runs_correct_with_its_program_spans(traced_run):
    cell, out = traced_run
    assert cell.family.__file__.endswith("families/hgt.py")
    checks = out["checks"]
    assert checks["bad_sample_ids"]["value"] == 0
    assert judge.passed(checks), checks
    w = out["window"]
    assert w.step_flops is None
    assert all(set(s.kernels) == {"hgt_attend", "tiered_gather"}
               for s in w.steps)
    # the data plane's gather is counted as in R-GAT's cell, so that
    # `tiered_gather_roofline` can read this cell too
    assert all(s.kernels["tiered_gather"] == (yardstick.tiered_gather_bytes(
        s.staged_rows, cell.config["in_dim"]), 1) for s in w.steps)
    assert all(s.kernels["hgt_attend"][1] == 3 * len(cell.config["fanouts"])
               for s in w.steps)
    names = {n for n, _, _ in w.spans.records}
    assert {"sample_relations", "build_blocks", "hgt_slots", "feed",
            "plan_next"} <= names
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert spec.load_reader("hgt_slots.ms_per_step")(w) > 0
    # no device trace off the card: the kernels' readers read nothing
    for metric in METRICS[:2]:
        assert spec.load_reader(metric)(w) is None


def test_readers_read_nothing_where_the_program_left_nothing(traced_run):
    """A window without the program's `hgt_slots` spans or `hgt_attend`
    kernels (the parent's program, which has neither) reads None."""
    _, out = traced_run
    w = out["window"]
    ops = [("tiered_gather_kernel", w.t0, w.t0 + 1e-3),
           ("relation_attend_fwd_kernel", w.t0 + 2e-3, w.t0 + 3e-3)]
    bare = cell_run.Window(
        config=w.config, traffic=w.traffic, t0=w.t0, t1=w.t1, steps=w.steps,
        spans=trace_mod.Spans(True),
        device_trace=trace_mod.DeviceTrace(ops, w.t0, w.t1),
        cache_hits=None, cache_misses=None)
    bare.spans.records = [r for r in w.spans.records if r[0] != "hgt_slots"]
    for metric in METRICS:
        assert spec.load_reader(metric)(bare) is None, metric


def test_attend_readers_read_the_traced_kernels(traced_run):
    """With `hgt_attend`'s launches in the trace, the time a step and the
    roofline read them; a launch count other than the family's reads no
    roofline."""
    _, out = traced_run
    w = out["window"]
    per_step = w.steps[0].kernels["hgt_attend"][1]
    launches = per_step * len(w.steps)
    ops = [("void (anonymous namespace)::hgt_attend_fwd_kernel",
            w.t0 + i * 1e-4, w.t0 + i * 1e-4 + 2e-5) for i in range(launches)]
    traced = cell_run.Window(
        config=w.config, traffic=w.traffic, t0=w.t0, t1=w.t1, steps=w.steps,
        spans=w.spans, device_trace=trace_mod.DeviceTrace(ops, w.t0, w.t1),
        cache_hits=None, cache_misses=None)
    ms = spec.load_reader("hgt_attend.ms_per_step")(traced)
    assert ms == pytest.approx(launches * 2e-5 * 1e3 / len(w.steps))
    nbytes = sum(s.kernels["hgt_attend"][0] for s in w.steps)
    assert spec.load_reader("hgt_attend_roofline")(traced) == pytest.approx(
        100 * nbytes / yardstick.HBM_BYTES_PER_S / (launches * 2e-5))
    traced.device_trace.ops.pop()
    assert spec.load_reader("hgt_attend_roofline")(traced) is None


def _half_batch(model, feats, blocks, labels, lr):
    """Half of the batch left out: the mean loss over the first half of
    the seeds."""
    keep = len(labels) // 2
    z = model(feats, blocks)[:keep]
    loss = (torch.logsumexp(z, dim=-1)
            - z.gather(-1, labels[:keep].long()[:, None])[:, 0]).mean()
    model.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p -= lr * p.grad
    return loss.detach()


def test_half_batch_fault_is_not_correct(tmp_path, monkeypatch):
    cell = tiny_hgt(tmp_path)
    monkeypatch.setattr(cell.family, "sgd_step", _half_batch)
    out = cell_run.run(cell, 19, 0.2, False, torch.device("cpu"), 0.0)
    assert not judge.passed(out["checks"])
    c = out["checks"]["loss_gap"]
    assert c["value"] > c["limit"], c


def test_inputs_are_the_rgat_family_s_bit_for_bit(tmp_path):
    root, bench_dir = tiny_tree(tmp_path)
    hgt = spec.load_cell(CELL, root=root, bench_dir=bench_dir)
    rgat = spec.load_cell("rgat3-igbh.b1024", root=root, bench_dir=bench_dir)
    for key in ("nodes", "edges", "relations", "graph", "loader"):
        assert hgt.config[key] == rgat.config[key], key
    cpu = torch.device("cpu")
    a = hgt.family.make_inputs(hgt.config, hgt.traffic, 7, cpu)
    b = rgat.family.make_inputs(rgat.config, rgat.traffic, 7, cpu)
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices),
                 (a.features, b.features), (a.labels, b.labels),
                 (a.seed_pool, b.seed_pool)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for ra, rb in zip(a.extras["relations"], b.extras["relations"],
                      strict=True):
        assert ra["name"] == rb["name"]
        np.testing.assert_array_equal(ra["indptr"], rb["indptr"])
        np.testing.assert_array_equal(ra["indices"], rb["indices"])
    assert a.extras["types"] == b.extras["types"]
    # HGT's parameters in R-GAT's place, every leaf drawn from the seed
    assert "adapt.paper" in a.params and "adapt.paper" not in b.params
    mu = a.params["layer0.cites"]["mu"]
    assert not torch.equal(mu, torch.ones_like(mu))


def test_kernel_counts_are_the_hand_count(traced_run):
    """`hgt_attend`'s bytes worked out by hand at 256 floats a row in 8
    heads, float32.  A layer of 3 destinations, 5 slots and 4 k'/v' rows:
    forward reads q 3,072, k' and v' 8,192, indptr 16 and idx 20, writes
    out 3,072 and the log-sum-exp 96 (14,468); backward reads those and g
    3,072 and writes dq 3,072, dk' and dv' 8,192 (28,804).  A layer of 2
    destinations and no slot: forward q 2,048, indptr 12, out 2,048,
    log-sum-exp 64 (4,172); backward those, g 2,048 and dq 2,048 (8,268).
    A layer with no destination launches nothing.  Launches: 3 a layer
    with slots, 2 without (no row pass)."""
    cell, _ = traced_run
    cfg = dict(cell.config, hidden_dim=256, num_heads=8, in_dim=1024)
    step = cell_run.Step(wall_s=1.0, seeds=1, staged_rows=10, split_ms={})
    got = cell.family.kernel_counts(cfg, step, [(3, 5, 4), (2, 0, 0),
                                                (0, 0, 0)])
    assert got == {
        "hgt_attend": (14_468 + 28_804 + 4_172 + 8_268, 5),
        "tiered_gather": (yardstick.tiered_gather_bytes(10, 1024), 1)}


def test_attend_bytes_are_the_tensors_the_kernels_read_and_write():
    """On a small real case through the plain path: the forward's bytes
    are the nbytes of its inputs and outputs, the backward's those of
    what it reads (the forward's inputs, out, the log-sum-exp, g) and
    writes (dq, dk', dv')."""
    from bench.families import hgt as family
    from repro_torch.kernels.hgt_attend import (attend_backward_ref,
                                                attend_ref)
    gen = torch.Generator().manual_seed(3)
    n, R = 4, 6
    indptr = torch.tensor([0, 2, 2, 5, 9], dtype=torch.int32)
    idx = torch.tensor([0, 5, 1, 1, 2, 3, 4, 0, 5], dtype=torch.int32)
    q, k, v = (torch.randn((rows, 8, 32), generator=gen)
               for rows in (n, R, R))
    out, lse = attend_ref(q, k, v, indptr, idx)
    g = torch.randn(out.shape, generator=gen)
    grads = attend_backward_ref(g, q, k, v, indptr, idx, out, lse)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    forward = nbytes(q, k, v, indptr, idx, out, lse)
    backward = nbytes(q, k, v, indptr, idx, out, lse, g, *grads)
    assert family.hgt_attend_bytes(n, len(idx), R, 256, 8) == (forward,
                                                                backward)
