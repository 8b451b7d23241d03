"""The port's observability plane (repro_torch.obs and the loader's and
serve engine's tracer hooks) against the JAX package's on the CPU: twins of
tests/test_obs.py, and the span trees and metrics of both packages compared
span for span on the same numpy inputs.  A span tree must match in names,
tracks, cats, kinds, args, `dur` and, after layout, `t0`; a metrics
snapshot must match apart from the measured wall clock of the
`modelled_vs_measured.*` series, whose priced halves must match too.  The
wall spans of the reference's categories must match in order; the port's
own hot-path spans (category `HOT_PATH`) must be exactly the documented
set, each under its documented parent.

The reference's `test_deprecated_accessors_warn` has no twin: the port has
no deprecated `last_shard_burst` / `last_host_burst` accessors."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.core.dataplane import DataPlaneSpec as JSpec  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import attach_burst_spans as j_attach  # noqa: E402
from repro_torch.core import GIDSDataLoader, LoaderConfig  # noqa: E402
from repro_torch.core.dataplane import DataPlaneSpec  # noqa: E402
from repro_torch.core.pipeline import HOT_PATH_SPANS  # noqa: E402
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.obs import (NULL_METRICS, NULL_TRACER,  # noqa: E402
                             Counter, Gauge, Histogram, MetricsRegistry,
                             Tracer, attach_burst_spans, validate_events,
                             validate_trace, validate_tracer)
from repro_torch.obs.trace import HOT_PATH, NULL_SPAN, _jsonify  # noqa: E402


@pytest.fixture(scope="module")
def graphs_and_feats():
    feats = np.random.default_rng(3).standard_normal(
        (4_000, 24)).astype(np.float32)
    return jrmat(4_000, 12, 16, seed=7), rmat_graph(4_000, 12, 16, seed=7), \
        feats


def _loaders(gf, preset, jtracer=None, ttracer=None, **kw):
    jg, tg, feats = gf
    common = dict(batch_size=128, fanouts=(5, 5), cache_lines=2048,
                  window_depth=4, **kw)
    jspec, tspec = preset, preset
    if preset == "gids-device+merged+topology":
        jspec = JSpec.preset("gids-device", merge_execute=True,
                             topology=True)
        tspec = DataPlaneSpec.preset("gids-device", merge_execute=True,
                                     topology=True)
    jl = JLoader(jg, feats, JConfig(data_plane=jspec, **common),
                 tracer=jtracer)
    tl = GIDSDataLoader(tg, feats, LoaderConfig(data_plane=tspec, **common),
                        device="cpu", tracer=ttracer)
    return jl, tl


def span_rows(tracer) -> list[tuple]:
    """Every span of the tracer's trees, laid out, as comparable rows."""
    tracer._layout()
    return [(sp.name, sp.track, sp.cat, sp.kind, sp.parallel, sp.dur, sp.t0,
             json.dumps({k: _jsonify(v) for k, v in sp.args.items()},
                        sort_keys=True))
            for sp in tracer.spans()]


#: the port's hot-path spans and the stages each may open under, as the
#: loader documents them
DOCUMENTED_HOT_PATH = {
    "sample_blocks": ("plan_next",),
    "admit": ("plan_next", "execute_window"),
    "merge": ("execute_window",),
    "gather": ("execute", "execute_window"),
    "probe": ("gather",),
    "future_counts": ("probe",),
    "access": ("probe",),
    "stage_host": ("probe",),
    "probe_wait": ("probe",),
    "report": ("execute", "execute_window"),
    "price": ("execute", "execute_window"),
    "feedback": ("execute", "execute_window"),
}


def assert_hot_path_spans(ttr) -> None:
    """Every wall span of category HOT_PATH is a documented one under its
    documented parent; no span of the reference's categories opens under
    one of them."""
    assert HOT_PATH_SPANS == DOCUMENTED_HOT_PATH
    for w in ttr.wall_spans():
        if w.cat == HOT_PATH:
            assert w.name in DOCUMENTED_HOT_PATH, w.name
            assert w.parent is not None \
                and w.parent.name in DOCUMENTED_HOT_PATH[w.name], \
                (w.name, w.parent and w.parent.name)
        else:
            assert w.parent is None or w.parent.cat != HOT_PATH, w.name


def assert_same_trace(jtr, ttr) -> None:
    """Span trees equal span for span; metrics equal apart from the wall
    clock; the wall spans of the reference's categories equal in order,
    the port's own hot-path spans as documented; the exported virtual
    events equal event for event."""
    assert span_rows(jtr) == span_rows(ttr)
    js, ts = jtr.metrics.snapshot(), ttr.metrics.snapshot()
    assert js.keys() == ts.keys()
    for k in js:
        if k.startswith("modelled_vs_measured."):
            assert [p["modelled_s"] for p in js[k]["points"]] \
                == [p["modelled_s"] for p in ts[k]["points"]], k
        else:
            assert js[k] == ts[k], k
    assert HOT_PATH not in {w.cat for w in jtr.wall_spans()}
    ref_cats = [w for w in ttr.wall_spans() if w.cat != HOT_PATH]
    assert [w.name for w in jtr.wall_spans()] == [w.name for w in ref_cats]
    assert [w.dur for w in jtr.wall_spans()] == [w.dur for w in ref_cats]
    assert_hot_path_spans(ttr)

    def virtual(events):
        return [e for e in events if e["pid"] == 1]
    assert virtual(jtr.chrome_events()) == virtual(ttr.chrome_events())


# -- metrics registry ----------------------------------------------------------

def test_registry_instruments():
    m = MetricsRegistry()
    m.counter("a").inc()
    m.counter("a").inc(2.5)
    m.gauge("g").set(4.0)
    h = m.histogram("h")
    for v in (1.0, 2.0, 3.0):
        h.observe(v)
    m.series("s").append({"x": 1})
    assert m.counter("a").value == 3.5
    assert m.gauge("g").value == 4.0
    assert h.count == 3 and h.mean == 2.0 and h.min == 1.0 and h.max == 3.0
    snap = m.snapshot()
    assert snap["a"]["type"] == "counter" and snap["a"]["value"] == 3.5
    assert snap["h"]["count"] == 3
    assert snap["s"]["points"] == [{"x": 1}]
    json.dumps(snap)
    from repro.obs import MetricsRegistry as JRegistry
    ref = JRegistry()
    ref.counter("a").inc()
    ref.counter("a").inc(2.5)
    ref.gauge("g").set(4.0)
    for v in (1.0, 2.0, 3.0):
        ref.histogram("h").observe(v)
    ref.series("s").append({"x": 1})
    assert ref.snapshot() == snap
    m.reset()
    assert m.snapshot() == {}


def test_registry_get_or_create_is_stable():
    m = MetricsRegistry()
    assert m.counter("x") is m.counter("x")
    with pytest.raises(TypeError):
        m.gauge("x")


def test_null_metrics_inert():
    NULL_METRICS.counter("x").inc(5)
    NULL_METRICS.histogram("y").observe(1.0)
    assert NULL_METRICS.snapshot() == {}


def test_instrument_classes_standalone():
    c, g, h = Counter("c"), Gauge("g"), Histogram("h")
    c.inc(2)
    g.set(-1.0)
    h.observe(0.5)
    assert c.value == 2 and g.value == -1.0 and h.count == 1


# -- span trees and export -----------------------------------------------------

def _build_small(tracer_cls):
    tr = tracer_cls()
    root = tr.batch("batch", index=0)
    root.child("sample", 2.0)
    root.child("gather", 3.0)
    root.child("shard0", 2.5, track="shard0", parallel=True)
    root.close()
    tr.instant("migration", cost_s=0.25)
    return tr, root


def test_span_tree_layout_and_reconcile():
    tr, root = _build_small(Tracer)
    assert root.dur == 5.0
    assert root.reconcile_error() == 0.0
    assert tr.max_reconcile_error() == 0.0
    assert validate_tracer(tr) == []
    seq = [c for c in root.children if not c.parallel]
    assert seq[0].t0 == root.t0 and seq[1].t0 == root.t0 + 2.0
    par = [c for c in root.children if c.parallel][0]
    assert par.t0 == root.t0
    jtr, _ = _build_small(JTracer)
    assert span_rows(jtr) == span_rows(tr)


def test_chrome_export_schema():
    def build(cls):
        tr = cls()
        root = tr.batch("batch")
        root.child("gather", 1.0, rows=np.int64(7))
        root.close()
        tr.instant("migration", cost_s=0.25)
        with tr.stage("plan_next") as sp:
            sp.modelled(1.0)
        return tr
    tr, jtr = build(Tracer), build(JTracer)
    events = tr.chrome_events()
    assert validate_events(events) == []
    by_ph = {}
    for ev in events:
        by_ph.setdefault(ev["ph"], []).append(ev)
    assert len(by_ph["X"]) == 3 and len(by_ph["i"]) == 1
    gather = next(e for e in by_ph["X"] if e["name"] == "gather")
    assert gather["args"]["rows"] == 7 and isinstance(
        gather["args"]["rows"], int)
    json.dumps(events)
    assert_same_trace(jtr, tr)


def test_trace_write_is_perfetto_loadable(tmp_path):
    tr = Tracer()
    tr.batch("b").child("g", 1.0)
    path = tmp_path / "trace.json"
    tr.write(str(path))
    doc = json.loads(path.read_text())
    assert "traceEvents" in doc
    assert validate_trace(doc) == []
    jtr = JTracer()
    jtr.batch("b").child("g", 1.0)
    jtr.write(str(tmp_path / "ref.json"))
    assert (tmp_path / "ref.json").read_text() == path.read_text()


def test_validate_catches_escaping_child():
    tr = Tracer()
    root = tr.batch("b")
    root.child("too-long", 2.0)
    root.close(1.0)
    assert any("escapes" in p for p in validate_tracer(tr))


def test_modelled_vs_measured_series():
    tr = Tracer()
    with tr.stage("execute") as sp:
        sp.modelled(0.25)
    pts = tr.metrics.series("modelled_vs_measured.execute").points
    assert len(pts) == 1
    p = pts[0]
    assert p["modelled_s"] == 0.25 and p["measured_s"] >= 0.0
    assert p["gap_s"] == p["measured_s"] - p["modelled_s"]


def test_null_tracer_records_nothing():
    s = NULL_TRACER.batch("b")
    assert s.child("x", 1.0) is s
    with NULL_TRACER.stage("s") as sp:
        sp.modelled(1.0)
    assert NULL_TRACER.chrome_events() == []
    assert NULL_TRACER.metrics.snapshot() == {}


def test_wall_spans_nest_and_self_time():
    """A stage opened inside another, and spans recorded from clock reads
    the caller took, record the innermost open stage as their parent; a
    span's self time is its duration less what its children cover (their
    union where they overlap)."""
    tr = Tracer()
    with tr.stage("outer", cat="stage") as outer:
        with tr.stage("inner", cat=HOT_PATH) as inner:
            t = time.perf_counter()
            a = tr.record("a", t, t + 2e-3, rows=3)
            b = tr.record("b", t + 1e-3, t + 4e-3)
        c = tr.record("c", t + 5e-3, t + 6e-3)
    top = tr.record("top", t, t + 1.0)
    assert inner.parent is outer and outer.parent is None
    assert a.parent is inner and b.parent is inner and c.parent is outer
    assert top.parent is None
    assert outer.children == [inner, c] and inner.children == [a, b]
    assert a.cat == HOT_PATH and a.args == {"rows": 3}
    assert a.wall_t0 == t and a.wall_dur == pytest.approx(2e-3)
    assert inner.self_time() == pytest.approx(inner.wall_dur - 4e-3)
    assert outer.self_time() == pytest.approx(
        outer.wall_dur - inner.wall_dur - c.wall_dur)
    assert a.self_time() == a.wall_dur
    # closed in order: children before their parents
    assert [w.name for w in tr.wall_spans()] \
        == ["a", "b", "inner", "c", "outer", "top"]
    assert tr._open == []


def test_exported_wall_ts_maps_back_to_perf_counter(tmp_path):
    """The written trace names the clock and base its wall `ts` count from:
    base + ts is each span's `perf_counter` start."""
    tr = Tracer()
    with tr.stage("plan_next"):
        with tr.stage("sample_blocks", cat=HOT_PATH):
            pass
    t = time.perf_counter()
    tr.record("probe_wait", t, t + 1e-3)
    path = tmp_path / "trace.json"
    tr.write(str(path))
    doc = json.loads(path.read_text())
    assert validate_trace(doc) == []
    other = doc["otherData"]
    assert other["wall_clock"] == "time.perf_counter"
    assert other["wall_base_us"] == tr.wall_base() * 1e6
    wall = [e for e in doc["traceEvents"] if e["pid"] == 2 and e["ph"] == "X"]
    assert [e["name"] for e in wall] \
        == [w.name for w in tr.wall_spans()]
    for e, w in zip(wall, tr.wall_spans()):
        assert (other["wall_base_us"] + e["ts"]) * 1e-6 \
            == pytest.approx(w.wall_t0, abs=1e-9)
        assert e["dur"] == pytest.approx(w.wall_dur * 1e6)
    assert {e["cat"] for e in wall} == {"stage", HOT_PATH}


def _device_loaders(gf, sampler, tracer=None, jtracer=None):
    jg, tg, feats = gf
    common = dict(batch_size=128, fanouts=(5, 5), cache_lines=2048,
                  window_depth=4, data_plane="gids-device", sampler=sampler,
                  ladies_layer_sizes=(256, 256))
    jl = JLoader(jg, feats, JConfig(**common), tracer=jtracer)
    tl = GIDSDataLoader(tg, feats, LoaderConfig(**common), device="cpu",
                        tracer=tracer)
    return jl, tl


@pytest.mark.parametrize("sampler", ["neighbor", "ladies"])
def test_device_tier_spans_under_execute(graphs_and_feats, sampler):
    """On a `gids-device` loader the device tier's host stages are spans
    under its `probe`, under `gather`, under `execute`; batches and priced
    floats are bit-identical with and without a tracer, and the traced
    run's trees, metrics and reference-category wall spans equal the
    reference's."""
    _, plain = _device_loaders(graphs_and_feats, sampler)
    jtr, tr = JTracer(), Tracer()
    ref, _ = _device_loaders(graphs_and_feats, sampler, jtracer=jtr)
    _, traced = _device_loaders(graphs_and_feats, sampler, tracer=tr)
    for _ in range(6):
        a, b = plain.next_batch(), traced.next_batch()
        ref.next_batch()
        assert a.prep_time_s == b.prep_time_s
        assert a.report == b.report
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert torch.equal(a.features, b.features)
    assert validate_trace(tr) == []
    assert_same_trace(jtr, tr)
    tier = traced.store.tiers[0]
    assert tier.tracer is tr and traced.store.tracer is tr
    assert plain.store.tiers[0].tracer is NULL_TRACER
    executes = [w for w in tr.wall_spans() if w.name == "execute"]
    assert len(executes) == 6
    for ex in executes:
        assert [c.name for c in ex.children] \
            == ["gather", "report", "price", "feedback"]
        gather = ex.children[0]
        probes = gather.children
        assert [p.args["tier"] for p in probes] \
            == [t.name for t in traced.store.tiers][:len(probes)]
        top = probes[0]
        # the wait for the access's verdict, the staging of the rows the
        # card reads from the staged buffer (the misses), the final wait
        assert [c.name for c in top.children] \
            == ["future_counts", "probe_wait", "stage_host", "probe_wait"]
        stage = top.children[2]
        assert top.args["rows"] == stage.args["rows"]
        assert stage.args["staged"] == top.args["rows"] - top.args["hits"]
        assert stage.args["bytes"] \
            == stage.args["staged"] * traced.store.feature_dim * 4
        assert 0 <= top.args["hits"] <= top.args["rows"]
        assert ex.self_time() >= 0.0 and gather.self_time() >= 0.0
    # the window of future batches was full from the first probe on
    assert all(w.args["ids"] > 0 for w in tr.wall_spans()
               if w.name == "future_counts")
    plans = [w for w in tr.wall_spans() if w.name == "plan_next"]
    assert {c.name for p in plans for c in p.children} \
        == {"sample_blocks", "admit"}


def test_null_tracer_records_nothing_on_the_hot_path(graphs_and_feats):
    """A loader without a tracer hands its store and tiers the shared no-op
    tracer, which keeps nothing of their spans."""
    _, dl = _device_loaders(graphs_and_feats, "neighbor")
    for _ in range(3):
        dl.next_batch()
    assert dl.tracer is NULL_TRACER and dl.store.tracer is NULL_TRACER
    assert all(getattr(t, "tracer", NULL_TRACER) is NULL_TRACER
               for t in dl.store.tiers)
    assert NULL_TRACER.wall_spans() == [] and NULL_TRACER.roots() == []
    assert NULL_TRACER.record("probe_wait", 0.0, 1.0, rows=1) is NULL_SPAN
    assert NULL_TRACER.wall_spans() == []
    assert NULL_TRACER.chrome_events() == []
    assert NULL_TRACER.metrics.snapshot() == {}


def test_attach_burst_spans_duck_typed():
    class FakeBurst:
        per_shard_s = (0.5, 0.0)
        per_shard_rows = (10, 0)
        per_shard_lines = (4, 0)

        def recovery_events(self):
            return [("retry", 0, {"lines": 2, "recovery_s": 0.1})]

    trs = []
    for cls, attach in ((JTracer, j_attach), (Tracer, attach_burst_spans)):
        tr = cls()
        root = tr.batch("b")
        g = root.child("gather", 0.5)
        attach(g, FakeBurst())
        assert [c.name for c in g.children] == ["shard0", "fault/retry"]
        assert all(c.parallel for c in g.children)
        root.close()
        assert validate_tracer(tr) == []
        trs.append(tr)
    assert span_rows(trs[0]) == span_rows(trs[1])


# -- bit-invisibility over the priced pipeline ---------------------------------

PRESETS = ["gids", "gids-merged", "gids-topo-merged", "gids-merged-sharded",
           "gids-hosts-merged"]


def _preset_kwargs(preset):
    if preset == "gids-merged-sharded":
        return {"n_shards": 4}
    if preset == "gids-hosts-merged":
        return {"n_hosts": 4, "placement": "metis-lite"}
    return {}


@pytest.mark.parametrize("preset", PRESETS)
def test_tracer_bit_invisible(graphs_and_feats, preset):
    """An enabled tracer vs none: every priced time and every gathered byte
    exactly equal, and the traced run's trees equal the reference's."""
    kw = _preset_kwargs(preset)
    _, plain = _loaders(graphs_and_feats, preset, **kw)
    jtr, ttr = JTracer(), Tracer()
    ref, traced = _loaders(graphs_and_feats, preset, jtr, ttr, **kw)
    for _ in range(6):
        a, b = plain.next_batch(), traced.next_batch()
        ref.next_batch()
        assert a.prep_time_s == b.prep_time_s
        assert a.sample_time_s == b.sample_time_s
        np.testing.assert_array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        assert torch.equal(a.features, b.features)
    assert validate_trace(ttr) == []
    assert_same_trace(jtr, ttr)


def _fault_schedule(mod):
    return mod.FaultSchedule(events=(
        mod.BrownoutEvent(shard=2, start=0, end=90, multiplier=10.0),
        mod.OutageEvent(shard=0, start=1, end=7),
        mod.FlakyReadsEvent(shard=1, start=0, end=90, fail_prob=0.4)),
        seed=3)


#: the planes whose trees and metrics must equal the reference's
TREE_PLANES = {
    "gids": {},
    "gids-async": {},
    "gids-merged": {},
    "gids-topo-merged": {},
    "gids-device+merged+topology": {},
    "gids-sharded+faults": dict(n_shards=4, placement="adaptive",
                                replication_factor=2, rebalance_interval=2),
    "gids-hosts-merged": dict(n_hosts=4, placement="metis-lite"),
}


@pytest.mark.parametrize("plane", sorted(TREE_PLANES))
def test_span_trees_and_metrics_match_reference(graphs_and_feats, plane):
    kw = dict(TREE_PLANES[plane])
    preset = plane
    jkw = dict(kw)
    if plane == "gids-sharded+faults":
        from repro.core import faults as jfaults
        from repro_torch.core import faults as tfaults
        preset = "gids-sharded"
        jkw["fault_schedule"] = _fault_schedule(jfaults)
        kw["fault_schedule"] = _fault_schedule(tfaults)
    jtr, ttr = JTracer(), Tracer()
    jg, tg, feats = graphs_and_feats
    jl, _ = _loaders(graphs_and_feats, preset, jtr, None, **jkw)
    _, tl = _loaders(graphs_and_feats, preset, None, ttr, **kw)
    for _ in range(10):
        a, b = jl.next_batch(), tl.next_batch()
        assert a.prep_time_s == b.prep_time_s
    assert validate_trace(ttr) == []
    assert_same_trace(jtr, ttr)
    roots = [r for r in ttr.roots() if r.name == "batch"]
    assert len(roots) >= 10
    if plane == "gids-sharded+faults":
        # the migrations, and the retries and hedges, were traced
        assert {i.name for i in ttr.instants()} == {"migration"}
        snap = ttr.metrics.snapshot()
        assert snap["controller.migrations"]["value"] >= 1
        assert snap["faults.retry_events"]["value"] >= 1


def test_tracer_bit_invisible_across_checkpoint(graphs_and_feats):
    """Checkpoint mid-window and resume, untraced and traced: the traced
    pair replays the untraced pair bit for bit, and the resumed trace
    equals the reference's resumed trace."""
    def resume_run(tracer_factory, pick):
        first = pick(_loaders(graphs_and_feats, "gids-merged",
                              tracer_factory(), tracer_factory()))
        got = [first.next_batch() for _ in range(3)]
        state = first.state_dict()
        resumed = pick(_loaders(graphs_and_feats, "gids-merged",
                                tracer_factory(), tracer_factory()))
        resumed.load_state_dict(state)
        got += [resumed.next_batch() for _ in range(3)]
        return got, resumed

    port = lambda pair: pair[1]  # noqa: E731
    want, _ = resume_run(lambda: None, port)
    got, resumed = resume_run(Tracer, port)
    for a, b in zip(want, got):
        assert a.prep_time_s == b.prep_time_s
        assert torch.equal(a.features, b.features)
    assert validate_trace(resumed.tracer) == []
    _, jresumed = resume_run(JTracer, lambda pair: pair[0])
    assert span_rows(jresumed.tracer) == span_rows(resumed.tracer)


def test_trace_covers_pipeline_stages(graphs_and_feats):
    tr = Tracer()
    _, dl = _loaders(graphs_and_feats, "gids-topo-merged", None, tr)
    for _ in range(6):
        dl.next_batch()
    roots = tr.roots()
    names = {sp.name for r in roots for sp in r.walk()}
    assert any(r.name.startswith("window") for r in roots)
    assert any(n.startswith("sample/hop") for n in names)
    assert "merged_gather" in names and "gather_share" in names
    wall = {w.name for w in dl.tracer.wall_spans()}
    assert {"plan_next", "execute_window", "sample"} <= wall
    snap = tr.metrics.snapshot()
    assert snap["pipeline.batches"]["value"] >= 6.0
    assert "topo.hops" in snap and "topo.edge_reads" in snap
    assert any(k.startswith("modelled_vs_measured.") for k in snap)
    assert any(k.startswith("tier.") and k.endswith("hit_ratio")
               for k in snap)


def test_fault_recovery_spans(graphs_and_feats):
    """Retry, hedge and failover telemetry surfaces as parallel fault spans
    and faults.* counters, equal to the reference's."""
    from repro.core import faults as jfaults
    from repro_torch.core import faults as tfaults
    jtr, tr = JTracer(), Tracer()
    kw = dict(n_shards=4, placement="degree", replication_factor=2)
    jl, _ = _loaders(graphs_and_feats, "gids-merged-sharded", jtr, None,
                     fault_schedule=_fault_schedule(jfaults), **kw)
    _, dl = _loaders(graphs_and_feats, "gids-merged-sharded", None, tr,
                     fault_schedule=_fault_schedule(tfaults), **kw)
    for _ in range(16):
        jl.next_batch()
        dl.next_batch()
    fault_spans = [sp for r in tr.roots() for sp in r.walk()
                   if sp.name.startswith("fault/")]
    assert fault_spans, "fault schedule produced no fault spans"
    snap = tr.metrics.snapshot()
    assert any(k.startswith("faults.") for k in snap)
    assert snap["storage.bursts"]["value"] > 0
    assert validate_trace(tr) == []
    assert_same_trace(jtr, tr)


def test_controller_commits_are_instants_and_counters(graphs_and_feats):
    """The rebalancer's migrations and the refresher's topology refreshes
    land as controller instants and controller.* counters, as the
    reference's do."""
    jg, tg, feats = graphs_and_feats
    out = []
    for cls, loader_cls, cfg_cls, g, dev in (
            (JTracer, JLoader, JConfig, jg, {}),
            (Tracer, GIDSDataLoader, LoaderConfig, tg, {"device": "cpu"})):
        tr = cls()
        hot = np.arange(400)
        dl = loader_cls(g, feats, cfg_cls(
            batch_size=128, fanouts=(5, 5), data_plane="gids-topo",
            cache_lines=256, window_depth=2, topo_admission="adaptive",
            rebalance_interval=1, migration_horizon=512), train_ids=hot,
            tracer=tr, **dev)
        for _ in range(8):
            dl.next_batch()
        out.append(tr)
    jtr, tr = out
    names = {i.name for i in tr.instants()}
    assert "topo_refresh" in names
    assert tr.metrics.snapshot()["controller.refreshes"]["value"] >= 1
    assert_same_trace(jtr, tr)


def test_cluster_and_tier_metrics_match_reference(graphs_and_feats):
    from repro.core.tiers import record_tier_metrics as j_record
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.core.tiers import record_tier_metrics
    jl, tl = _loaders(graphs_and_feats, "gids-hosts-merged", n_hosts=4,
                      placement="metis-lite")
    for _ in range(4):
        jl.next_batch()
        tl.next_batch()
    jm, tm = JRegistry(), MetricsRegistry()
    jl.store.tiers[-1].record_metrics(jm)
    tl.store.tiers[-1].record_metrics(tm)
    j_record(jl.store.tiers, jm)
    record_tier_metrics(tl.store.tiers, tm)
    assert jm.snapshot() == tm.snapshot()
    assert "hosts.cut_edge_fraction" in tm.snapshot()


# -- telemetry reset on restore ------------------------------------------------

def test_restore_clears_stale_burst_telemetry(graphs_and_feats):
    tr = Tracer()
    _, dl = _loaders(graphs_and_feats, "gids-merged-sharded", None, tr,
                     n_shards=4)
    for _ in range(4):
        dl.next_batch()
    assert dl.timeline.shard_burst is not None
    state = dl.state_dict()
    assert dl.tracer.metrics.snapshot()
    dl.load_state_dict(state)
    assert dl.timeline.shard_burst is None
    assert dl.tracer.roots() == []
    assert dl.tracer.metrics.snapshot() == {}
    assert dl.next_batch().prep_time_s > 0.0
    assert dl.timeline.shard_burst is not None


# -- serve engine --------------------------------------------------------------

def _serve_setup():
    from repro import serve as jserve
    from repro_torch import serve as tserve
    feats = np.random.default_rng(0).standard_normal(
        (2_000, 16)).astype(np.float32)
    streams = [mod.generate_stream(
        2_000, [mod.TenantSpec("a"), mod.TenantSpec("b", arrival="mmpp")],
        offered_qps=2000, n_requests=40, seed=5) for mod in (jserve, tserve)]
    return (jrmat(2_000, 10, 16, seed=3), rmat_graph(2_000, 10, 16, seed=3),
            feats, streams)


def test_serve_tracer_bit_invisible():
    from repro import serve as jserve
    from repro_torch.serve import GNNServeConfig, GNNServeEngine
    jg, g, feats, (jreqs, reqs) = _serve_setup()
    cfg = dict(fanouts=(5, 3), cache_lines=512, tenants=2)
    r0 = GNNServeEngine(g, feats, GNNServeConfig(**cfg),
                        device="cpu").run(reqs)
    tr = Tracer()
    r1 = GNNServeEngine(g, feats, GNNServeConfig(**cfg), tracer=tr,
                        device="cpu").run(reqs)
    for a, b in zip(r0.records, r1.records):
        assert (a.rid, a.latency_s, a.queue_wait_s, a.sample_s, a.gather_s,
                a.forward_s, a.rejected) == \
               (b.rid, b.latency_s, b.queue_wait_s, b.sample_s, b.gather_s,
                b.forward_s, b.rejected)
    assert validate_trace(tr) == []
    snap = tr.metrics.snapshot()
    assert snap["serve.requests"]["value"] == len(reqs)
    assert snap["serve.windows"]["value"] == len(r1.windows)
    req_spans = [r for r in tr.roots() if r.name == "request"]
    assert len(req_spans) == len(r1.served)
    assert {sp.track for sp in req_spans} <= {"tenant0", "tenant1"}
    jtr = JTracer()
    jserve.GNNServeEngine(jg, feats, jserve.GNNServeConfig(**cfg),
                          tracer=jtr).run(jreqs)
    assert_same_trace(jtr, tr)
