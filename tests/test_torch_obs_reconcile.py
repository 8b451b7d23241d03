"""Span-sum reconciliation through the port on the CPU: twins of
tests/test_obs_reconcile.py, each also holding the port's spans to the
reference's, and the fig_trace headline of benchmarks/fig_trace.py computed
through the port and held against the reference's own run here.

On `gids-topo-merged` the reference's batch trees do not sum exactly to
their prep time (a 1.36e-20 s residue, ROADMAP.md Queue 3 item 3), and its
fig_trace `max_reconcile_error` is 1.0842021724855044e-19 where
BENCH_pr10.json has 0.0.  The port matches the reference's floats, so these
twins hold the port's residue equal to the reference's instead of asserting
an exact 0.0 there."""
import pytest

torch = pytest.importorskip("torch")

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import GIDSDataLoader as JLoader  # noqa: E402
from repro.core import LoaderConfig as JConfig  # noqa: E402
from repro.graph.synthetic import rmat_graph as jrmat  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro_torch.core import (SAMSUNG_980PRO, GIDSDataLoader,  # noqa: E402
                              LoaderConfig)
from repro_torch.graph.synthetic import rmat_graph  # noqa: E402
from repro_torch.obs import Tracer, validate_trace  # noqa: E402
from repro_torch.obs.trace import HOT_PATH  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EPS = 1e-9


@pytest.fixture(scope="module")
def graphs_and_feats():
    feats = np.random.default_rng(1).standard_normal(
        (4_000, 24)).astype(np.float32)
    return jrmat(4_000, 12, 16, seed=2), rmat_graph(4_000, 12, 16, seed=2), \
        feats


def _run_traced(gf, preset, n_batches=8, **kw):
    """The port's traced run and the reference's, on the same inputs."""
    jg, tg, feats = gf
    cfg = dict(batch_size=128, fanouts=(5, 5), data_plane=preset,
               cache_lines=2048, window_depth=4, **kw)
    jtr, tr = JTracer(), Tracer()
    jl = JLoader(jg, feats, JConfig(**cfg), tracer=jtr)
    dl = GIDSDataLoader(tg, feats, LoaderConfig(**cfg), device="cpu",
                        tracer=tr)
    batches = [dl.next_batch() for _ in range(n_batches)]
    jbatches = [jl.next_batch() for _ in range(n_batches)]
    assert [b.prep_time_s for b in batches] \
        == [b.prep_time_s for b in jbatches]
    return tr, batches, jtr


def _spans(tracer):
    tracer._layout()
    return [(sp.name, sp.track, sp.dur, sp.t0, sp.reconcile_error())
            for sp in tracer.spans()]


PRESETS = [
    ("gids", {}),
    ("gids-merged", {}),
    ("gids-topo-merged", {}),
    ("gids-merged-sharded", {"n_shards": 4}),
    ("gids-hosts-merged", {"n_hosts": 4, "placement": "metis-lite"}),
]


@pytest.mark.parametrize("preset,kw", PRESETS, ids=[p for p, _ in PRESETS])
def test_batch_span_tree_sums_to_prep_time(graphs_and_feats, preset, kw):
    """Each batch root's duration IS its prep time; its sequential children
    account for it with the reference's exact float error (0.0 but on
    gids-topo-merged, where both packages leave the same residue)."""
    tr, batches, jtr = _run_traced(graphs_and_feats, preset, **kw)
    roots = [r for r in tr.roots() if r.name == "batch"]
    jroots = [r for r in jtr.roots() if r.name == "batch"]
    assert len(roots) == len(batches)
    for root, jroot, batch in zip(roots, jroots, batches):
        assert root.dur == batch.prep_time_s
        assert root.reconcile_error() == jroot.reconcile_error()
        if preset != "gids-topo-merged":
            assert root.reconcile_error() == 0.0
    assert tr.max_reconcile_error() <= EPS
    assert tr.max_reconcile_error() == jtr.max_reconcile_error()
    assert validate_trace(tr) == []
    assert _spans(tr) == _spans(jtr)


@pytest.mark.parametrize("preset,kw", PRESETS, ids=[p for p, _ in PRESETS])
def test_window_spans_account_merged_bursts(graphs_and_feats, preset, kw):
    """A window span's duration equals the sum of its batches' gather
    shares: merged amortization is conserved."""
    tr, _, jtr = _run_traced(graphs_and_feats, preset, **kw)
    batch_roots = [r for r in tr.roots() if r.name == "batch"]
    for win in (r for r in tr.roots() if r.name == "window"):
        gather = next(c for c in win.children if c.name == "merged_gather")
        members = [b for b in batch_roots
                   if b.args.get("window") == win.args["index"]]
        assert len(members) == win.args["batches"]
        shares = [sp.dur for b in members for sp in b.walk()
                  if sp.name == "gather_share"]
        assert len(shares) == len(members)
        assert abs(sum(shares) - win.dur) <= EPS * max(win.dur, 1.0)
        assert gather.dur <= win.dur + EPS
    assert [r.dur for r in tr.roots() if r.name == "window"] \
        == [r.dur for r in jtr.roots() if r.name == "window"]


def _serve_pair(specs_of, qps, n, seed, cfg):
    from repro import serve as jserve
    from repro_torch import serve as tserve
    feats = np.random.default_rng(0).standard_normal(
        (2_000, 16)).astype(np.float32)
    out = []
    for mod, g, tracer, dev in (
            (jserve, jrmat(2_000, 10, 16, seed=3), JTracer(), {}),
            (tserve, rmat_graph(2_000, 10, 16, seed=3), Tracer(),
             {"device": "cpu"})):
        reqs = mod.generate_stream(2_000, specs_of(mod), offered_qps=qps,
                                   n_requests=n, seed=seed)
        res = mod.GNNServeEngine(g, feats, mod.GNNServeConfig(**cfg),
                                 tracer=tracer, **dev).run(reqs)
        out.append((tracer, res))
    assert _spans(out[0][0]) == _spans(out[1][0])
    return out[1]


def test_serve_breakdown_sums_to_latency():
    """Every served record: queue wait + window burst + batched forward ==
    end-to-end latency, and the request's own shares never exceed the
    window totals."""
    tr, result = _serve_pair(
        lambda m: [m.TenantSpec("a"), m.TenantSpec("b", arrival="mmpp")],
        2000, 48, 5, dict(fanouts=(5, 3), cache_lines=512, tenants=2))
    req_spans = {sp.args["rid"]: sp for sp in tr.roots()
                 if sp.name == "request"}
    assert len(req_spans) == len(result.served)
    for rec in result.served:
        sp = req_spans[rec.rid]
        assert sp.reconcile_error() <= EPS
        assert abs(sp.dur - rec.latency_s) <= EPS
        parts = {c.name: c for c in sp.children}
        assert parts["queue_wait"].dur == rec.queue_wait_s
        assert rec.gather_s <= parts["gather"].dur + EPS
        assert rec.forward_s <= parts["forward"].dur + EPS
    assert validate_trace(tr) == []


def test_serve_window_spans_match_window_traces():
    tr, result = _serve_pair(lambda m: [m.TenantSpec("a")], 1500, 32, 7,
                             dict(fanouts=(4, 3), cache_lines=512))
    spans = [r for r in tr.roots() if r.name == "serve_window"]
    assert len(spans) == len(result.windows)
    for sp, w in zip(spans, result.windows):
        assert sp.t0 == w.start_s
        assert sp.dur == w.service_s
        gather = next(c for c in sp.children if c.name == "gather")
        assert gather.dur == w.burst_s
        assert sp.reconcile_error() <= EPS


def test_modelled_vs_measured_gap_recorded_per_stage(graphs_and_feats):
    tr, _, jtr = _run_traced(graphs_and_feats, "gids-topo-merged")
    snap = tr.metrics.snapshot()
    gaps = {k: v for k, v in snap.items()
            if k.startswith("modelled_vs_measured.")}
    assert {"modelled_vs_measured.plan_next",
            "modelled_vs_measured.execute_window",
            "modelled_vs_measured.sample"} <= set(gaps)
    jsnap = jtr.metrics.snapshot()
    for name, series in gaps.items():
        for p in series["points"]:
            assert p["gap_s"] == p["measured_s"] - p["modelled_s"]
            assert p["measured_s"] >= 0.0
        assert [p["modelled_s"] for p in series["points"]] \
            == [p["modelled_s"] for p in jsnap[name]["points"]]


@pytest.mark.parametrize("batch_size,fanout,window_depth,n_batches", [
    (16, 2, 1, 3), (64, 5, 3, 7), (256, 8, 6, 10), (37, 3, 2, 5),
    (128, 6, 4, 8)])
def test_reconciliation_grid(batch_size, fanout, window_depth, n_batches):
    """The reference's seeded reconciliation grid through the port: every
    batch root is its prep time and sums exactly, as the reference's."""
    feats = np.zeros((1_000, 8), np.float32)
    gf = (jrmat(1_000, 8, 8, seed=4), rmat_graph(1_000, 8, 8, seed=4), feats)
    jg, tg, _ = gf
    cfg = dict(batch_size=batch_size, fanouts=(fanout, fanout),
               data_plane="gids-merged", cache_lines=1024,
               window_depth=window_depth)
    tr, jtr = Tracer(), JTracer()
    dl = GIDSDataLoader(tg, feats, LoaderConfig(**cfg), device="cpu",
                        tracer=tr)
    jl = JLoader(jg, feats, JConfig(**cfg), tracer=jtr)
    batches = [dl.next_batch() for _ in range(n_batches)]
    for _ in range(n_batches):
        jl.next_batch()
    roots = [r for r in tr.roots() if r.name == "batch"]
    for root, batch in zip(roots, batches):
        assert root.dur == batch.prep_time_s
        assert root.reconcile_error() == 0.0
    assert validate_trace(tr) == []
    assert _spans(tr) == _spans(jtr)


# -- fig_trace -----------------------------------------------------------------

def _fig_trace_headline(iters=16):
    """benchmarks/fig_trace.py's `headline()`, spelled with the port."""
    g = rmat_graph(20_000, 12, 32, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.num_nodes, 32)).astype(np.float32)

    def loader(tracer=None):
        return GIDSDataLoader(g, feats, LoaderConfig(
            batch_size=256, fanouts=(10, 5), data_plane="gids-topo-merged",
            cache_lines=4096, window_depth=4, seed=3),
            ssd=SAMSUNG_980PRO, tracer=tracer, device="cpu")
    plain = loader()
    untraced = [plain.next_batch() for _ in range(iters)]
    tracer = Tracer()
    dl = loader(tracer)
    traced = [dl.next_batch() for _ in range(iters)]
    invisible = all(
        a.prep_time_s == b.prep_time_s and a.sample_time_s == b.sample_time_s
        and np.array_equal(a.blocks.all_nodes, b.blocks.all_nodes)
        and torch.equal(a.features, b.features)
        for a, b in zip(traced, untraced))
    roots = [r for r in tracer.roots() if r.name == "batch"]
    err = max((abs(r.dur - b.prep_time_s) for r, b in zip(roots, traced)),
              default=0.0)
    err = max(err, tracer.max_reconcile_error())
    problems = validate_trace(tracer)
    snap = tracer.metrics.snapshot()
    events = tracer.chrome_events()
    return {
        "tracer_bit_invisible": invisible,
        "spans_reconciled": len(roots) == len(traced) and err <= 1e-9,
        "max_reconcile_error": err,
        "trace_valid": not problems,
        "n_trace_problems": len(problems),
        # the events of the reference's categories: the port's own
        # hot-path wall spans are counted apart
        "n_trace_events": sum(1 for e in events if e.get("cat") != HOT_PATH),
        "n_hot_path_events": sum(1 for e in events
                                 if e.get("cat") == HOT_PATH),
        "n_batch_spans": len(roots),
        "n_metric_keys": len(snap),
        "modelled_vs_measured_points": sum(
            v["n"] for k, v in snap.items()
            if k.startswith("modelled_vs_measured.")),
    }


@pytest.fixture(scope="module")
def fig_trace_pair():
    sys.path.insert(0, str(ROOT))
    from benchmarks import fig_trace
    return _fig_trace_headline(), fig_trace.headline()


FIG_TRACE_KEYS = ["tracer_bit_invisible", "spans_reconciled",
                  "max_reconcile_error", "trace_valid", "n_trace_problems",
                  "n_trace_events", "n_batch_spans", "n_metric_keys",
                  "modelled_vs_measured_points"]


@pytest.mark.parametrize("key", FIG_TRACE_KEYS)
def test_fig_trace_key_matches_reference_run(fig_trace_pair, key):
    port, ref = fig_trace_pair
    assert port[key] == ref[key]


def test_fig_trace_gates_hold(fig_trace_pair):
    port, _ = fig_trace_pair
    assert port["tracer_bit_invisible"] and port["spans_reconciled"]
    assert port["trace_valid"] and port["n_trace_events"] == 117
    assert port["n_hot_path_events"] > 0
