"""Span tracer for the priced data plane, with Chrome trace-event export.

The data plane runs on two clocks.  *Virtual* (priced) time is what the
storage model charges — every `prep_time_s`, burst, and serve latency is
a deterministic float produced by `StorageTimeline`.  *Wall* time is how
long the Python simulation itself takes.  The tracer records both:

* **Virtual spans** form a tree per batch / serve window: the root span's
  duration is the priced time of the whole unit and its sequential
  children partition it (per-hop sampling, gather, feedback charge, ...).
  Parallel children (per-shard / per-host drains, fault recovery
  sub-events) overlay the parent on their own track and are excluded
  from the parent-sum reconciliation.  Virtual spans without an explicit
  start are laid out lazily at export time on per-track cursors, so the
  hot path only stores durations.
* **Wall spans** come from ``tracer.stage(name)`` context managers that
  measure ``time.perf_counter`` around a pipeline stage; attaching the
  priced duration via ``handle.modelled(dur_s)`` records a point in the
  ``modelled_vs_measured.<stage>`` series of the registry — the gap the
  ROADMAP wants as a tracked number.  Code that already read the clock
  hands its two reads to ``tracer.record(name, t0, t1)`` instead, so no
  stage is timed twice.  A wall span keeps its absolute ``perf_counter``
  start and its parent, the innermost stage open on the tracer when it
  began; ``span.self_time()`` is its duration less what its wall children
  cover.  Spans of category :data:`HOT_PATH` are the port's own, inside
  the data plane's hot path (the loader's sampling, admits, gather, tier
  probes, report, pricing and feedback); the reference records none.

Export is Chrome trace-event JSON (the ``traceEvents`` array form), which
Perfetto loads directly: virtual time on pid 1, wall time on pid 2, one
named thread (track) per pipeline / window / shard / host / tenant /
controller lane.  Wall ``ts`` are µs after the first wall span's start;
``write`` puts that base, on the ``perf_counter`` clock, into the file's
``otherData``, so a device trace on the same clock lines up with them.

The default tracer everywhere is :data:`NULL_TRACER` — a shared no-op
whose methods return inert singletons, so instrumented code paths cost a
predicate or an empty call when tracing is off and the priced numbers
are bit-identical either way.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Iterator

from repro_torch.obs.metrics import MetricsRegistry, NULL_METRICS

PID_VIRTUAL = 1
PID_WALL = 2

# span kinds
SPAN = "span"          # virtual interval with optional children
INSTANT = "instant"    # zero-duration virtual event
WALL = "wall"          # perf_counter-measured stage

#: category of the port's wall spans inside the data plane's hot path
HOT_PATH = "hot_path"


def _jsonify(value: Any) -> Any:
    """Coerce span args to JSON-safe scalars (numpy included)."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError):
            pass
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)


class Span:
    """One node of a trace tree; durations in (virtual or wall) seconds."""

    __slots__ = ("name", "cat", "kind", "track", "t0", "dur",
                 "wall_t0", "wall_dur", "parallel", "args", "children",
                 "parent")

    def __init__(self, name: str, *, cat: str = "stage", kind: str = SPAN,
                 track: str | None = None, t0: float | None = None,
                 dur: float | None = None, parallel: bool = False,
                 args: dict | None = None):
        self.name = name
        self.cat = cat
        self.kind = kind
        self.track = track
        self.t0 = t0
        self.dur = dur
        self.wall_t0: float | None = None
        self.wall_dur: float | None = None
        self.parallel = parallel
        self.args = args or {}
        self.children: list[Span] = []
        self.parent: Span | None = None     # wall spans: the enclosing stage

    # -- building ---------------------------------------------------------
    def child(self, name: str, dur: float = 0.0, *, cat: str = "stage",
              track: str | None = None, t0: float | None = None,
              parallel: bool = False, **args) -> "Span":
        sp = Span(name, cat=cat, kind=SPAN, track=track, t0=t0,
                  dur=float(dur), parallel=parallel, args=args)
        self.children.append(sp)
        return sp

    def event(self, name: str, *, cat: str = "event",
              track: str | None = None, t0: float | None = None,
              parallel: bool = True, **args) -> "Span":
        sp = Span(name, cat=cat, kind=INSTANT, track=track, t0=t0,
                  parallel=parallel, args=args)
        self.children.append(sp)
        return sp

    def close(self, dur: float | None = None) -> "Span":
        """Fix the span's duration (default: sum of sequential children)."""
        self.dur = float(self.sequential_sum() if dur is None else dur)
        return self

    def annotate(self, **args) -> "Span":
        self.args.update(args)
        return self

    def modelled(self, dur_s: float) -> "Span":
        """Attach the priced duration to a wall-clock stage span."""
        self.dur = float(dur_s)
        return self

    # -- reconciliation ---------------------------------------------------
    def sequential_sum(self) -> float:
        return float(sum(c.dur or 0.0 for c in self.children
                         if c.kind == SPAN and not c.parallel))

    def reconcile_error(self) -> float:
        """abs(dur - sum of sequential children), if it has any."""
        seq = [c for c in self.children if c.kind == SPAN and not c.parallel]
        if not seq or self.dur is None:
            return 0.0
        return abs(self.dur - self.sequential_sum())

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def self_time(self) -> float:
        """A wall span's seconds less what its wall children cover."""
        covered, end = 0.0, float("-inf")
        for c in sorted(self.children, key=lambda c: c.wall_t0):
            c1 = c.wall_t0 + c.wall_dur
            covered += max(0.0, c1 - max(c.wall_t0, end))
            end = max(end, c1)
        return self.wall_dur - covered


class _NullSpan:
    """Inert span: every span-building call returns itself and records
    nothing."""

    __slots__ = ()
    name = "<null>"
    dur = None
    t0 = None
    children: list = []
    args: dict = {}

    def child(self, name, dur=0.0, **kw):
        return self

    def event(self, name, **kw):
        return self

    def close(self, dur=None):
        return self

    def annotate(self, **kw):
        return self

    def modelled(self, dur_s):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Collects virtual span trees, instants, and wall-clock stage spans."""

    enabled = True

    def __init__(self, metrics: MetricsRegistry | None = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._events: list[Span] = []      # top-level virtual spans/instants
        self._wall: list[Span] = []        # closed wall stage spans
        self._open: list[Span] = []        # wall stages open, innermost last
        self._laid_out = False

    # -- building ---------------------------------------------------------
    def batch(self, name: str, *, track: str = "pipeline",
              cat: str = "batch", t0: float | None = None, **args) -> Span:
        """Open a top-level virtual span (a batch, window, or request)."""
        sp = Span(name, cat=cat, kind=SPAN, track=track, t0=t0, args=args)
        self._events.append(sp)
        self._laid_out = False
        return sp

    def instant(self, name: str, *, track: str = "controller",
                cat: str = "event", t0: float | None = None, **args) -> Span:
        """Record a zero-duration virtual event (controller commits etc.)."""
        sp = Span(name, cat=cat, kind=INSTANT, track=track, t0=t0, args=args)
        self._events.append(sp)
        self._laid_out = False
        return sp

    @contextmanager
    def stage(self, name: str, *, track: str = "loop", cat: str = "stage",
              **args):
        """Wall-clock a pipeline stage; ``handle.modelled(s)`` records the
        modelled-vs-measured gap for this stage into the registry."""
        sp = self._wall_span(name, cat, track, args)
        self._open.append(sp)
        sp.wall_t0 = time.perf_counter()
        try:
            yield sp
        finally:
            sp.wall_dur = time.perf_counter() - sp.wall_t0
            self._open.pop()
            self._wall.append(sp)
            if sp.dur is not None:
                self.metrics.series(f"modelled_vs_measured.{name}").append({
                    "modelled_s": sp.dur,
                    "measured_s": sp.wall_dur,
                    "gap_s": sp.wall_dur - sp.dur,
                })

    def record(self, name: str, t0: float, t1: float, *,
               track: str = "loop", cat: str = HOT_PATH, **args) -> Span:
        """A closed wall span from two `time.perf_counter` reads the caller
        took, under the innermost stage open now."""
        sp = self._wall_span(name, cat, track, args)
        sp.wall_t0, sp.wall_dur = t0, t1 - t0
        self._wall.append(sp)
        return sp

    def _wall_span(self, name: str, cat: str, track: str,
                   args: dict) -> Span:
        sp = Span(name, cat=cat, kind=WALL, track=track, args=args)
        if self._open:
            sp.parent = self._open[-1]
            sp.parent.children.append(sp)
        return sp

    def reset(self) -> None:
        self._events.clear()
        self._wall.clear()
        self._laid_out = False
        self.metrics.reset()

    # -- inspection -------------------------------------------------------
    def roots(self) -> list[Span]:
        return [sp for sp in self._events if sp.kind == SPAN]

    def instants(self) -> list[Span]:
        return [sp for sp in self._events if sp.kind == INSTANT]

    def wall_spans(self) -> list[Span]:
        return list(self._wall)

    def wall_base(self) -> float:
        """The `perf_counter` time the exported wall track counts from."""
        return min((w.wall_t0 for w in self._wall), default=0.0)

    def spans(self) -> Iterator[Span]:
        for root in self._events:
            yield from root.walk()

    def max_reconcile_error(self) -> float:
        return max((sp.reconcile_error() for sp in self.spans()),
                   default=0.0)

    # -- layout -----------------------------------------------------------
    def _layout(self) -> None:
        """Assign start times to spans created without one: per-track
        cursors for top-level spans, sequential packing for children."""
        if self._laid_out:
            return
        clocks: dict[str, float] = {}
        for ev in self._events:
            if ev.track is None:
                ev.track = "pipeline"
            if ev.kind == INSTANT:
                if ev.t0 is None:
                    ev.t0 = max(clocks.values(), default=0.0)
                continue
            self._layout_tree(ev, clocks.get(ev.track, 0.0))
            clocks[ev.track] = max(clocks.get(ev.track, 0.0),
                                   ev.t0 + (ev.dur or 0.0))
        self._laid_out = True

    def _layout_tree(self, sp: Span, cursor: float) -> None:
        if sp.dur is None:
            sp.close()
        if sp.t0 is None:
            sp.t0 = cursor
        child_cursor = sp.t0
        for c in sp.children:
            if c.track is None:
                c.track = sp.track
            if c.kind == INSTANT:
                if c.t0 is None:
                    c.t0 = sp.t0 if c.parallel else child_cursor
                continue
            self._layout_tree(c, sp.t0 if c.parallel else child_cursor)
            if not c.parallel:
                child_cursor = c.t0 + (c.dur or 0.0)

    # -- export -----------------------------------------------------------
    def chrome_events(self) -> list[dict]:
        """Render as Chrome trace-event JSON objects (Perfetto-loadable):
        virtual time on pid 1, wall time on pid 2, one tid per track."""
        self._layout()
        events: list[dict] = [
            {"ph": "M", "pid": PID_VIRTUAL, "tid": 0, "ts": 0,
             "name": "process_name", "args": {"name": "virtual (priced)"}},
            {"ph": "M", "pid": PID_WALL, "tid": 0, "ts": 0,
             "name": "process_name", "args": {"name": "wall clock"}},
        ]
        tids: dict[tuple[int, str], int] = {}

        def tid_for(pid: int, track: str) -> int:
            key = (pid, track)
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = 1 + sum(1 for k in tids if k[0] == pid)
                events.append({"ph": "M", "pid": pid, "tid": tid, "ts": 0,
                               "name": "thread_name",
                               "args": {"name": track}})
            return tid

        def emit(sp: Span) -> None:
            tid = tid_for(PID_VIRTUAL, sp.track or "pipeline")
            args = {k: _jsonify(v) for k, v in sp.args.items()}
            if sp.kind == INSTANT:
                events.append({"name": sp.name, "cat": sp.cat, "ph": "i",
                               "s": "t", "pid": PID_VIRTUAL, "tid": tid,
                               "ts": sp.t0 * 1e6, "args": args})
                return
            events.append({"name": sp.name, "cat": sp.cat, "ph": "X",
                           "pid": PID_VIRTUAL, "tid": tid,
                           "ts": sp.t0 * 1e6, "dur": sp.dur * 1e6,
                           "args": args})
            for c in sp.children:
                emit(c)

        for ev in self._events:
            emit(ev)

        base = self.wall_base()
        for w in self._wall:
            args = {k: _jsonify(v) for k, v in w.args.items()}
            if w.dur is not None:
                args["modelled_s"] = w.dur
                args["gap_s"] = w.wall_dur - w.dur
            events.append({"name": w.name, "cat": w.cat, "ph": "X",
                           "pid": PID_WALL,
                           "tid": tid_for(PID_WALL, w.track or "loop"),
                           "ts": (w.wall_t0 - base) * 1e6,
                           "dur": w.wall_dur * 1e6, "args": args})
        return events

    def write(self, path: str) -> list[dict]:
        """Write the Chrome trace to `path`; with wall spans, `otherData`
        names the clock and the base their `ts` count from."""
        events = self.chrome_events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self._wall:
            doc["otherData"] = {"wall_clock": "time.perf_counter",
                                "wall_base_us": self.wall_base() * 1e6}
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return events


class NullTracer(Tracer):
    """Shared zero-cost tracer: records nothing, returns inert handles."""

    enabled = False

    def __init__(self):
        self.metrics = NULL_METRICS
        self._events = []
        self._wall = []
        self._laid_out = True

    def batch(self, name, **kw):
        return NULL_SPAN

    def instant(self, name, **kw):
        return NULL_SPAN

    def stage(self, name, **kw):
        return NULL_SPAN          # _NullSpan is its own context manager

    def record(self, name, t0, t1, **kw):
        return NULL_SPAN

    def reset(self):
        pass

    def chrome_events(self):
        return []


NULL_TRACER = NullTracer()


def attach_burst_spans(parent: Span, burst: Any) -> None:
    """Overlay a priced sharded/host burst on a gather span: one parallel
    child per shard (or host) on its own track, plus fault retry / hedge /
    failover sub-events when the burst carries recovery telemetry."""
    per_shard = getattr(burst, "per_shard_s", None)
    if per_shard is None:
        return
    is_host = hasattr(burst, "link_s")
    prefix = "host" if is_host else "shard"
    for i, t in enumerate(per_shard):
        args: dict[str, Any] = {}
        for field, key in (("per_shard_rows", "rows"),
                           ("per_shard_lines", "lines")):
            vals = getattr(burst, field, None)
            if vals is not None:
                args[key] = int(vals[i])
        if is_host:
            args["local_s"] = float(burst.local_s[i])
            args["link_s"] = float(burst.link_s[i])
            remote = getattr(burst, "remote_lines", None)
            if remote is not None:
                args["remote_lines"] = int(remote[i])
        if float(t) <= 0.0 and not args.get("rows") and not args.get("lines"):
            continue
        parent.child(f"{prefix}{i}", float(t), cat="storage",
                     track=f"{prefix}{i}", parallel=True, **args)
    fault_src = getattr(burst, "local_burst", None) or burst
    recovery = getattr(fault_src, "recovery_events", None)
    if callable(recovery):
        for kind, shard, args in recovery():
            dur = float(args.pop("recovery_s", 0.0))
            parent.child(f"fault/{kind}", dur, cat="fault",
                         track=f"{prefix}{shard}", parallel=True,
                         shard=shard, **args)
