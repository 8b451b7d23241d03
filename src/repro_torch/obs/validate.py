"""Schema validation for exported traces: the gate a written trace must
pass before anything reads it.

Checks two layers:

* **Event level** (Chrome trace-event JSON): every event carries the
  required keys with sane types, complete (``ph == "X"``) events have
  non-negative ``ts``/``dur``, and metadata events name their tracks.
* **Structure level** (the tracer's span trees): every child lies inside
  its parent's interval, sequential siblings do not run backwards, and
  top-level spans on each track have monotone (non-decreasing) start
  times — serve requests may overlap while queued, but never regress.

Both return a list of problem strings; empty means valid.
"""
from __future__ import annotations

from typing import Any

from repro_torch.obs.trace import SPAN, Span, Tracer

_EPS = 1e-9


def validate_events(events: list[dict]) -> list[str]:
    """Validate a Chrome trace-event list (the ``traceEvents`` array)."""
    problems: list[str] = []
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"{where}: unsupported ph {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                problems.append(f"{where}: missing {key!r}")
        if not isinstance(ev.get("name"), str):
            problems.append(f"{where}: name is not a string")
        if ph == "M":
            if ev.get("name") not in ("process_name", "thread_name"):
                problems.append(f"{where}: unknown metadata {ev.get('name')!r}")
            elif not isinstance(ev.get("args", {}).get("name"), str):
                problems.append(f"{where}: metadata without args.name")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: bad dur {dur!r}")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            problems.append(f"{where}: instant without scope 's'")
        args = ev.get("args", {})
        if not isinstance(args, dict):
            problems.append(f"{where}: args is not an object")
    return problems


def _check_tree(sp: Span, problems: list[str], path: str) -> None:
    if sp.dur is None or sp.t0 is None:
        problems.append(f"{path}: span not laid out")
        return
    if sp.dur < 0:
        problems.append(f"{path}: negative duration {sp.dur!r}")
    end = sp.t0 + sp.dur
    cursor = sp.t0
    for c in sp.children:
        cpath = f"{path}/{c.name}"
        if c.t0 is None:
            problems.append(f"{cpath}: child not laid out")
            continue
        cdur = c.dur or 0.0
        if c.t0 < sp.t0 - _EPS or c.t0 + cdur > end + _EPS:
            problems.append(
                f"{cpath}: child [{c.t0:.9f}, {c.t0 + cdur:.9f}] escapes "
                f"parent [{sp.t0:.9f}, {end:.9f}]")
        if c.kind == SPAN and not c.parallel:
            if c.t0 < cursor - _EPS:
                problems.append(
                    f"{cpath}: sequential child starts at {c.t0:.9f} before "
                    f"cursor {cursor:.9f}")
            cursor = c.t0 + cdur
        if c.kind == SPAN:
            _check_tree(c, problems, cpath)


def validate_tracer(tracer: Tracer) -> list[str]:
    """Validate the tracer's span structure (pre-export invariants)."""
    tracer._layout()
    problems: list[str] = []
    last_start: dict[str, float] = {}
    for ev in tracer._events:
        track = ev.track or "pipeline"
        if ev.t0 is None:
            problems.append(f"{ev.name}: top-level span not laid out")
            continue
        if ev.t0 < last_start.get(track, 0.0) - _EPS:
            problems.append(
                f"{ev.name}: track {track!r} start {ev.t0:.9f} regresses "
                f"below {last_start[track]:.9f}")
        last_start[track] = max(last_start.get(track, 0.0), ev.t0)
        if ev.kind == SPAN:
            _check_tree(ev, problems, ev.name)
    for w in tracer._wall:
        if w.wall_t0 is None or w.wall_dur is None or w.wall_dur < 0:
            problems.append(f"{w.name}: wall span not closed")
    return problems


def validate_trace(tracer_or_events: Any) -> list[str]:
    """Full gate: structure (when given a Tracer) plus exported events."""
    if isinstance(tracer_or_events, Tracer):
        problems = validate_tracer(tracer_or_events)
        problems += validate_events(tracer_or_events.chrome_events())
        return problems
    if isinstance(tracer_or_events, dict):
        return validate_events(tracer_or_events.get("traceEvents", []))
    return validate_events(tracer_or_events)
