"""What a traced run records: host spans the benchmark puts around its calls
into the program, and the device's operations from `torch.profiler`.

Host spans are (name, start, end) on `time.perf_counter`.  The device
trace is put on the same clock by an anchor: just before the window the
device is idle, the host reads its clock and launches one short spin
kernel, whose start in the trace marks that host time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

ANCHOR_KERNEL = "spin_kernel"


class Spans:
    """Host spans of one run, kept in memory."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter()))

    def wrap(self, obj, method: str, name: str) -> None:
        """Put a span around every call of `obj.method` (an attribute set on
        the instance; the class is untouched)."""
        inner = getattr(obj, method)

        def spanned(*args, **kwargs):
            with self(name):
                return inner(*args, **kwargs)
        setattr(obj, method, spanned)

    def total(self, name: str, t0: float, t1: float) -> float:
        return sum(e - s for n, s, e in self.records
                   if n == name and s >= t0 and e <= t1)


def anchor() -> float:
    """Host time at which a spin kernel is launched on an idle device."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(100)
    torch.cuda.synchronize()
    return t


@dataclasses.dataclass
class DeviceTrace:
    """Device operations inside the window, on the host's clock."""

    ops: list[tuple[str, float, float]]   # (name, start, end), seconds
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_intervals(self) -> list[tuple[float, float]]:
        out, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = e
        if t < self.t1:
            out.append((t, self.t1))
        return out

    def kernel_s(self, fragment: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose name holds
        `fragment`."""
        hits = [e - s for n, s, e in self.ops if fragment in n]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> list[list]:
        by_name: dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            by_name[n] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], v] for n, v in top]

    def idle_by_span(self, spans: Spans, k: int = 10) -> list[list]:
        """Idle device seconds by the host span the host was in meanwhile
        ("loop" outside every span; the spans do not nest)."""
        recs = sorted(spans.records, key=lambda r: r[1])
        out: dict[str, float] = defaultdict(float)
        first = 0   # gaps come in order: a span that ends before one gap
        for gs, ge in self.idle_intervals():    # ends before every later one
            while first < len(recs) and recs[first][2] <= gs:
                first += 1
            covered = 0.0
            for i in range(first, len(recs)):
                name, s, e = recs[i]
                if s >= ge:
                    break
                ov = min(e, ge) - max(s, gs)
                if ov > 0:
                    out[name] += ov
                    covered += ov
            out["loop"] += max(0.0, (ge - gs) - covered)
        top = sorted(out.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v] for n, v in top if v > 0]


def device_trace(prof, host_anchor: float, t0: float, t1: float
                 ) -> DeviceTrace:
    """The device operations of a finished `torch.profiler.profile`, put on
    the host clock by the first anchor kernel (launched at host time
    `host_anchor`), clipped to the window [t0, t1]."""
    dev_events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
    anchors = sorted(ev.time_range.start for ev in dev_events
                     if ANCHOR_KERNEL in ev.name)
    if not anchors:
        raise RuntimeError("the profiler recorded no anchor kernel: no "
                           "device activity was traced")
    offset = host_anchor - anchors[0] * 1e-6
    ops = []
    for ev in dev_events:
        if ANCHOR_KERNEL in ev.name:
            continue
        s = ev.time_range.start * 1e-6 + offset
        e = ev.time_range.end * 1e-6 + offset
        if e > t0 and s < t1:
            ops.append((ev.name, s, e))
    return DeviceTrace(ops, t0, t1)
