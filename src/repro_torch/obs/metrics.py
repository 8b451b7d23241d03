"""Metrics registry for the observability plane.

A :class:`MetricsRegistry` is a flat namespace of typed instruments —
counters, gauges, histograms, and series — that replaces the scattered
``last_*`` attributes the data plane used to grow per subsystem.  Call
sites get-or-create instruments by name (``registry.counter("x").inc()``),
so instrumentation never has to pre-declare anything, and
:meth:`MetricsRegistry.snapshot` renders the whole registry as a
JSON-safe dict for ``benchmarks/run.py --trace``.

The null registry (:data:`NULL_METRICS`) backs the no-op tracer: every
``counter()/gauge()/...`` call returns a shared inert instrument, so
instrumented code stays unconditional while the disabled path allocates
nothing.
"""
from __future__ import annotations

from typing import Any


class Counter:
    """Monotone accumulator (counts or accumulated seconds)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self) -> dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar (ratios, imbalance, level settings)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Streaming summary: count / total / min / max / mean."""

    __slots__ = ("name", "count", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict[str, Any]:
        return {"type": "histogram", "count": self.count,
                "total": self.total, "mean": self.mean,
                "min": self.min, "max": self.max}


class Series:
    """Append-only sequence of points (dicts or scalars), kept in order.

    Used for the first-class ``modelled_vs_measured`` gap series: one
    point per traced stage invocation, carrying both clocks.
    """

    __slots__ = ("name", "points")

    def __init__(self, name: str):
        self.name = name
        self.points: list[Any] = []

    def append(self, point: Any) -> None:
        self.points.append(point)

    def __len__(self) -> int:
        return len(self.points)

    def snapshot(self) -> dict[str, Any]:
        return {"type": "series", "n": len(self.points),
                "points": list(self.points)}


class MetricsRegistry:
    """Get-or-create namespace of instruments, snapshot-able as JSON."""

    def __init__(self):
        self._instruments: dict[str, Any] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def series(self, name: str) -> Series:
        return self._get(name, Series)

    def get(self, name: str):
        return self._instruments.get(name)

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def snapshot(self) -> dict[str, Any]:
        return {name: self._instruments[name].snapshot()
                for name in sorted(self._instruments)}

    def reset(self) -> None:
        self._instruments.clear()


class _NullInstrument:
    """Inert instrument shared by every name on the null registry."""

    __slots__ = ()
    name = "<null>"
    value = None
    count = 0
    total = 0.0
    mean = 0.0
    min = None
    max = None
    points: list = []

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def append(self, point: Any) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def snapshot(self) -> dict[str, Any]:
        return {"type": "null"}


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics(MetricsRegistry):
    """No-op registry: accepts every call, records nothing."""

    def __init__(self):
        super().__init__()

    def _get(self, name: str, cls):
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict[str, Any]:
        return {}

    def reset(self) -> None:
        pass


NULL_METRICS = NullMetrics()
