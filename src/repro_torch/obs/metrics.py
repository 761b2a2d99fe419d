"""Process-wide metrics registry: counters, gauges, histograms.

One global ``Registry`` (module-level ``counter()`` / ``gauge()`` /
``histogram()`` accessors) shared by every instrumented layer — kernel
wrappers, the LSM, feeds, the executor.  Metric creation is
lock-protected; updates take the per-metric lock (a dict increment plus
one lock acquisition — microseconds-scale kernel dispatches dwarf it,
and per-*row* paths are never instrumented, only per-call/per-batch
ones).

``snapshot()`` returns a flat JSON-safe dict (histograms expand to
``{count, sum, min, max, p50, p95, p99}``) — this is what
``benchmarks/run.py --json`` embeds so every CI run records the metric
state alongside the bench numbers.  ``reset()`` zeroes everything
(tests and per-query deltas use it or diff two snapshots).

Snapshots never stall the hot path: ``snapshot()`` copies the
name->metric mapping under the registry lock, then each metric copies
its own state under its *per-metric* lock for only as long as a list
copy takes — sorting (histogram quantiles) happens on the copy, outside
every lock.  A slow consumer (the HTTP exporter scraping a large
registry) therefore can never block a concurrent counter increment for
longer than one bounded copy.  ``typed_snapshot()`` is the same walk
but keeps the metric kind (``"counter"`` / ``"gauge"`` /
``"histogram"``) alongside each value — the Prometheus renderer in
``obs/export.py`` needs the kind to pick the exposition type.

Histograms keep a bounded ring of recent observations (default 8192)
for the quantiles; ``count``/``sum``/``min``/``max`` stay exact over
the full stream.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "counter", "gauge", "histogram", "snapshot", "typed_snapshot",
           "reset"]


def _nearest_rank(sorted_xs: List[float], p: float) -> Optional[float]:
    """Nearest-rank quantile over an already-sorted window (None when
    empty)."""
    if not sorted_xs:
        return None
    n = len(sorted_xs)
    k = min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))
    return sorted_xs[k]


class Counter:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snap(self) -> Union[int, float]:
        with self._lock:
            return self._value


class Gauge:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Any = 0

    def set(self, v: Any) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> Any:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0

    def _snap(self) -> Any:
        with self._lock:
            return self._value


class Histogram:
    """Streaming distribution: exact count/sum/min/max, quantiles over a
    bounded ring of the most recent ``window`` observations."""

    __slots__ = ("name", "window", "_lock", "_ring", "_pos",
                 "count", "sum", "min", "max")

    def __init__(self, name: str, window: int = 8192):
        self.name = name
        self.window = int(window)
        self._lock = threading.Lock()
        self._ring: List[float] = []
        self._pos = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: Union[int, float]) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._ring) < self.window:
                self._ring.append(v)
            else:                       # overwrite oldest (ring buffer)
                self._ring[self._pos] = v
                self._pos = (self._pos + 1) % self.window

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100] over the retained window (None when empty)."""
        with self._lock:
            if not self._ring:
                return None
            xs = list(self._ring)       # copy only; sort outside the lock
        xs.sort()
        return _nearest_rank(xs, p)

    def _reset(self) -> None:
        with self._lock:
            self._ring = []
            self._pos = 0
            self.count = 0
            self.sum = 0.0
            self.min = None
            self.max = None

    def _snap(self) -> Dict[str, Any]:
        # one lock acquisition copies the whole state (scalars are read
        # together with the ring, so count/sum/min/max are never torn
        # against the quantiles); the sort runs on the copy, unlocked
        with self._lock:
            xs = list(self._ring)
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
        xs.sort()
        return {
            "count": count,
            "sum": total,
            "min": lo,
            "max": hi,
            "p50": _nearest_rank(xs, 50),
            "p95": _nearest_rank(xs, 95),
            "p99": _nearest_rank(xs, 99),
        }


class Registry:
    """Named-metric store.  A name is permanently one metric type — a
    kind clash raises instead of silently shadowing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)       # racy read is fine: dict get
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, "
                    f"not {cls.__name__}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, "
                    f"not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 8192) -> Histogram:
        return self._get(name, Histogram, window=window)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:                  # registry lock: mapping copy only
            items = list(self._metrics.items())
        # each _snap() takes its own per-metric lock just long enough to
        # copy state — a hot-path increment never waits on the full walk
        return {name: m._snap() for name, m in sorted(items)}

    def typed_snapshot(self) -> Dict[str, Any]:
        """Like ``snapshot()`` but each value is ``(kind, snap)`` where
        kind is "counter" / "gauge" / "histogram" — what the Prometheus
        renderer keys its exposition types on."""
        with self._lock:
            items = list(self._metrics.items())
        kinds = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}
        return {name: (kinds[type(m)], m._snap())
                for name, m in sorted(items)}

    def reset(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m._reset()


REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
typed_snapshot = REGISTRY.typed_snapshot
reset = REGISTRY.reset
