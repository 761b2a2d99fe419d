"""Span tracer: nested wall-time spans with Chrome-trace JSON export.

The tracer is process-wide and *off by default*: ``span(...)`` returns a
shared no-op context manager singleton until ``enable()`` is called, so
instrumented hot paths (executor operators, kernel wrappers, LSM
flush/merge, feed pumps) pay one module-flag check and zero allocations
per call when tracing is disabled.

Enabled, each ``span(name, **attrs)`` pushes a ``Span`` onto a
thread-local stack on ``__enter__`` and appends it to the process-wide
finished-event list on ``__exit__`` (exceptions still close the span —
``__exit__`` runs either way and never swallows the error).  Spans
therefore nest per thread; ``current()`` exposes the innermost open span
so other instrumentation (``obs.record_dispatch``) can attribute kernel
dispatches and transfer bytes to the operator that triggered them.

``dump_trace(path)`` writes the finished spans as a Chrome trace-event
JSON file (``ph: "X"`` complete events, microsecond timestamps), loadable
in ``chrome://tracing`` / Perfetto, so a whole feed -> flush -> merge ->
query run is inspectable on one timeline.

Span naming convention (see ``obs.__init__`` for the full registry):

  exec.<OP_KIND>       row/fallback executor operator (storage/query)
  columnar.<OP_KIND>   columnar-lowered operator (columnar/lower)
  lsm.flush / lsm.merge / lsm.postings_build
  feed.pump.<feed>     one intake->compute->store cycle
  bench.rep            one repetition inside benchmarks/_timing.timed
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "span", "enable", "disable", "enabled", "current",
           "clear", "events", "dump_trace", "to_chrome"]

_enabled = False
_lock = threading.Lock()
_events: List["Span"] = []
_tls = threading.local()
# trace timestamps are perf_counter-relative to import time so every
# thread shares one monotonic origin
_T0 = time.perf_counter()


class Span:
    """One wall-time interval.  ``attrs`` ride into the Chrome trace's
    ``args``; ``add``/``set`` mutate them while the span is open (or
    after — spans are plain records)."""

    __slots__ = ("name", "attrs", "t0", "t1", "tid", "depth")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.attrs: Dict[str, Any] = attrs or {}
        self.t0 = 0.0
        self.t1 = 0.0
        self.tid = 0
        self.depth = 0

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def add(self, key: str, n: Any) -> None:
        """Accumulate a numeric attribute (kernel dispatch / byte
        attribution)."""
        self.attrs[key] = self.attrs.get(key, 0) + n

    def set(self, key: str, v: Any) -> None:
        self.attrs[key] = v

    def __enter__(self) -> "Span":
        stack = _stack()
        self.depth = len(stack)
        self.tid = threading.get_ident()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # close even when the body raised: pop self (and, defensively,
        # anything opened above and leaked) so the stack never wedges
        self.t1 = time.perf_counter()
        stack = _stack()
        while stack:
            if stack.pop() is self:
                break
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        # explicitly-constructed spans (the serve profile sampler builds
        # Span(...) directly while global tracing is off) still nest on
        # the thread-local stack — so record_dispatch attribution lands
        # on them — but only enabled tracing retains them process-wide;
        # the sampler keeps its own bounded ring instead
        if _enabled:
            with _lock:
                _events.append(self)
        return None                     # never swallow the exception


class _NoopSpan:
    """Shared disabled-path singleton: ``span()`` allocates nothing when
    tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def add(self, key: str, n: Any) -> None:
        pass

    def set(self, key: str, v: Any) -> None:
        pass


_NOOP = _NoopSpan()


def _stack() -> List[Span]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def span(name: str, **attrs: Any):
    """Context manager for one traced interval.  Disabled: returns the
    shared no-op singleton (no allocation, no clock read)."""
    if not _enabled:
        return _NOOP
    return Span(name, attrs)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def current() -> Optional[Span]:
    """Innermost open span on this thread (None when no span is open).
    Purely stack-based: ``span()`` never pushes when tracing is disabled,
    so the common disabled path still returns None — but an explicitly
    constructed ``Span`` (profile sampling) is visible here regardless
    of the global flag, which is what routes kernel-dispatch attribution
    onto sampled serve requests."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


def clear() -> None:
    with _lock:
        _events.clear()


def events() -> List[Span]:
    """Finished spans, oldest first (a copy; safe to iterate while
    tracing continues)."""
    with _lock:
        return list(_events)


def to_chrome(spans: List[Span]) -> Dict[str, Any]:
    """Render finished spans as a Chrome trace-event dict (``ph: "X"``
    complete events, ts/dur in microseconds) — shared by
    ``dump_trace`` and the ``/trace`` HTTP endpoint (obs/export)."""
    return {
        "displayTimeUnit": "ms",
        "traceEvents": [
            {
                "name": e.name,
                "ph": "X",
                "ts": (e.t0 - _T0) * 1e6,
                "dur": max(e.duration, 0.0) * 1e6,
                "pid": 0,
                "tid": e.tid % (1 << 31),
                "args": {k: v for k, v in e.attrs.items()
                         if isinstance(v, (int, float, str, bool))},
            }
            for e in spans
        ],
    }


def dump_trace(path: str) -> int:
    """Write finished spans as Chrome trace-event JSON.  Returns the
    number of events written.  Open the file in chrome://tracing or
    https://ui.perfetto.dev to see the nested operator/flush/merge/pump
    timeline."""
    trace = to_chrome(events())
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
