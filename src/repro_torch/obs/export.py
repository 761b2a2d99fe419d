"""Metrics exporter: Prometheus text rendering, a windowed-rate sampler,
and a stdlib HTTP endpoint.

PR 6 made every layer observable through ``metrics.snapshot()``; this
module makes that state *servable* without any new dependency:

* ``render_prometheus()`` turns ``metrics.typed_snapshot()`` into the
  Prometheus text exposition format (version 0.0.4): metric names are
  sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*``, a small rule table folds
  per-entity name families (``kernel.<name>.dispatches``,
  ``feed.joint.<j>.lag.<sub>``, ...) into one family with labels
  (``kernel_dispatches{kernel="range_mask"}``), counters/gauges render
  as single samples and histograms as summaries (``{quantile="0.5"}`` /
  ``_sum`` / ``_count`` plus ``_min``/``_max`` gauges).

* ``TimeSeriesRing`` + ``MetricsSampler`` fill a fixed-size ring of
  (monotonic time, counter values) samples on a background interval so
  monotone counters become *windowed rates*: ``rates(window_s)`` is
  (newest - oldest-within-window) / elapsed for every sampled counter
  (default prefixes ``feed.`` / ``serve.`` / ``kernel.`` /
  ``buffer_pool.``, histogram ``count`` streams included as
  ``<name>.count``).  Rates ride into ``/metrics`` as
  ``<family>_rate`` gauges.

* ``serve_http(port)`` starts a ``http.server.ThreadingHTTPServer`` on
  a daemon thread serving

    /metrics    Prometheus text (plus ``*_rate`` gauges when a sampler
                is attached)
    /snapshot   the raw ``metrics.snapshot()`` JSON
    /trace      Chrome trace-event JSON of the retained spans (the
                process tracer ring by default; pass ``trace_source``
                to export a profile ring, e.g. the serve harness's
                sampled request spans)

  and returns an :class:`ExporterServer` (``.port``, ``.url``,
  ``.stop()``).  Nothing runs until ``serve_http`` is called — when the
  exporter is off the only cost anywhere is an unused import.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from . import metrics, tracer

__all__ = ["ExporterServer", "MetricsSampler", "TimeSeriesRing",
           "render_prometheus", "sanitize_metric_name", "serve_http"]

CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def sanitize_metric_name(name: str) -> str:
    """Registry name -> legal Prometheus metric name: every illegal
    character becomes ``_`` and a leading digit gets a ``_`` prefix."""
    out = _NAME_BAD.sub("_", name)
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# Per-entity name families -> one Prometheus family + labels.  A rule is
# (regex with named groups, family template); groups consumed by the
# template become part of the family name, the rest become labels.
LABEL_RULES: List[Tuple["re.Pattern[str]", str]] = [
    (re.compile(r"^kernel\.(?P<kernel>.+)\."
                r"(?P<which>dispatches|h2d_bytes|d2h_bytes)$"),
     "kernel_{which}"),
    (re.compile(r"^feed\.joint\.(?P<joint>.+)\.lag\.(?P<subscriber>.+)$"),
     "feed_joint_lag"),
    (re.compile(r"^feed\.joint\.(?P<joint>.+)\.(?P<which>published|dropped)$"),
     "feed_joint_{which}"),
    (re.compile(r"^feed\.sink\.(?P<dataset>.+)\."
                r"(?P<which>records|batch_records|backlog)$"),
     "feed_sink_{which}"),
    (re.compile(r"^feed\.(?P<feed>[^.]+)\.(?P<which>records|batch_records)$"),
     "feed_{which}"),
]


def _family(name: str) -> Tuple[str, Dict[str, str]]:
    """(family, labels) for a registry metric name."""
    for rx, tmpl in LABEL_RULES:
        m = rx.match(name)
        if m is None:
            continue
        groups = m.groupdict()
        family = tmpl.format(**groups)
        labels = {k: v for k, v in groups.items()
                  if "{%s}" % k not in tmpl}
        return (sanitize_metric_name(family),
                {sanitize_metric_name(k): v for k, v in labels.items()})
    return sanitize_metric_name(name), {}


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: Any) -> Optional[str]:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return None                      # non-numeric gauge payloads are skipped


def render_prometheus(typed: Optional[Dict[str, Any]] = None,
                      rates: Optional[Dict[str, float]] = None) -> str:
    """Prometheus text exposition of a ``metrics.typed_snapshot()`` (the
    live registry when None).  ``rates`` (registry-name -> per-second
    value, from :class:`MetricsSampler`) render as ``<family>_rate``
    gauges so scrapes see windowed throughput without PromQL."""
    if typed is None:
        typed = metrics.typed_snapshot()
    # family -> (kind, [(labels, snap)]) so each family prints one
    # ``# TYPE`` header with all its samples together (required format)
    families: Dict[str, Tuple[str, List[Tuple[Dict[str, str], Any]]]] = {}

    def put(family: str, kind: str, labels: Dict[str, str],
            snap: Any) -> None:
        cur = families.get(family)
        if cur is None:
            families[family] = (kind, [(labels, snap)])
        elif cur[0] == kind:
            cur[1].append((labels, snap))
        else:                        # kind clash after sanitization: keep
            put(family + "_" + kind, kind, labels, snap)   # both, suffixed

    for name, (kind, snap) in typed.items():
        family, labels = _family(name)
        put(family, kind, labels, snap)
    if rates:
        for name, rate in sorted(rates.items()):
            family, labels = _family(name)
            put(family + "_rate", "gauge", labels, float(rate))

    lines: List[str] = []
    for family in sorted(families):
        kind, samples = families[family]
        if kind == "histogram":
            # registry histograms expose exact count/sum + windowed
            # quantiles -> Prometheus *summary* is the matching type
            lines.append(f"# TYPE {family} summary")
            for labels, snap in samples:
                for q, key in (("0.5", "p50"), ("0.95", "p95"),
                               ("0.99", "p99")):
                    ql = dict(labels, quantile=q)
                    lines.append(f"{family}{_fmt_labels(ql)} "
                                 f"{_fmt_value(snap[key])}")
                lines.append(f"{family}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(snap['sum'])}")
                lines.append(f"{family}_count{_fmt_labels(labels)} "
                             f"{_fmt_value(snap['count'])}")
            for suffix, key in (("_min", "min"), ("_max", "max")):
                lines.append(f"# TYPE {family}{suffix} gauge")
                for labels, snap in samples:
                    lines.append(f"{family}{suffix}{_fmt_labels(labels)} "
                                 f"{_fmt_value(snap[key])}")
        else:
            rendered = [(labels, _fmt_value(snap))
                        for labels, snap in samples]
            rendered = [(lb, v) for lb, v in rendered if v is not None]
            if not rendered:
                continue
            lines.append(f"# TYPE {family} {kind}")
            for labels, v in rendered:
                lines.append(f"{family}{_fmt_labels(labels)} {v}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Windowed rates
# ---------------------------------------------------------------------------

class TimeSeriesRing:
    """Fixed-size ring of (t, {counter_name: value}) samples.  Appends
    overwrite the oldest slot once full; ``rate(name, window_s)`` is the
    slope between the newest sample and the oldest sample still inside
    the window — monotone counters become windowed rates."""

    def __init__(self, size: int = 120):
        if size < 2:
            raise ValueError("ring needs >= 2 slots to compute a rate")
        self.size = int(size)
        self._lock = threading.Lock()
        self._slots: List[Tuple[float, Dict[str, float]]] = []
        self._pos = 0

    def append(self, t: float, values: Dict[str, float]) -> None:
        with self._lock:
            if len(self._slots) < self.size:
                self._slots.append((t, values))
            else:
                self._slots[self._pos] = (t, values)
                self._pos = (self._pos + 1) % self.size

    def samples(self) -> List[Tuple[float, Dict[str, float]]]:
        """Retained samples, oldest first."""
        with self._lock:
            return self._slots[self._pos:] + self._slots[:self._pos]

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def rate(self, name: str, window_s: Optional[float] = None
             ) -> Optional[float]:
        """Per-second rate of ``name`` over the trailing window (whole
        ring when None).  None when fewer than two samples carry the
        counter."""
        samples = self.samples()
        if len(samples) < 2:
            return None
        t1, new = samples[-1]
        if name not in new:
            return None
        floor = -math.inf if window_s is None else t1 - window_s
        for t0, old in samples[:-1]:
            if t0 >= floor and name in old:
                if t1 <= t0:
                    return None
                return (new[name] - old[name]) / (t1 - t0)
        return None

    def rates(self, window_s: Optional[float] = None) -> Dict[str, float]:
        """Windowed rate for every counter in the newest sample."""
        samples = self.samples()
        if len(samples) < 2:
            return {}
        out = {}
        for name in samples[-1][1]:
            r = self.rate(name, window_s)
            if r is not None:
                out[name] = r
        return out


class MetricsSampler:
    """Background thread sampling counter values (and histogram
    ``count`` streams, as ``<name>.count``) into a
    :class:`TimeSeriesRing` every ``interval_s`` so the exporter can
    serve windowed rates.  Only names under ``prefixes`` are retained —
    the hot serving families, not every metric ever registered."""

    DEFAULT_PREFIXES = ("feed.", "serve.", "kernel.", "buffer_pool.")

    def __init__(self, interval_s: float = 1.0, size: int = 120,
                 prefixes: Sequence[str] = DEFAULT_PREFIXES):
        self.interval_s = float(interval_s)
        self.prefixes = tuple(prefixes)
        self.ring = TimeSeriesRing(size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _values(self) -> Dict[str, float]:
        vals: Dict[str, float] = {}
        for name, (kind, snap) in metrics.typed_snapshot().items():
            if not name.startswith(self.prefixes):
                continue
            if kind == "counter" and isinstance(snap, (int, float)):
                vals[name] = float(snap)
            elif kind == "histogram":
                vals[name + ".count"] = float(snap["count"])
        return vals

    def sample_now(self, t: Optional[float] = None) -> None:
        """Take one sample (tests drive this directly with explicit
        timestamps for deterministic rate math)."""
        self.ring.append(time.monotonic() if t is None else t,
                         self._values())

    def rates(self, window_s: Optional[float] = None) -> Dict[str, float]:
        return self.ring.rates(window_s)

    def start(self) -> "MetricsSampler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="obs-sampler")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.sample_now()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

class ExporterServer:
    """Threaded stdlib HTTP server exposing /metrics, /snapshot and
    /trace.  ``port=0`` binds an ephemeral port (read it back from
    ``.port``).  ``stop()`` shuts the listener down and, when the server
    owns its sampler (``serve_http`` wiring), stops that too."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 sampler: Optional[MetricsSampler] = None,
                 trace_source: Optional[Callable[[], Iterable[Any]]] = None,
                 rate_window_s: Optional[float] = None):
        self.sampler = sampler
        self.trace_source = trace_source or tracer.events
        self.rate_window_s = rate_window_s
        self._owns_sampler = False
        self._scrapes = metrics.counter("obs.exporter.scrapes")
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: Any) -> None:
                pass                       # silence per-request stderr spam

            def do_GET(self) -> None:      # noqa: N802 (stdlib API name)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        rates = (exporter.sampler.rates(
                                     exporter.rate_window_s)
                                 if exporter.sampler is not None else None)
                        body = render_prometheus(rates=rates).encode()
                        ctype = CONTENT_TYPE_PROM
                    elif path == "/snapshot":
                        body = json.dumps(metrics.snapshot(),
                                          default=str).encode()
                        ctype = "application/json"
                    elif path == "/trace":
                        spans = list(exporter.trace_source())
                        body = json.dumps(tracer.to_chrome(spans)).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path")
                        return
                except Exception as e:     # noqa: BLE001 — a broken
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return                 # renderer must not kill serving
                exporter._scrapes.inc()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=f"obs-http:{self.port}")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        if self._owns_sampler and self.sampler is not None:
            self.sampler.stop()

    def __enter__(self) -> "ExporterServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def serve_http(port: int = 0, host: str = "127.0.0.1",
               sample_interval_s: float = 1.0,
               rate_window_s: Optional[float] = 15.0,
               trace_source: Optional[Callable[[], Iterable[Any]]] = None
               ) -> ExporterServer:
    """Start the metrics endpoint: spins up a :class:`MetricsSampler`
    (so ``/metrics`` carries ``*_rate`` gauges over ``rate_window_s``)
    plus an :class:`ExporterServer`, and returns the server —
    ``server.stop()`` tears both down.  ``port=0`` picks an ephemeral
    port.  Until this is called the exporter costs nothing."""
    sampler = MetricsSampler(interval_s=sample_interval_s).start()
    server = ExporterServer(port=port, host=host, sampler=sampler,
                            trace_source=trace_source,
                            rate_window_s=rate_window_s)
    server._owns_sampler = True
    return server
