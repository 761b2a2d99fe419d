"""Observability layer: span tracer + process-wide metrics registry.

This package is the measurement substrate the perf roadmap asserts
against (ROADMAP items 1–3): a nested span tracer with Chrome-trace
export (``tracer``) and a counters/gauges/histograms registry
(``metrics``), plus the one helper every kernel wrapper calls to account
dispatches and host<->device transfer bytes (``record_dispatch``).

Tracing is off by default and near-free when off (one module-flag check,
zero allocations).  Metrics counters are always on — they instrument
per-call/per-batch paths only, never per-row ones.

Span naming convention (``obs.span(name, **attrs)``):

  exec.<OP_KIND>          one executor operator, row/fallback engine
                          (storage/query.Executor.execute_op)
  columnar.<OP_KIND>      one columnar-lowered operator closure
                          (columnar/lower; the Figure-6 index chain is
                          one ``columnar.PRIMARY_INDEX_LOOKUP`` /
                          ``columnar.POST_VALIDATE_SELECT`` span)
  lsm.flush               one memtable flush (attrs: rows, bytes)
  lsm.merge               one k-way component merge (attrs: rows, bytes,
                          components)
  lsm.postings_build      ngram/secondary CSR postings build for one
                          component field (attrs: field)
  feed.pump.<feed>        one intake -> compute -> store cycle (attrs:
                          records)
  serve.request           one profiled harness request (attrs: trace_id,
                          kind, outcome, queue_wait_s, <phase>_s)
  serve.phase.<phase>     one phase (pin, execute, result) of a profiled
                          request
  bench.rep               one repetition inside benchmarks/_timing.timed

Kernel spans are not opened per dispatch (too hot); instead
``record_dispatch`` *attributes* dispatch counts and byte totals onto
the innermost open span (``kernel_dispatches`` / ``h2d_bytes`` /
``d2h_bytes`` span attrs), so an ``exec.*``/``columnar.*`` span carries
the kernel traffic of exactly the operator that triggered it.

The metric *name* registry lives in ``docs/METRICS.md`` — one table per
family (kernel.*, mesh.*, buffer_pool.*, plan_cache.*, lsm.*, feed.*,
serve.*, obs.exporter.*).  The names the feeds (``data/feeds``) and the
serving harness (``serve/harness``) emit are also listed here, with
their kinds, in :data:`FEED_SERVE_METRICS` (parametrized segments in the
doc's placeholder form); ``tests/test_torch_serve.py`` fails if a
harness run emits a ``feed.*`` or ``serve.*`` name it does not list, or
if it lists one the doc does not.

Executor-level accounting stays on ``storage/query.ExecStats`` (per-query
scope): ``kernel_dispatches`` / ``h2d_bytes`` / ``d2h_bytes`` and
``spmd_dispatches`` / ``spmd_partitions`` are per-query deltas of the
process counters, and ``fallback_reasons`` maps "OP_KIND: reason" ->
occurrences for every subplan the columnar engine declined.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np

from . import metrics, tracer
from .metrics import counter, gauge, histogram, snapshot, typed_snapshot
from .tracer import (Span, clear, current, disable, dump_trace, enable,
                     enabled, events, span, to_chrome)
from . import export
from .export import (ExporterServer, MetricsSampler, TimeSeriesRing,
                     render_prometheus, serve_http)

__all__ = ["metrics", "tracer", "export", "span", "enable", "disable",
           "enabled", "current", "events", "clear", "dump_trace",
           "to_chrome", "counter", "gauge", "histogram", "snapshot",
           "typed_snapshot", "reset", "record_dispatch", "record_retrace",
           "kernel_totals", "Span", "ExporterServer", "MetricsSampler",
           "TimeSeriesRing", "render_prometheus", "serve_http",
           "FEED_SERVE_METRICS"]

# every metric data/feeds and serve/harness emit: name -> kind
FEED_SERVE_METRICS: Dict[str, str] = {
    "feed.<feed>.records": "counter",
    "feed.<feed>.batch_records": "histogram",
    "feed.joint.<joint>.published": "counter",
    "feed.joint.<joint>.dropped": "counter",
    "feed.joint.<joint>.lag.<sub>": "gauge",
    "feed.sink.<dataset>.records": "counter",
    "feed.sink.<dataset>.batch_records": "histogram",
    "feed.sink.<dataset>.backlog": "gauge",
    "serve.ingest.acked": "counter",
    "serve.admission.rejected": "counter",
    "serve.admission.inflight": "gauge",
    "serve.query.latency_s": "histogram",
    "serve.query.torn_reads": "counter",
    "serve.query.lost_acks": "counter",
    "serve.recoveries": "counter",
    "serve.queue_wait_s": "histogram",
    "serve.phase.pin_s": "histogram",
    "serve.phase.execute_s": "histogram",
    "serve.phase.result_s": "histogram",
    "serve.slo.attained": "counter",
    "serve.slo.missed": "counter",
    "serve.slo.rejected_deadline": "counter",
    "serve.request.profiled": "counter",
}

# hot-path handles: resolved once so record_dispatch costs dict-free
# increments on the totals plus one cached lookup per kernel name
_K_DISPATCH = counter("kernel.dispatches")
_K_H2D = counter("kernel.h2d_bytes")
_K_D2H = counter("kernel.d2h_bytes")
_K_TRACES = counter("kernel.jit_traces")
_per_kernel: Dict[str, Tuple[Any, Any, Any]] = {}


def reset() -> None:
    """Zero all metrics and drop all finished spans (tracer enablement is
    untouched)."""
    metrics.reset()
    tracer.clear()


def _nbytes(arrs: Sequence[Any]) -> int:
    return sum(int(a.nbytes) for a in arrs if isinstance(a, np.ndarray))


def record_dispatch(name: str, h2d: Sequence[Any] = (),
                    d2h: Sequence[Any] = ()) -> None:
    """Account one device-bound kernel call: ``h2d`` are the operand
    arrays shipped to the jitted/Pallas core (post-padding; 0-d bound
    scalars are excluded by convention), ``d2h`` the result arrays
    fetched back (padded shape, before host-side slicing).  Updates the
    process-wide kernel counters and attributes onto the innermost open
    span when tracing is enabled."""
    hb = _nbytes(h2d)
    db = _nbytes(d2h)
    _K_DISPATCH.inc(1)
    if hb:
        _K_H2D.inc(hb)
    if db:
        _K_D2H.inc(db)
    per = _per_kernel.get(name)
    if per is None:
        per = _per_kernel[name] = (counter(f"kernel.{name}.dispatches"),
                                   counter(f"kernel.{name}.h2d_bytes"),
                                   counter(f"kernel.{name}.d2h_bytes"))
    per[0].inc(1)
    if hb:
        per[1].inc(hb)
    if db:
        per[2].inc(db)
    sp = tracer.current()
    if sp is not None:
        sp.add("kernel_dispatches", 1)
        sp.add("h2d_bytes", hb)
        sp.add("d2h_bytes", db)


def record_retrace() -> None:
    """Mirror of the kernel cores' trace-time counter (called from inside
    jitted functions at trace time only)."""
    _K_TRACES.inc(1)


def kernel_totals() -> Tuple[int, int, int]:
    """(dispatches, h2d_bytes, d2h_bytes) snapshot — the executor diffs
    two of these around a query to fill ExecStats."""
    return (_K_DISPATCH.value, _K_H2D.value, _K_D2H.value)
