"""Admission-controlled concurrent serving loop: feeds in, queries out.

One :class:`ServeHarness` owns a :class:`PartitionedDataset` plus

* N ingest lanes — ``Feed`` pump threads whose store stage is a
  :class:`BoundedSink` (a bounded ``queue.Queue``: *block*, never drop)
  drained by one :class:`SinkWorker` per lane delivering micro-batches
  through ``insert_batch`` and acknowledging primary keys only after
  the insert returns;
* M :class:`QueryWorker` threads behind an :class:`AdmissionController`
  semaphore, alternating snapshot-isolated verification scans
  (``dataset.pin()``) with executor queries
  (``run_query(..., snapshot=True)``).

**The consistency invariant.**  Lane ``l`` of ``L`` inserts primary keys
``l, l+L, l+2L, ...`` in order, so any snapshot must contain, per lane,
exactly a *prefix* of that lane's key sequence — and at least every key
acknowledged before the snapshot was pinned.  A gap in a lane is a torn
read; a count below the pre-pin ack floor is a lost acknowledged write.
Both are counted (``serve.query.torn_reads`` / ``serve.query.lost_acks``)
on every verification scan, making the stress benchmark an oracle, not a
smoke test.

**Fault tolerance.**  ``checkpoint()`` parks the pumps, drains the
queues, and captures every feed's cursor state; ``crash_and_recover()``
rebuilds the dataset from (valid components + WAL), restores the feeds
from the last checkpoint, and resumes — records between checkpoint and
crash are replayed at-least-once and deduplicated by PK upsert.

**Request tracing + SLOs.**  Every query-worker submission is a
*request*: :class:`RequestTracker` assigns a monotone trace id, the
admission queue wait / snapshot-pin / execute / result phases are timed
individually (``serve.queue_wait_s`` + ``serve.phase.*_s`` histograms),
and a per-request deadline turns the admission controller
deadline-aware — a request whose queue wait alone would blow its
deadline is rejected up front (``serve.slo.rejected_deadline``) instead
of burning an execution slot it can no longer use.  Completed requests
settle into ``serve.slo.attained`` / ``serve.slo.missed`` on total
latency (queue wait included).  A 1-in-N profile sampler retains the
full span tree of sampled requests in a bounded ring — those spans
carry the kernel dispatch / transfer-byte attribution from
``obs.record_dispatch`` even while global tracing is off, and feed both
the ``/trace`` exporter endpoint and :meth:`ServeReport` tail-latency
attribution (which phase dominates p99).

This is the port's copy of the reference's harness
(``repro/serve/harness.py``), bound to the port's ``run_query``,
``obs`` and ``data.feeds``, with the same classes, ``serve.*`` metrics,
report fields and semantics.  Its workers share the card through
PyTorch's one current stream: ingest reaches it through
``insert_batch`` (every LSM merge runs K3), and queries a caller runs
with ``run_query(..., vectorize=True)`` launch the query kernels;
:meth:`ServeHarness.executor_query` keeps the reference's plan, an
opaque predicate on the row engine.  One repair: the reference's
``_quiesce`` waits on ``queue.join()``, which never returns once a
:class:`SinkWorker` has died with chunks queued; here it raises.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, \
    Sequence

import numpy as np

from .. import obs as _obs
from ..obs import tracer as _tracer
from ..obs.metrics import Histogram as _LocalHistogram
from ..core import algebra as A
from ..data.feeds import Adaptor, Feed, FeedJoint
from ..storage.query import run_query

__all__ = ["Admission", "AdmissionController", "BoundedSink", "IngestPump",
           "QueryWorker", "RequestRecord", "RequestTracker", "ServeHarness",
           "ServeReport", "SinkWorker", "StridedRecordAdaptor"]

PHASES = ("queue_wait", "pin", "execute", "result")


def _null_phase(name: str):
    """Phase hook for untracked calls (direct test use of the query
    surface): no timing, no spans."""
    return nullcontext()


# ---------------------------------------------------------------------------
# Workload pieces
# ---------------------------------------------------------------------------

def _default_record(pk: int) -> Dict[str, Any]:
    return {"pk": int(pk),
            "val": int((pk * 2654435761) % 100003),
            "text": f"rec-{pk % 97}"}


class StridedRecordAdaptor(Adaptor):
    """Deterministic record source for ingest lane ``lane`` of ``lanes``:
    the i-th record carries primary key ``i*lanes + lane``, so concurrent
    lanes never collide and each lane's key sequence is monotone — the
    property the snapshot-consistency oracle checks.  Seekable, so a feed
    ``restore()`` replays exactly."""

    def __init__(self, lane: int, lanes: int,
                 make_record: Optional[Callable[[int], Dict[str, Any]]] = None,
                 limit: Optional[int] = None):
        self.lane = int(lane)
        self.lanes = int(lanes)
        self.make_record = make_record or _default_record
        self.limit = limit
        self.cursor = 0

    def next_batch(self, n: int) -> List[Any]:
        if self.limit is not None:
            n = max(0, min(n, self.limit - self.cursor))
        out = [self.make_record((self.cursor + j) * self.lanes + self.lane)
               for j in range(n)]
        self.cursor += len(out)
        return out

    def seek(self, cursor: int) -> None:
        self.cursor = cursor


class BoundedSink:
    """Feed store stage pushing micro-batches onto a bounded queue.  A
    full queue *blocks* the pump (backpressure) instead of dropping —
    the fix for silent feed-side loss under a slow storage stage."""

    def __init__(self, q: "queue.Queue[List[Any]]"):
        self.q = q

    def __call__(self, records: Sequence[Any]) -> None:
        if records:
            self.q.put(list(records), block=True)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

class Admission:
    """Outcome of one ``admit()`` attempt: truthy iff a slot was
    granted.  ``queue_wait_s`` is how long the request waited for its
    answer — the time-to-rejection for shed requests — and
    ``rejected_deadline`` marks a rejection caused by the per-request
    deadline rather than slot exhaustion."""

    __slots__ = ("ok", "queue_wait_s", "rejected_deadline")

    def __init__(self, ok: bool, queue_wait_s: float,
                 rejected_deadline: bool = False):
        self.ok = ok
        self.queue_wait_s = queue_wait_s
        self.rejected_deadline = rejected_deadline

    def __bool__(self) -> bool:
        return self.ok


_USE_DEFAULT = object()


class AdmissionController:
    """Caps in-flight queries with a semaphore.  ``admit()`` either
    grants a slot or rejects — open-loop clients keep offering load; the
    controller sheds it instead of queueing unboundedly.  Two rejection
    causes, counted separately:

    * *slots* — no slot freed within ``timeout`` seconds
      (``serve.admission.rejected``);
    * *deadline* — the request carries a deadline and its elapsed queue
      wait alone would blow it, so the slot wait is capped at the
      deadline and a too-late grant is returned unused
      (``serve.slo.rejected_deadline``, also counted in the rejected
      total).

    Every attempt's queue wait — including time-to-rejection — lands in
    the ``serve.queue_wait_s`` histogram, so shed load is visible in the
    same distribution as admitted load."""

    def __init__(self, max_inflight: int = 8, timeout: float = 0.2,
                 deadline_s: Optional[float] = None):
        self.max_inflight = int(max_inflight)
        self.timeout = float(timeout)
        self.deadline_s = deadline_s
        self._sem = threading.Semaphore(self.max_inflight)
        self._lock = threading.Lock()
        self.admitted = 0
        self.rejected = 0                  # all rejections
        self.rejected_deadline = 0         # the deadline-caused subset
        self._inflight = _obs.gauge("serve.admission.inflight")
        self._rejected_c = _obs.counter("serve.admission.rejected")
        self._rejected_deadline_c = _obs.counter("serve.slo.rejected_deadline")
        self._queue_wait = _obs.histogram("serve.queue_wait_s")

    @contextmanager
    def admit(self, deadline_s: Any = _USE_DEFAULT) -> Iterator[Admission]:
        dl = self.deadline_s if deadline_s is _USE_DEFAULT else deadline_s
        budget = self.timeout if dl is None else min(self.timeout, dl)
        t0 = time.perf_counter()
        ok = self._sem.acquire(timeout=budget)
        wait = time.perf_counter() - t0
        by_deadline = False
        if ok and dl is not None and wait >= dl:
            # the slot arrived, but too late: queue wait alone blew the
            # deadline — hand the slot back instead of executing a
            # request the client has already given up on
            self._sem.release()
            ok = False
            by_deadline = True
        elif not ok and dl is not None and wait >= dl:
            by_deadline = True
        self._queue_wait.observe(wait)
        if not ok:
            with self._lock:
                self.rejected += 1
                if by_deadline:
                    self.rejected_deadline += 1
            self._rejected_c.inc()
            if by_deadline:
                self._rejected_deadline_c.inc()
            yield Admission(False, wait, by_deadline)
            return
        with self._lock:
            self.admitted += 1
            self._inflight.set(self.max_inflight - self._sem._value)
        try:
            yield Admission(True, wait)
        finally:
            self._sem.release()


# ---------------------------------------------------------------------------
# Per-query request tracing + SLO accounting
# ---------------------------------------------------------------------------

@dataclass
class RequestRecord:
    """One query-worker submission: a monotone trace id, per-phase wall
    times, and — when sampled by the 1-in-N profiler — the real span
    tree, which carries kernel dispatch/transfer attribution and rides
    into the ``/trace`` exporter endpoint."""

    trace_id: int
    kind: str                            # "verify" | "query"
    profiled: bool = False
    t0: float = 0.0
    queue_wait_s: float = 0.0
    phases: Dict[str, float] = field(default_factory=dict)
    outcome: str = "ok"        # ok | error | rejected | rejected_deadline
    total_s: float = 0.0
    attained: Optional[bool] = None      # None: no deadline / rejected
    kernel: Dict[str, int] = field(default_factory=dict)
    spans: List[_tracer.Span] = field(default_factory=list)
    _root: Optional[_tracer.Span] = None

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Time one request phase; profiled requests additionally open a
        real tracer span (regardless of the global tracing flag) so
        ``obs.record_dispatch`` attributes kernel traffic to it."""
        sp: Optional[_tracer.Span] = None
        if self.profiled:
            sp = _tracer.Span(f"serve.phase.{name}",
                              {"trace_id": self.trace_id, "kind": self.kind})
            sp.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if sp is not None:
                sp.__exit__(None, None, None)
                self.spans.append(sp)
                for k in ("kernel_dispatches", "h2d_bytes", "d2h_bytes"):
                    if k in sp.attrs:
                        self.kernel[k] = self.kernel.get(k, 0) + sp.attrs[k]


class RequestTracker:
    """Assigns trace ids, settles SLO accounting, and keeps the bounded
    profile ring.

    Counters/histograms go to the global registry (the exporter's view)
    *and* to tracker-local tallies/histograms, so one harness's
    :class:`ServeReport` is never polluted by another harness sharing
    the process (tests run many)."""

    def __init__(self, deadline_s: Optional[float] = None,
                 profile_every: int = 16, profile_ring: int = 64):
        self.deadline_s = deadline_s
        self.profile_every = max(0, int(profile_every))
        self.profiles: Deque[RequestRecord] = deque(maxlen=int(profile_ring))
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.attained = 0
        self.missed = 0
        self.rejected_slots = 0
        self.rejected_deadline = 0
        self.completed = 0
        # local distributions for per-harness reporting
        self.queue_wait = _LocalHistogram("local.queue_wait_s")
        self.phase_hist: Dict[str, _LocalHistogram] = {
            p: _LocalHistogram(f"local.phase.{p}_s")
            for p in PHASES if p != "queue_wait"}
        # global registry handles (shared with every harness + exporter)
        self._g_attained = _obs.counter("serve.slo.attained")
        self._g_missed = _obs.counter("serve.slo.missed")
        self._g_profiled = _obs.counter("serve.request.profiled")
        self._g_phase = {p: _obs.histogram(f"serve.phase.{p}_s")
                         for p in PHASES if p != "queue_wait"}

    def begin(self, kind: str) -> RequestRecord:
        tid = next(self._ids)
        profiled = self.profile_every > 0 and tid % self.profile_every == 0
        rec = RequestRecord(trace_id=tid, kind=kind, profiled=profiled,
                            t0=time.perf_counter())
        if profiled:
            self._g_profiled.inc()
            rec._root = _tracer.Span("serve.request",
                                     {"trace_id": tid, "kind": kind})
            rec._root.__enter__()
        return rec

    def settle(self, rec: RequestRecord, grant: Optional[Admission] = None
               ) -> None:
        """Close out one request: fold the admission result in, observe
        the phase histograms, settle the SLO verdict, retain the profile."""
        rec.total_s = time.perf_counter() - rec.t0
        if grant is not None:
            rec.queue_wait_s = grant.queue_wait_s
            if not grant:
                rec.outcome = ("rejected_deadline" if grant.rejected_deadline
                               else "rejected")
        self.queue_wait.observe(rec.queue_wait_s)
        for p, dt in rec.phases.items():
            self.phase_hist[p].observe(dt)
            self._g_phase[p].observe(dt)
        rejected = rec.outcome in ("rejected", "rejected_deadline")
        with self._lock:
            if rec.outcome == "rejected":
                self.rejected_slots += 1
            elif rec.outcome == "rejected_deadline":
                self.rejected_deadline += 1
            else:
                self.completed += 1
        if not rejected and self.deadline_s is not None:
            rec.attained = rec.total_s <= self.deadline_s
            with self._lock:
                if rec.attained:
                    self.attained += 1
                else:
                    self.missed += 1
            (self._g_attained if rec.attained else self._g_missed).inc()
        if rec._root is not None:
            root = rec._root
            root.set("outcome", rec.outcome)
            root.set("queue_wait_s", rec.queue_wait_s)
            for p, dt in rec.phases.items():
                root.set(f"{p}_s", dt)
            root.__exit__(None, None, None)
            rec.spans.append(root)
            rec._root = None
            self.profiles.append(rec)

    def offered(self) -> int:
        with self._lock:
            return (self.completed + self.rejected_slots
                    + self.rejected_deadline)

    def profile_spans(self) -> List[_tracer.Span]:
        """Finished spans of every retained profiled request (the serve
        contribution to the exporter's ``/trace`` endpoint)."""
        return [sp for rec in list(self.profiles) for sp in rec.spans]


# ---------------------------------------------------------------------------
# Worker threads
# ---------------------------------------------------------------------------

class IngestPump(threading.Thread):
    """Runs one feed's intake→compute→store cycle until stopped or the
    adaptor is exhausted.  Parks (without consuming) while the harness
    gate is closed, so ``checkpoint()`` can quiesce the pipeline."""

    def __init__(self, feed: Feed, batch: int, gate: threading.Event,
                 stop: threading.Event):
        super().__init__(daemon=True, name=f"pump-{feed.name}")
        self.feed = feed
        self.batch = int(batch)
        self.gate = gate
        self.stop_ev = stop
        self.parked = threading.Event()
        self.exhausted = threading.Event()

    def run(self) -> None:
        while not self.stop_ev.is_set():
            if not self.gate.is_set():
                self.parked.set()
                self.gate.wait(0.02)
                continue
            self.parked.clear()
            self.feed.pump(self.batch)
            if self.feed.last_intake == 0:       # end of stream
                self.exhausted.set()
                self.parked.set()
                self.stop_ev.wait(0.02)
        self.parked.set()


class SinkWorker(threading.Thread):
    """Drains one ingest lane's bounded queue into the dataset and
    acknowledges primary keys *after* ``insert_batch`` returns — the ack
    list is the ground truth the consistency oracle checks against."""

    def __init__(self, harness: "ServeHarness", lane: int,
                 q: "queue.Queue[List[Any]]", stop: threading.Event):
        super().__init__(daemon=True, name=f"sink-{lane}")
        self.h = harness
        self.lane = lane
        self.q = q
        self.stop_ev = stop

    def run(self) -> None:
        ds, pk = self.h.dataset, self.h.dataset.pk
        acked_c = _obs.counter("serve.ingest.acked")
        while True:
            try:
                chunk = self.q.get(timeout=0.02)
            except queue.Empty:
                if self.stop_ev.is_set():
                    return
                continue
            try:
                ds.insert_batch(chunk)
                pks = [r[pk] for r in chunk]
                with self.h._ack_lock:
                    # a set, not a list: at-least-once replay after a
                    # crash re-delivers (and re-acks) records, and the
                    # consistency floor must count *distinct* acks
                    self.h.acked[self.lane].update(pks)
                acked_c.inc(len(pks))
            finally:
                self.q.task_done()


class QueryWorker(threading.Thread):
    """Open-loop query client: every submission is a tracked request —
    trace id, queue-wait/pin/execute/result phases, SLO settlement — and
    on an admitted slot runs either a snapshot verification scan (the
    consistency oracle) or an executor query over a pinned snapshot,
    observing the latency histogram."""

    def __init__(self, harness: "ServeHarness", idx: int,
                 stop: threading.Event):
        super().__init__(daemon=True, name=f"query-{idx}")
        self.h = harness
        self.idx = idx
        self.stop_ev = stop
        self.queries = 0
        self.torn = 0
        self.lost = 0
        self.errors: List[str] = []

    def run(self) -> None:
        lat = _obs.histogram("serve.query.latency_s")
        torn_c = _obs.counter("serve.query.torn_reads")
        lost_c = _obs.counter("serve.query.lost_acks")
        tracker = self.h.tracker
        i = 0
        while not self.stop_ev.is_set():
            kind = "verify" if i % 2 == 0 else "query"
            req = tracker.begin(kind)
            with self.h.admission.admit() as grant:
                if not grant:
                    tracker.settle(req, grant)
                    continue
                req.queue_wait_s = grant.queue_wait_s
                t0 = time.perf_counter()
                try:
                    if kind == "verify":
                        torn, lost = self.h.verify_snapshot(req)
                        if torn:
                            self.torn += 1
                            torn_c.inc()
                        if lost:
                            self.lost += 1
                            lost_c.inc()
                    else:
                        self.h.executor_query(self.idx + i, req)
                except Exception as e:            # noqa: BLE001
                    req.outcome = "error"
                    self.errors.append(f"{type(e).__name__}: {e}")
                lat.observe(time.perf_counter() - t0)
                self.queries += 1
                i += 1
            tracker.settle(req)


# ---------------------------------------------------------------------------
# Report + harness
# ---------------------------------------------------------------------------

@dataclass
class ServeReport:
    """Outcome of one mixed-workload run (see ``as_dict`` for the JSON
    schema serve_bench emits).  Beyond throughput/consistency, carries
    the SLO ledger (attained / missed / rejected-by-deadline on the
    per-request deadline), the admission queue-wait distribution —
    rejections included — and the per-phase p99 attribution table that
    names which phase dominates tail latency."""
    duration_s: float
    ingest_acked: int
    ingest_rate: float            # acked records / wall second
    queries: int
    admission_rejected: int
    query_p50_ms: Optional[float]
    query_p99_ms: Optional[float]
    torn_reads: int
    lost_acks: int                # live-scan floor violations
    lost_acked_final: int         # acked pks missing from the final scan
    recoveries: int
    query_errors: List[str] = field(default_factory=list)
    # --- request tracing / SLO accounting ---
    deadline_ms: Optional[float] = None
    slo_attained: int = 0
    slo_missed: int = 0
    slo_rejected_deadline: int = 0
    rejection_rate: float = 0.0          # all rejections / offered requests
    deadline_miss_rate: float = 0.0      # (missed + rejected_deadline)/offered
    queue_wait_p50_ms: Optional[float] = None
    queue_wait_p99_ms: Optional[float] = None
    phase_p99_ms: Dict[str, Optional[float]] = field(default_factory=dict)
    slowest_phase_p99: Optional[str] = None
    profiled_requests: int = 0

    @property
    def slo_attainment(self) -> Optional[float]:
        """attained / (attained + missed + rejected_deadline); None when
        no deadline was configured."""
        denom = self.slo_attained + self.slo_missed + \
            self.slo_rejected_deadline
        if self.deadline_ms is None or denom == 0:
            return None
        return self.slo_attained / denom

    def as_dict(self) -> Dict[str, Any]:
        return {
            "duration_s": self.duration_s,
            "ingest_acked": self.ingest_acked,
            "ingest_rate": self.ingest_rate,
            "queries": self.queries,
            "admission_rejected": self.admission_rejected,
            "query_p50_ms": self.query_p50_ms,
            "query_p99_ms": self.query_p99_ms,
            "torn_reads": self.torn_reads,
            "lost_acks": self.lost_acks,
            "lost_acked_final": self.lost_acked_final,
            "recoveries": self.recoveries,
            "query_errors": self.query_errors[:8],
            "slo": {
                "deadline_ms": self.deadline_ms,
                "attained": self.slo_attained,
                "missed": self.slo_missed,
                "rejected_deadline": self.slo_rejected_deadline,
                "attainment": self.slo_attainment,
            },
            "rejection_rate": self.rejection_rate,
            "deadline_miss_rate": self.deadline_miss_rate,
            "queue_wait_p50_ms": self.queue_wait_p50_ms,
            "queue_wait_p99_ms": self.queue_wait_p99_ms,
            "phase_p99_ms": dict(self.phase_p99_ms),
            "slowest_phase_p99": self.slowest_phase_p99,
            "profiled_requests": self.profiled_requests,
        }


class ServeHarness:
    """Concurrent serving loop over one ``PartitionedDataset``: N ingest
    lanes + M query workers under admission control.  ``run(duration_s)``
    is the one-call entry; ``start()``/``stop()`` plus ``checkpoint()``
    and ``crash_and_recover()`` compose for fault-injection tests."""

    def __init__(self, dataset: Any, *, n_ingest: int = 2, n_query: int = 2,
                 pump_batch: int = 64, queue_depth: int = 8,
                 max_inflight: int = 8,
                 make_record: Optional[Callable[[int], Dict[str, Any]]] = None,
                 records_per_lane: Optional[int] = None,
                 joint_window: int = 4096,
                 deadline_s: Optional[float] = None,
                 admission_timeout: float = 0.2,
                 profile_every: int = 16, profile_ring: int = 64):
        self.dataset = dataset
        self.n_ingest = int(n_ingest)
        self.n_query = int(n_query)
        self.pump_batch = int(pump_batch)
        self.queue_depth = int(queue_depth)
        self.joint_window = int(joint_window)
        self.deadline_s = deadline_s
        self.admission = AdmissionController(max_inflight,
                                             timeout=admission_timeout,
                                             deadline_s=deadline_s)
        self.tracker = RequestTracker(deadline_s=deadline_s,
                                      profile_every=profile_every,
                                      profile_ring=profile_ring)
        self.acked: List[set] = [set() for _ in range(self.n_ingest)]
        self._ack_lock = threading.Lock()
        self.recoveries = 0
        self.feeds: List[Feed] = []
        self.queues: List["queue.Queue[List[Any]]"] = []
        for lane in range(self.n_ingest):
            q: "queue.Queue[List[Any]]" = queue.Queue(maxsize=queue_depth)
            adaptor = StridedRecordAdaptor(lane, self.n_ingest,
                                           make_record=make_record,
                                           limit=records_per_lane)
            feed = Feed(name=f"{dataset.name}-ingest{lane}",
                        adaptor=adaptor, store=BoundedSink(q),
                        joint=FeedJoint(window=self.joint_window,
                                        name=f"{dataset.name}-ingest{lane}"))
            self.queues.append(q)
            self.feeds.append(feed)
        self._ckpt: Optional[List[Dict[str, Any]]] = None
        self._gate = threading.Event()
        self._stop = threading.Event()
        self._pumps: List[IngestPump] = []
        self._sinks: List[SinkWorker] = []
        self._workers: List[QueryWorker] = []
        self._done_workers: List[QueryWorker] = []
        self._t0: Optional[float] = None
        self._elapsed = 0.0

    # -- query surface ------------------------------------------------------
    def verify_snapshot(self, req: Optional[RequestRecord] = None
                        ) -> "tuple[bool, bool]":
        """Pin a snapshot and check the lane-prefix consistency oracle.
        Returns (torn, lost): ``torn`` — some lane's key set is not a
        prefix of its insertion order; ``lost`` — some lane holds fewer
        keys than were acknowledged before the pin.  ``req`` (a tracked
        request) splits the work into pin / execute / result phases."""
        ph = req.phase if req is not None else _null_phase
        lanes = self.n_ingest
        with ph("pin"):
            with self._ack_lock:
                floors = [len(a) for a in self.acked]
            snap = self.dataset.pin()
        with ph("execute"):
            try:
                parts = [snap.partition_pk_array(i)
                         for i in range(self.dataset.num_partitions)]
            finally:
                snap.release()
        with ph("result"):
            parts = [p for p in parts if p.size]
            pks = (np.concatenate(parts) if parts
                   else np.empty(0, dtype=np.int64)).astype(np.int64)
            torn = lost = False
            for lane in range(lanes):
                lane_pks = pks[pks % lanes == lane]
                k = int(lane_pks.size)
                if k and (int(lane_pks.max()) // lanes != k - 1
                          or np.unique(lane_pks).size != k):
                    torn = True
                if k < floors[lane]:
                    lost = True
        return torn, lost

    def executor_query(self, salt: int,
                       req: Optional[RequestRecord] = None) -> int:
        """One executor query through the optimizer + row/columnar engine
        over a pinned snapshot.  With a tracked request the pin is taken
        explicitly so its cost lands in the pin phase, and the executor
        runs against the snapshot facade (``run_query`` skips re-pinning
        an already-pinned ``DatasetSnapshot``)."""
        ph = req.phase if req is not None else _null_phase
        pk = self.dataset.pk
        r = salt % 7
        plan = A.select(A.scan(self.dataset.name),
                        pred=lambda row: row[pk] % 7 == r,
                        fields=[pk])
        with ph("pin"):
            snap = self.dataset.pin()
        try:
            with ph("execute"):
                rows, _ = run_query(plan, {self.dataset.name: snap})
            with ph("result"):
                return len(rows)
        finally:
            snap.release()

    # -- lifecycle ----------------------------------------------------------
    def _spawn(self) -> None:
        self._stop = threading.Event()
        self._pumps = [IngestPump(f, self.pump_batch, self._gate, self._stop)
                       for f in self.feeds]
        self._sinks = [SinkWorker(self, lane, q, self._stop)
                       for lane, q in enumerate(self.queues)]
        self._workers = [QueryWorker(self, j, self._stop)
                         for j in range(self.n_query)]
        for t in self._pumps + self._sinks + self._workers:
            t.start()

    def start(self) -> None:
        if self._ckpt is None:
            self._ckpt = [f.state() for f in self.feeds]   # initial cursors
        self._gate.set()
        self._t0 = time.perf_counter()
        self._spawn()

    def stop(self) -> None:
        """Quiesce and join every thread (queues drain first, so all
        pumped records are delivered and acked)."""
        self._quiesce()
        self._stop.set()
        for t in self._pumps + self._sinks + self._workers:
            t.join(timeout=10.0)
        self._done_workers.extend(self._workers)
        self._workers = []
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    def _quiesce(self) -> None:
        self._gate.clear()
        for p in self._pumps:
            end = time.perf_counter() + 10.0
            while not p.parked.wait(0.05) and time.perf_counter() < end:
                self._check_sinks()        # a pump blocks on a dead lane
        for q in self.queues:
            with q.all_tasks_done:         # q.join(): every chunk acked
                while q.unfinished_tasks:
                    self._check_sinks()
                    q.all_tasks_done.wait(0.05)

    def _check_sinks(self) -> None:
        """Raise if a sink has died with chunks queued: they would never
        be acknowledged, and a full queue blocks its pump for good."""
        for sink, q in zip(self._sinks, self.queues):
            if not sink.is_alive() and q.unfinished_tasks:
                raise RuntimeError(f"{sink.name} died with "
                                   f"{q.unfinished_tasks} chunks undelivered")

    def exhausted(self) -> bool:
        return all(p.exhausted.is_set() for p in self._pumps)

    def checkpoint(self) -> List[Dict[str, Any]]:
        """Park the pumps, drain the queues, capture every feed cursor,
        resume.  The captured state is durable: everything at or before
        each cursor has been acked to storage."""
        self._quiesce()
        self._ckpt = [f.state() for f in self.feeds]
        self._gate.set()
        return self._ckpt

    def crash_and_recover(self) -> None:
        """Kill the pipeline mid-flight, rebuild the dataset from (valid
        components + WAL), restore feeds from the last checkpoint and
        resume pumping — at-least-once replay; PK upserts dedupe."""
        self._stop.set()
        self._gate.set()                   # unblock parked pumps to exit
        for t in self._pumps + self._sinks + self._workers:
            t.join(timeout=10.0)
        self._done_workers.extend(self._workers)
        for q in self.queues:              # drop in-flight chunks: the
            while True:                    # replay below re-delivers them
                try:
                    q.get_nowait()
                    q.task_done()
                except queue.Empty:
                    break
        self.dataset.crash_and_recover()
        self.recoveries += 1
        _obs.counter("serve.recoveries").inc()
        if self._ckpt is not None:
            for f, st in zip(self.feeds, self._ckpt):
                f.restore(st)
        self._gate.set()
        self._spawn()

    # -- run loop -----------------------------------------------------------
    def run(self, duration_s: float = 2.0,
            checkpoint_after: Optional[int] = None,
            crash_after: Optional[int] = None) -> ServeReport:
        """Drive the mixed workload for ``duration_s`` (or until every
        lane's adaptor is exhausted).  ``checkpoint_after`` /
        ``crash_after`` are total-acked-record thresholds: once acks
        pass ``checkpoint_after`` a checkpoint is taken, and once they
        pass ``crash_after`` the pipeline is crashed and recovered —
        everything acked between the two replays at-least-once."""
        self.start()
        deadline = time.perf_counter() + duration_s
        did_ckpt = checkpoint_after is None
        did_crash = crash_after is None
        while time.perf_counter() < deadline:
            with self._ack_lock:
                total = sum(len(a) for a in self.acked)
            if not did_ckpt and total >= checkpoint_after:
                self.checkpoint()
                did_ckpt = True
            if did_ckpt and not did_crash and total >= crash_after:
                self.crash_and_recover()
                did_crash = True
            if self.exhausted() and did_ckpt and did_crash:
                break
            time.sleep(0.005)
        self.stop()
        return self.report()

    def report(self) -> ServeReport:
        lat = _obs.histogram("serve.query.latency_s")
        with self._ack_lock:
            acked_sets = [set(a) for a in self.acked]   # defensive copies
        n_acked = sum(len(s) for s in acked_sets)
        final = set()
        for i in range(self.dataset.num_partitions):
            final.update(int(x) for x in
                         self.dataset.partition_pk_array(i).tolist())
        lost_final = sum(len(s - final) for s in acked_sets)
        workers = self._done_workers + self._workers
        elapsed = self._elapsed if self._elapsed > 0 else 1e-9
        p50 = lat.percentile(50)
        p99 = lat.percentile(99)
        tr = self.tracker
        offered = tr.offered()
        rejected_all = tr.rejected_slots + tr.rejected_deadline
        missed_all = tr.missed + tr.rejected_deadline
        qw50 = tr.queue_wait.percentile(50)
        qw99 = tr.queue_wait.percentile(99)
        # tail-latency attribution: p99 of each phase across this
        # harness's requests — the table that names what dominates p99
        phase_p99: Dict[str, Optional[float]] = {}
        qw = qw99
        phase_p99["queue_wait"] = None if qw is None else qw * 1e3
        for p, h in tr.phase_hist.items():
            v = h.percentile(99)
            phase_p99[p] = None if v is None else v * 1e3
        known = {p: v for p, v in phase_p99.items() if v is not None}
        slowest = max(known, key=known.get) if known else None
        return ServeReport(
            duration_s=elapsed,
            ingest_acked=n_acked,
            ingest_rate=n_acked / elapsed,
            queries=sum(w.queries for w in workers),
            admission_rejected=self.admission.rejected,
            query_p50_ms=None if p50 is None else p50 * 1e3,
            query_p99_ms=None if p99 is None else p99 * 1e3,
            torn_reads=sum(w.torn for w in workers),
            lost_acks=sum(w.lost for w in workers),
            lost_acked_final=lost_final,
            recoveries=self.recoveries,
            query_errors=[e for w in workers for e in w.errors],
            deadline_ms=(None if self.deadline_s is None
                         else self.deadline_s * 1e3),
            slo_attained=tr.attained,
            slo_missed=tr.missed,
            slo_rejected_deadline=tr.rejected_deadline,
            rejection_rate=rejected_all / offered if offered else 0.0,
            deadline_miss_rate=missed_all / offered if offered else 0.0,
            queue_wait_p50_ms=None if qw50 is None else qw50 * 1e3,
            queue_wait_p99_ms=None if qw99 is None else qw99 * 1e3,
            phase_p99_ms=phase_p99,
            slowest_phase_p99=slowest,
            profiled_requests=len(tr.profiles),
        )
