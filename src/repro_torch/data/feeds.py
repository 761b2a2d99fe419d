"""Data feeds — continuous ingestion pipelines (paper §2.4, §4.5).

The paper's feed = intake -> compute (UDF) -> store stages with *feed joints*
(buffered taps with a subscription mechanism) so cascading feeds share one
upstream.  Adapted to the training substrate:

  intake   — an adaptor pulls records from a source (socket/file/synthetic
             token stream); primary feeds own an adaptor, secondary feeds
             subscribe to a joint of another feed.
  compute  — per-record UDFs (tokenize/pack/augment), applied in order.
  store    — terminal sink: a ``DatasetSink`` accumulating per-dataset
             micro-batches delivered via ``PartitionedDataset
             .insert_batch`` (the BDMS path: batches flow into memory
             components and flush columnar, never touching a per-record
             code path) or a device-batch assembler for the trainer
             (the LM path).

Fault tolerance (paper [15]): every joint keeps a monotone *cursor* (records
emitted) and a bounded replay buffer; a cursor is checkpointed with the model
so training resumes deterministically mid-stream.  Straggler mitigation:
``RedundantIntake`` races two adaptors and keeps the first answer per batch
(speculative retry at the data layer).

This is the port's copy of the reference's feeds
(``repro/data/feeds.py``), with the same classes, cursors, checkpoint
state and ``feed.*`` metrics.  Feeds are host code: records stay python
dicts and numpy arrays; they reach the card only through the store
stage (``DatasetSink`` -> ``insert_batch``, whose LSM merges run K3).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

import numpy as np

from .. import obs as _obs

__all__ = ["Adaptor", "SyntheticTokenAdaptor", "FileAdaptor", "SocketAdaptor",
           "FeedJoint", "FeedOverflow", "Feed", "RedundantIntake",
           "BatchAssembler", "DatasetSink"]


class FeedOverflow(RuntimeError):
    """Raised by ``FeedJoint.publish`` under the ``overflow='raise'``
    policy when buffering the new records would evict records a live
    subscriber has not consumed yet.  The joint is left unchanged, so
    the publisher can apply backpressure and retry after consumers
    catch up."""


# ---------------------------------------------------------------------------
# Adaptors (paper: socket_adaptor + built-ins + custom)
# ---------------------------------------------------------------------------

class Adaptor:
    """Pull-based record source.  next_batch(n) returns < n records only at
    end-of-stream."""

    def next_batch(self, n: int) -> List[Any]:  # pragma: no cover - interface
        raise NotImplementedError

    def seek(self, cursor: int) -> None:
        """Reposition to absolute record offset (deterministic replay)."""
        raise NotImplementedError


class SyntheticTokenAdaptor(Adaptor):
    """Deterministic synthetic LM token stream: record = dict with tokens /
    labels (next-token shift), seeded per document id so any cursor is
    reproducible without state."""

    def __init__(self, seq_len: int, vocab_size: int, seed: int = 0):
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed
        self.cursor = 0

    def _record(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ i)
        toks = rng.integers(0, self.vocab_size, self.seq_len + 1,
                            dtype=np.int32)
        return {"doc_id": i, "tokens": toks[:-1], "labels": toks[1:]}

    def next_batch(self, n: int) -> List[Any]:
        out = [self._record(self.cursor + j) for j in range(n)]
        self.cursor += n
        return out

    def seek(self, cursor: int) -> None:
        self.cursor = cursor


class FileAdaptor(Adaptor):
    """Local-file adaptor (paper Data definition 3): one record per line,
    parsed by ``parse`` (e.g. the CSV web-log schema of Figure 3)."""

    def __init__(self, path: str, parse: Callable[[str], Any]):
        self.lines = open(path).read().splitlines()
        self.parse = parse
        self.cursor = 0

    def next_batch(self, n: int) -> List[Any]:
        out = [self.parse(l) for l in
               self.lines[self.cursor:self.cursor + n]]
        self.cursor += len(out)
        return out

    def seek(self, cursor: int) -> None:
        self.cursor = cursor


class SocketAdaptor(Adaptor):
    """Push-source stand-in: records are .push()ed by a producer and pulled
    by the feed (models the paper's TCP socket_adaptor without real I/O)."""

    def __init__(self):
        self.queue: collections.deque = collections.deque()
        self.cursor = 0

    def push(self, records: Iterable[Any]) -> None:
        self.queue.extend(records)

    def next_batch(self, n: int) -> List[Any]:
        out = []
        while self.queue and len(out) < n:
            out.append(self.queue.popleft())
        self.cursor += len(out)
        return out

    def seek(self, cursor: int) -> None:  # push sources replay via producer
        self.cursor = cursor


class RedundantIntake(Adaptor):
    """Straggler mitigation: race N equivalent adaptors, first-wins per batch.

    On a real cluster the replicas would be raced over RPC with a timeout;
    here the race is simulated via per-adaptor ``latency`` callables so tests
    can inject stragglers deterministically.  Records must be deterministic
    per cursor (true for seekable adaptors), so whichever replica answers
    first yields identical data — the feed stays exactly-once.
    """

    def __init__(self, adaptors: Sequence[Adaptor],
                 latency: Optional[Callable[[int, int], float]] = None):
        assert adaptors
        self.adaptors = list(adaptors)
        self.latency = latency or (lambda replica, batch: 0.0)
        self.cursor = 0
        self.stats = {"wins": [0] * len(adaptors)}

    def next_batch(self, n: int) -> List[Any]:
        lat = [self.latency(i, self.cursor) for i in range(len(self.adaptors))]
        winner = int(np.argmin(lat))
        self.stats["wins"][winner] += 1
        ad = self.adaptors[winner]
        ad.seek(self.cursor)
        out = ad.next_batch(n)
        self.cursor += len(out)
        return out

    def seek(self, cursor: int) -> None:
        self.cursor = cursor


# ---------------------------------------------------------------------------
# Feed joints + feeds
# ---------------------------------------------------------------------------

class FeedJoint:
    """A tap on a feed's dataflow: buffers records and lets any number of
    subscribers consume at their own pace (bounded replay window).

    ``overflow`` selects what happens when a publish would push records a
    live subscriber has not consumed yet out of the window:

    * ``"drop"`` (default) — evict them anyway but count every unconsumed
      record lost in the ``feed.joint.<name>.dropped`` obs counter; the
      lagging subscriber's next ``consume`` raises as before.
    * ``"raise"`` — refuse the publish with :class:`FeedOverflow` and
      leave the joint untouched, so the publisher can block/retry
      (backpressure — the serving harness uses this).

    Records every subscriber has consumed always retire silently.
    """

    def __init__(self, window: int = 4096, name: Optional[str] = None,
                 overflow: str = "drop"):
        assert overflow in ("drop", "raise"), overflow
        self.window = window
        self.name = name
        self.overflow = overflow
        self.buffer: collections.deque = collections.deque()
        self.base = 0                      # cursor of buffer[0]
        self.subscribers: Dict[str, int] = {}
        self.published = 0
        self.dropped = 0                   # unconsumed records evicted
        self._first_publish_t: Optional[float] = None
        self._last_publish_t: Optional[float] = None
        self._lock = threading.RLock()     # concurrent pump/consume safety

    @property
    def head(self) -> int:
        return self.base + len(self.buffer)

    def rate(self) -> float:
        """Ingest rate in records/sec over the joint's publish lifetime
        (first publish to last publish); 0.0 until two publish instants."""
        if self._first_publish_t is None or self._last_publish_t is None:
            return 0.0
        elapsed = self._last_publish_t - self._first_publish_t
        return self.published / elapsed if elapsed > 0 else 0.0

    def publish(self, records: Sequence[Any]) -> None:
        with self._lock:
            floor = min(self.subscribers.values(), default=self.head)
            if self.overflow == "raise":
                retirable = max(0, floor - self.base)
                if len(self.buffer) - retirable + len(records) > self.window:
                    raise FeedOverflow(
                        f"joint {self.name or 'joint'}: publishing "
                        f"{len(records)} records would evict unconsumed "
                        f"records (floor={floor}, window={self.window})")
            now = time.perf_counter()
            if self._first_publish_t is None:
                self._first_publish_t = now
            self._last_publish_t = now
            self.published += len(records)
            _obs.counter(f"feed.joint.{self.name or 'joint'}.published").inc(
                len(records))
            self.buffer.extend(records)
            # retire records every subscriber has consumed; past the
            # subscriber floor evict only on window overflow, and count
            # each unconsumed record lost
            dropped = 0
            while len(self.buffer) > self.window or self.base < floor:
                if self.base >= floor and len(self.buffer) <= self.window:
                    break
                self.buffer.popleft()
                if self.base >= floor:
                    dropped += 1
                self.base += 1
            if dropped:
                self.dropped += dropped
                _obs.counter(
                    f"feed.joint.{self.name or 'joint'}.dropped").inc(dropped)

    def subscribe(self, name: str, cursor: Optional[int] = None) -> None:
        with self._lock:
            self.subscribers[name] = self.head if cursor is None else cursor

    def consume(self, name: str, n: int) -> List[Any]:
        with self._lock:
            cur = self.subscribers[name]
            if cur < self.base:
                raise RuntimeError(
                    f"subscriber {name} fell behind the replay window "
                    f"({cur} < {self.base}); re-seed from checkpoint")
            start = cur - self.base
            out = list(itertools.islice(self.buffer, start, start + n))
            self.subscribers[name] = cur + len(out)
            _obs.gauge(f"feed.joint.{self.name or 'joint'}.lag.{name}").set(
                self.head - self.subscribers[name])
            return out


@dataclass
class Feed:
    """intake -> compute(UDFs) -> store, with a joint after compute.

    ``store`` is optional: a callable sink (e.g. PartitionedDataset.insert or
    a BatchAssembler).  Secondary feeds pass ``source_joint`` instead of an
    adaptor (paper §2.4 'Secondary Feeds ... fed from other feeds')."""

    name: str
    adaptor: Optional[Adaptor] = None
    udfs: List[Callable[[Any], Any]] = field(default_factory=list)
    store: Optional[Callable[[Sequence[Any]], None]] = None
    source_joint: Optional[FeedJoint] = None
    joint: FeedJoint = field(default_factory=FeedJoint)
    cursor: int = 0            # records *taken in* from the source
    last_intake: int = 0       # intake size of the most recent pump

    def __post_init__(self):
        assert (self.adaptor is None) != (self.source_joint is None), \
            "exactly one of adaptor / source_joint"
        if self.joint.name is None:
            self.joint.name = self.name
        if self.source_joint is not None:
            self.source_joint.subscribe(self.name)

    def pump(self, n: int) -> int:
        """Run one intake->compute->store cycle of up to n records.
        Returns the *post-filter* record count delivered downstream; the
        checkpoint ``cursor`` advances by the *pre-filter* intake count
        (also exposed as ``last_intake``) so a ``restore()`` seeks the
        adaptor to the true source offset even when UDFs filter records
        — otherwise replay would re-deliver already-processed records."""
        with _obs.span("feed.pump." + self.name) as sp:
            if self.adaptor is not None:
                recs = self.adaptor.next_batch(n)
            else:
                recs = self.source_joint.consume(self.name, n)
            intake = len(recs)
            for udf in self.udfs:
                recs = [udf(r) for r in recs]
                recs = [r for r in recs if r is not None]  # UDFs may filter
            self.joint.publish(recs)
            if self.store is not None:
                self.store(recs)
            self.cursor += intake
            self.last_intake = intake
            sp.set("records", len(recs))
        _obs.counter(f"feed.{self.name}.records").inc(len(recs))
        _obs.histogram(f"feed.{self.name}.batch_records").observe(len(recs))
        return len(recs)

    # -- checkpointable state (exact-resume deliverable) -------------------
    def state(self) -> Dict[str, Any]:
        st = {"name": self.name, "cursor": self.cursor,
              "subscribers": dict(self.joint.subscribers)}
        if self.source_joint is not None:
            # a secondary feed's own consume position lives in the
            # *source* joint's subscriber table, not in self.joint
            st["source_cursor"] = self.source_joint.subscribers[self.name]
        return st

    def restore(self, state: Dict[str, Any]) -> None:
        self.cursor = state["cursor"]
        if self.adaptor is not None:
            self.adaptor.seek(self.cursor)
        self.joint.subscribers.update(state.get("subscribers", {}))
        if self.source_joint is not None and "source_cursor" in state:
            self.source_joint.subscribe(self.name, state["source_cursor"])


class DatasetSink:
    """Store-stage sink for a PartitionedDataset: accumulates records into
    micro-batches and delivers them via ``insert_batch``, so the feed ->
    memory component -> flush pipeline ingests batch-wise end to end
    (paper [15]'s fault-tolerant feeds meet the columnar-native storage:
    a full micro-batch becomes one WAL+memtable pass per partition and
    flushes shred straight into component ColumnBatches).

    ``flush()`` pushes a partial tail batch (call it at end-of-stream or
    before a checkpoint); ``(feed cursor, len(backlog))`` is the
    deterministic ingestion checkpoint, mirroring ``BatchAssembler``.
    """

    def __init__(self, dataset: Any, batch_size: int = 256):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.backlog: List[Any] = []
        self.stats = {"batches": 0, "records": 0}
        self._ds_name = getattr(dataset, "name", "dataset")

    def _record_batch(self, n: int) -> None:
        self.stats["batches"] += 1
        self.stats["records"] += n
        _obs.counter(f"feed.sink.{self._ds_name}.records").inc(n)
        _obs.histogram(f"feed.sink.{self._ds_name}.batch_records").observe(n)

    def __call__(self, records: Sequence[Any]) -> None:
        self.backlog.extend(records)
        # drain by index in one pass — re-slicing the backlog per chunk
        # is O(n^2) on large pumps
        pos = 0
        while len(self.backlog) - pos >= self.batch_size:
            chunk = self.backlog[pos:pos + self.batch_size]
            pos += self.batch_size
            self.dataset.insert_batch(chunk)
            self._record_batch(len(chunk))
        if pos:
            del self.backlog[:pos]
        _obs.gauge(f"feed.sink.{self._ds_name}.backlog").set(
            len(self.backlog))

    def flush(self) -> int:
        """Deliver any buffered tail; returns the number of records
        pushed."""
        n = len(self.backlog)
        if n:
            self.dataset.insert_batch(self.backlog)
            self.backlog = []
            self._record_batch(n)
        _obs.gauge(f"feed.sink.{self._ds_name}.backlog").set(0)
        return n


class BatchAssembler:
    """Store-stage sink assembling fixed-size global batches for the trainer.

    Call ``take()`` to pop a [global_batch, seq] numpy batch; returns None
    until enough records buffered.  The (feed cursor, assembler backlog) pair
    is the deterministic data-position checkpoint.
    """

    def __init__(self, global_batch: int):
        self.global_batch = global_batch
        self.backlog: List[Any] = []

    def __call__(self, records: Sequence[Any]) -> None:
        self.backlog.extend(records)

    def take(self) -> Optional[Dict[str, np.ndarray]]:
        if len(self.backlog) < self.global_batch:
            return None
        recs, self.backlog = (self.backlog[:self.global_batch],
                              self.backlog[self.global_batch:])
        return {
            "tokens": np.stack([r["tokens"] for r in recs]),
            "labels": np.stack([r["labels"] for r in recs]),
        }
