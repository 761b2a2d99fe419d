"""Concurrent serving harness (paper §2.4, §4.4).

The paper's headline workload is continuous feed ingestion *while*
serving queries "with transaction support akin to that of a NoSQL
store".  This package provides the admission-controlled server loop
that drives both sides against one :class:`PartitionedDataset`:

* **ingest lanes** — N feed pumps, each an intake→compute→store
  :class:`~repro_torch.data.feeds.Feed` whose store stage is a *bounded*
  queue (backpressure: block, never drop) drained by a sink worker
  delivering micro-batches via ``insert_batch``;
* **query lanes** — M workers running snapshot-isolated reads
  (``PartitionedDataset.pin()`` / ``run_query(snapshot=True)``) behind
  an admission controller capping in-flight queries;
* **fault tolerance** — ``checkpoint()`` quiesces the pipeline and
  captures every feed cursor; ``crash_and_recover()`` rebuilds the
  dataset from (components + WAL) and replays feeds from the last
  checkpoint — at-least-once delivery made exactly-once by PK-idempotent
  upserts.

Every query worker doubles as a consistency checker: lane-strided
primary keys make "some prefix of each lane's acknowledged inserts" the
exact snapshot invariant, so torn reads and lost acknowledged records
are *counted*, not hoped against.

The port's copy of the reference's ``repro/serve`` package, with the
same exports.  ``chip_smoke.py``'s ``feeds`` phase drives it on the card
with query threads of its own beside the harness's workers.
"""

from .harness import (Admission, AdmissionController, BoundedSink,
                      IngestPump, QueryWorker, RequestRecord, RequestTracker,
                      ServeHarness, ServeReport, SinkWorker,
                      StridedRecordAdaptor)

__all__ = ["Admission", "AdmissionController", "BoundedSink", "IngestPump",
           "QueryWorker", "RequestRecord", "RequestTracker", "ServeHarness",
           "ServeReport", "SinkWorker", "StridedRecordAdaptor"]
