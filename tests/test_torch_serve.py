"""The PyTorch port's serving harness (``repro_torch.serve``) and the
snapshot isolation it stands on, against the reference (``repro.serve``).

Mirrors ``tests/test_serve.py`` (snapshot pin / unpin lifecycle, the
threaded ingest + query stress oracle, the harness end to end and the
feed-layer regressions) and the harness cases of
``tests/test_obs_export.py`` (a live ``/metrics`` scrape, deadline
admission and SLO settlement, shedding by deadline, the profile ring) on
the port at small sizes.  Where the outcome is deterministic both
packages run and must agree exactly; the threaded harness runs in both
packages and both must keep the consistency ledger clean.  A lockstep
test (no threads) ingests through ``Feed`` + ``DatasetSink`` with a
checkpoint, a crash and a replay into each package's dataset, then runs
``chip_smoke.py``'s three feeds-phase queries with ``vectorize=True``
and the plan cache on and off: rows by exact ``repr`` and the fallback
reasons equal.  The reference is imported under the test-side x64 shim
of ``tests/_torch_ref.py``.
"""

import pathlib
import queue
import re
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

import repro_torch  # noqa: E402

from _torch_ref import canon, reference_x64  # noqa: E402
from chip_smoke import feed_plans  # noqa: E402


def _namespace():
    from repro_torch import obs
    from repro_torch.columnar import plancache
    from repro_torch.core import adm, algebra, lsm
    from repro_torch.data import feeds
    from repro_torch.obs import export
    from repro_torch import serve
    from repro_torch.storage import dataset, query
    return types.SimpleNamespace(obs=obs, PC=plancache, adm=adm, A=algebra,
                                 lsm=lsm, feeds=feeds, export=export,
                                 serve=serve, dsm=dataset,
                                 run_query=query.run_query)


PORT = _namespace()


@pytest.fixture(scope="module")
def REF():
    with reference_x64():
        from repro import obs
        from repro.columnar import plancache
        from repro.core import adm, algebra, lsm
        from repro.data import feeds
        from repro.obs import export
        from repro import serve
        from repro.storage import dataset, query
        yield types.SimpleNamespace(obs=obs, PC=plancache, adm=adm,
                                    A=algebra, lsm=lsm, feeds=feeds,
                                    export=export, serve=serve, dsm=dataset,
                                    run_query=query.run_query)


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")
    PORT.obs.disable()
    yield
    PORT.obs.disable()
    PORT.PC.set_enabled(True)


def pkgs(REF):
    return (("port", PORT), ("reference", REF))


def _ds(pkg, parts=4, threshold=64, name="S", k=3):
    rt = pkg.adm.RecordType("R", (pkg.adm.Field("pk", pkg.adm.INT64),
                                  pkg.adm.Field("val", pkg.adm.INT64)),
                            open=True)
    return pkg.dsm.PartitionedDataset(
        name, rt, "pk", num_partitions=parts, flush_threshold=threshold,
        merge_policy=pkg.lsm.TieredMergePolicy(k=k))


def _final_pks(ds):
    out = set()
    for i in range(ds.num_partitions):
        out.update(int(x) for x in ds.partition_pk_array(i).tolist())
    return out


# ---------------------------------------------------------------------------
# tests/test_serve.py:35-126: pin / unpin and dataset snapshots (the port)
# ---------------------------------------------------------------------------

def test_pin_defers_component_retirement_until_unpin():
    L = PORT.lsm
    ix = L.LSMIndex(flush_threshold=100,
                    merge_policy=L.TieredMergePolicy(k=99))
    for i in range(6):
        ix.insert(i, {"pk": i})
    ix.flush()
    for i in range(6, 12):
        ix.insert(i, {"pk": i})
    ix.flush()
    view = ix.pin()
    old = [c for c in ix.components if c.valid]
    assert len(old) == 2
    ix.merge(old)
    assert all(not c.retired for c in old)
    assert len(ix._deferred) == 2
    assert view.lookup(3) == {"pk": 3}
    assert sorted(k for k, _ in view.items()) == list(range(12))
    view.release()
    assert all(c.retired for c in old)
    assert not ix._deferred and not ix._comp_pins
    assert ix.pinned_versions() == ()


def test_unpin_is_idempotent_and_shared_pins_refcount():
    L = PORT.lsm
    ix = L.LSMIndex(flush_threshold=4,
                    merge_policy=L.TieredMergePolicy(k=99))
    for i in range(8):
        ix.insert(i, {"pk": i})
    v1 = ix.pin()
    v2 = ix.pin()
    old = [c for c in ix.components if c.valid]
    ix.merge(old)
    v1.release()
    v1.release()                                       # double release
    assert any(not c.retired for c in old)             # v2 still pins
    v2.release()
    assert all(c.retired for c in old)
    assert not ix._comp_pins and not ix._deferred


def test_pinned_view_isolated_from_later_writes_and_flush():
    ix = PORT.lsm.LSMIndex(flush_threshold=4)
    for i in range(3):
        ix.insert(i, {"pk": i})
    with ix.pin() as view:
        for i in range(3, 40):
            ix.insert(i, {"pk": i})                    # forces flushes
        ix.insert(0, {"pk": 0, "v": 2})                # overwrite
        assert sorted(k for k, _ in view.items()) == [0, 1, 2]
        assert view.lookup(0) == {"pk": 0}
    assert ix.lookup(0) == {"pk": 0, "v": 2}


def test_dataset_snapshot_is_stable_and_read_only():
    ds = _ds(PORT)
    ds.insert_batch([{"pk": i, "val": i} for i in range(100)])
    with ds.pin() as snap:
        before = sorted(r["pk"] for r in snap.scan())
        ds.insert_batch([{"pk": i, "val": i} for i in range(100, 150)])
        ds.delete(3)
        assert sorted(r["pk"] for r in snap.scan()) == before
        assert snap.lookup(3) == {"pk": 3, "val": 3}
        assert len(snap) == 100
        with pytest.raises(TypeError):
            snap.insert({"pk": 999, "val": 0})
        with pytest.raises(TypeError):
            snap.pin()
    assert ds.lookup(3) is None
    assert len(ds) == 149


def test_run_query_snapshot_flag_pins_and_releases():
    ds = _ds(PORT)
    ds.insert_batch([{"pk": i, "val": i % 7} for i in range(200)])
    plan = PORT.A.select(PORT.A.scan("S"), pred=lambda r: r["val"] == 3,
                         fields=["val"])
    rows, _ = PORT.run_query(plan, {"S": ds}, snapshot=True)
    assert sorted(r["pk"] for r in rows) == [i for i in range(200)
                                             if i % 7 == 3]
    assert all(p.primary.pinned_versions() == () for p in ds.partitions)


def test_threaded_ingest_query_stress_prefix_oracle():
    """Concurrent insert_batch (flush and merge churn) and snapshot scans:
    no raise, no lost acked row, no torn lane; every scan equals the
    pk-array of the same snapshot."""
    LANES, PER_LANE, BATCH = 3, 600, 30
    ds = _ds(PORT, parts=4, threshold=48)
    acked = [0] * LANES
    lock = threading.Lock()
    errors = []
    stop = threading.Event()

    def writer(lane):
        try:
            for off in range(0, PER_LANE, BATCH):
                ds.insert_batch([{"pk": (off + j) * LANES + lane,
                                  "val": off + j} for j in range(BATCH)])
                with lock:
                    acked[lane] += BATCH
        except Exception as e:             # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                with lock:
                    floors = list(acked)
                with ds.pin() as snap:
                    pks = np.concatenate(
                        [snap.partition_pk_array(i)
                         for i in range(ds.num_partitions)]) \
                        if len(snap) else np.empty(0, dtype=np.int64)
                    again = sorted(r["pk"] for r in snap.scan())
                pks = np.sort(pks.astype(np.int64))
                assert list(pks) == again
                for lane in range(LANES):
                    lp = pks[pks % LANES == lane]
                    k = lp.size
                    assert k == 0 or int(lp.max()) // LANES == k - 1, \
                        f"torn lane {lane}"
                    assert k >= floors[lane], f"lost acked rows: {lane}"
        except Exception as e:             # noqa: BLE001
            errors.append(e)

    writers = [threading.Thread(target=writer, args=(lane,))
               for lane in range(LANES)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in writers + readers:
        t.start()
    for t in writers:
        t.join(timeout=60)
    stop.set()
    for t in readers:
        t.join(timeout=60)
    assert not errors, errors[:3]
    assert len(ds) == LANES * PER_LANE
    assert all(p.primary.pinned_versions() == () for p in ds.partitions)


# ---------------------------------------------------------------------------
# tests/test_serve.py:194-352: the harness end to end, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["port", "reference"])
def test_serve_harness_mixed_workload_clean(REF, which):
    pkg = dict(pkgs(REF))[which]
    ds = _ds(pkg, parts=4, threshold=96)
    h = pkg.serve.ServeHarness(ds, n_ingest=2, n_query=2, pump_batch=32,
                               records_per_lane=200)
    rep = h.run(duration_s=3.0)
    assert rep.ingest_acked == 400
    assert rep.torn_reads == 0 and rep.lost_acks == 0
    assert rep.lost_acked_final == 0
    assert not rep.query_errors
    assert rep.queries > 0 and rep.query_p99_ms is not None
    assert rep.ingest_rate > 0
    assert len(ds) == 400 and _final_pks(ds) == set(range(400))


@pytest.mark.parametrize("which", ["port", "reference"])
def test_serve_harness_crash_recover_replays_at_least_once(REF, which):
    pkg = dict(pkgs(REF))[which]
    ds = _ds(pkg, parts=4, threshold=96)
    h = pkg.serve.ServeHarness(ds, n_ingest=2, n_query=2, pump_batch=32,
                               records_per_lane=200)
    rep = h.run(duration_s=3.0, checkpoint_after=100, crash_after=200)
    assert rep.recoveries == 1
    assert rep.torn_reads == 0 and rep.lost_acks == 0
    assert rep.lost_acked_final == 0
    assert not rep.query_errors
    assert len(ds) == 400
    assert _final_pks(ds) == set(range(400))


def test_bounded_sink_blocks_instead_of_dropping():
    q = queue.Queue(maxsize=1)
    sink = PORT.serve.BoundedSink(q)
    sink([1, 2])                            # fills the queue
    t = threading.Thread(target=lambda: sink([3, 4]))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()                     # blocked on the full queue
    assert q.get() == [1, 2]
    q.task_done()
    t.join(timeout=5)
    assert not t.is_alive()
    assert q.get() == [3, 4]                # delivered, not dropped


def test_dead_sink_fails_quiesce_instead_of_hanging():
    """A sink whose ``insert_batch`` raises dies with chunks queued; the
    reference's ``q.join()`` in ``_quiesce`` then waits forever.  The
    port's ``stop()`` raises instead."""
    ds = _ds(PORT, parts=2, threshold=96)
    died = []
    hook = threading.excepthook
    threading.excepthook = lambda a: died.append(a.thread.name)

    def broken(_chunk):
        raise OSError("storage unavailable")
    ds.insert_batch = broken
    h = PORT.serve.ServeHarness(ds, n_ingest=1, n_query=1, pump_batch=16,
                                queue_depth=2, records_per_lane=200)
    try:
        h.start()
        deadline = time.perf_counter() + 5
        while not died and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert died == ["sink-0"]
        with pytest.raises(RuntimeError, match="sink-0 died"):
            h.stop()
    finally:
        threading.excepthook = hook
        h._stop.set()
        h._gate.set()


def test_feed_cursor_advances_by_prefilter_intake_across_restore(REF):
    got = {}
    for name, pkg in pkgs(REF):
        S, F = pkg.serve, pkg.feeds

        def make():
            return S.StridedRecordAdaptor(0, 1, limit=100)
        keep = [lambda r: r if r["pk"] % 2 == 0 else None]
        seen = []
        feed = F.Feed("f", adaptor=make(), udfs=keep, store=seen.extend)
        delivered = feed.pump(10)
        assert delivered == 5 and feed.cursor == 10
        assert feed.last_intake == 10
        st = feed.state()
        seen2 = []
        feed2 = F.Feed("f", adaptor=make(), udfs=keep, store=seen2.extend)
        feed2.restore(st)
        feed2.pump(10)
        replayed = [r["pk"] for r in seen2]
        assert not set(replayed) & {r["pk"] for r in seen}
        assert replayed == [10, 12, 14, 16, 18]
        got[name] = (seen, seen2, st, feed2.state())
    assert got["port"] == got["reference"]


def test_secondary_feed_checkpoints_own_source_position(REF):
    got = {}
    for name, pkg in pkgs(REF):
        F = pkg.feeds
        primary = F.Feed("p", adaptor=F.SyntheticTokenAdaptor(8, 100))
        seen = []
        sec = F.Feed("s", source_joint=primary.joint, store=seen.extend)
        primary.pump(40)
        sec.pump(15)
        st = sec.state()
        assert st["source_cursor"] == 15
        sec.pump(10)
        assert primary.joint.subscribers["s"] == 25
        sec.restore(st)
        assert primary.joint.subscribers["s"] == 15
        sec.pump(10)
        ids = [r["doc_id"] for r in seen]
        assert ids[15:25] == ids[25:35]
        got[name] = (ids, st, sec.state())
    assert got["port"] == got["reference"]


def test_joint_overflow_raise_policy_and_drop_counter(REF):
    got = {}
    for name, pkg in pkgs(REF):
        F, obs = pkg.feeds, pkg.obs
        c0 = obs.snapshot().get("feed.joint.ovf2.dropped", 0)
        j = F.FeedJoint(window=8, name="ovf", overflow="raise")
        j.subscribe("slow")
        j.publish(list(range(8)))
        base, buf = j.base, list(j.buffer)
        with pytest.raises(F.FeedOverflow) as e:
            j.publish([8, 9])
        assert j.base == base and list(j.buffer) == buf
        out = [j.consume("slow", 4)]
        j.publish([8, 9])
        out.append(j.consume("slow", 6))
        assert out == [[0, 1, 2, 3], [4, 5, 6, 7, 8, 9]] and j.dropped == 0
        d = F.FeedJoint(window=4, name="ovf2", overflow="drop")
        d.subscribe("slow")
        d.publish(list(range(6)))
        assert d.dropped == 2
        with pytest.raises(RuntimeError):
            d.consume("slow", 1)
        ok = F.FeedJoint(window=4, name="ovf3")
        ok.subscribe("fast")
        ok.publish([1, 2])
        ok.consume("fast", 2)
        ok.publish([3, 4, 5, 6])
        assert ok.dropped == 0
        got[name] = (str(e.value), out, d.base, list(d.buffer),
                     obs.snapshot()["feed.joint.ovf2.dropped"] - c0)
    assert got["port"] == got["reference"]
    assert got["port"][-1] == 2


def test_dataset_sink_single_pass_drain(REF):
    got = {}
    for name, pkg in pkgs(REF):
        class Rec:
            def __init__(self):
                self.batches = []
                self.name = "d"

            def insert_batch(self, chunk):
                self.batches.append(list(chunk))

        rec = Rec()
        sink = pkg.feeds.DatasetSink(rec, batch_size=3)
        sink([{"pk": i} for i in range(7)])
        assert [len(b) for b in rec.batches] == [3, 3]
        assert [r["pk"] for r in sink.backlog] == [6]
        sink([{"pk": i} for i in range(7, 9)])
        assert [len(b) for b in rec.batches] == [3, 3, 3]
        assert sink.backlog == [] and sink.flush() == 0
        sink([{"pk": 99}])
        assert sink.flush() == 1
        assert sink.stats["records"] == 10
        got[name] = (rec.batches, dict(sink.stats))
    assert got["port"] == got["reference"]


# ---------------------------------------------------------------------------
# a lockstep checkpoint, crash and replay through Feed + DatasetSink, then
# chip_smoke.py's feeds-phase queries, both packages
# ---------------------------------------------------------------------------

N_LOCKSTEP = 1000


def _lockstep_ingest(pkg):
    """chip_smoke.py's feeds dataset (an index on val, tiered k = 4) at a
    threshold of 64, fed by one lane through a DatasetSink."""
    ds = _ds(pkg, threshold=64, name="Feeds", k=4)
    ds.create_index("val")
    F = pkg.feeds
    sink = F.DatasetSink(ds, batch_size=50)
    feed = F.Feed("Feeds-lockstep", store=sink,
                  adaptor=pkg.serve.StridedRecordAdaptor(
                      0, 1, limit=N_LOCKSTEP))
    trace = [feed.pump(300)]
    sink.flush()                           # the checkpoint is durable
    st = feed.state()
    trace.append(feed.pump(330))
    ds.crash_and_recover()
    sink.backlog = []                      # in flight at the crash: lost
    feed.restore(st)
    while feed.pump(128):
        trace.append(feed.last_intake)
    sink.flush()
    return ds, trace, st, feed.state(), dict(sink.stats)


@pytest.fixture(scope="module")
def lockstep(REF):
    return {name: _lockstep_ingest(pkg) for name, pkg in pkgs(REF)}


def test_lockstep_feed_ingest_crash_replay(lockstep):
    port, ref = lockstep["port"], lockstep["reference"]
    assert port[1:] == ref[1:]
    for ds, *_ in (port, ref):
        assert len(ds) == N_LOCKSTEP
        assert _final_pks(ds) == set(range(N_LOCKSTEP))
    assert canon(port[0].scan()) == canon(ref[0].scan())


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("query", ["feed_index_range",
                                   "feed_range_aggregate",
                                   "feed_skip_select"])
def test_lockstep_feed_queries_equal_reference(REF, lockstep, cache, query):
    """The feeds phase's queries over the replayed datasets: rows by exact
    repr, fallback reasons and vectorized row counts equal, with the plan
    cache on and off in both packages."""
    out = {}
    for name, pkg in pkgs(REF):
        ds = lockstep[name][0]
        pkg.PC.set_enabled(cache)
        try:
            plan = feed_plans(pkg.A, pk_lo=200)[query]
            rows, ex = pkg.run_query(plan, {"Feeds": ds}, vectorize=True)
        finally:
            pkg.PC.set_enabled(True)
        st = ex.stats
        out[name] = (canon(rows), dict(st.fallback_reasons),
                     st.rows_fallback, st.rows_vectorized)
    assert out["port"] == out["reference"]
    assert out["port"][0]


# ---------------------------------------------------------------------------
# tests/test_obs_export.py's harness cases, on the port's obs.export
# ---------------------------------------------------------------------------

def _obs_dataset(name, rows=0, num_partitions=2):
    adm = PORT.adm
    rt = adm.RecordType(f"T_{name}", (adm.Field("pk", adm.INT64),
                                      adm.Field("val", adm.INT64),
                                      adm.Field("text", adm.STRING)),
                        open=True)
    ds = PORT.dsm.PartitionedDataset(name, rt, "pk",
                                     num_partitions=num_partitions,
                                     flush_threshold=256)
    for pk in range(rows):
        ds.insert({"pk": pk, "val": pk % 97, "text": f"r{pk}"})
    return ds


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def test_exporter_serves_during_live_harness_run():
    """A /metrics scrape taken while the harness runs returns valid
    Prometheus text carrying the serve counters."""
    ds = _obs_dataset("exp_live")
    h = PORT.serve.ServeHarness(ds, n_ingest=2, n_query=2, pump_batch=32,
                                records_per_lane=3000, deadline_s=30.0)
    server = PORT.export.serve_http(port=0, sample_interval_s=0.05,
                                    trace_source=h.tracker.profile_spans)
    try:
        h.start()
        try:
            time.sleep(0.25)               # scrape mid-run, not after
            status, ctype, body = _get(server.url + "/metrics")
        finally:
            h.stop()
        assert status == 200 and ctype.startswith("text/plain")
        assert "# TYPE serve_ingest_acked counter" in body
        assert "# TYPE serve_queue_wait_s summary" in body
        assert 'serve_queue_wait_s{quantile="0.99"}' in body
        rep = h.report()
        assert rep.torn_reads == 0 and rep.lost_acks == 0
    finally:
        server.stop()


def test_admission_rejects_by_deadline_on_fixed_schedule():
    ac = PORT.serve.AdmissionController(max_inflight=1, timeout=0.5,
                                        deadline_s=0.05)
    waits_before = ac._queue_wait.count
    with ac.admit() as g1:
        assert g1 and not g1.rejected_deadline
        t0 = time.perf_counter()
        with ac.admit() as g2:
            waited = time.perf_counter() - t0
            assert not g2 and g2.rejected_deadline
            assert 0.04 <= g2.queue_wait_s <= 0.4
            assert waited < 0.45
    assert ac.admitted == 1
    assert ac.rejected == 1 and ac.rejected_deadline == 1
    assert ac._queue_wait.count - waits_before == 2


def test_admission_slot_rejection_not_counted_as_deadline():
    ac = PORT.serve.AdmissionController(max_inflight=1, timeout=0.02,
                                        deadline_s=None)
    with ac.admit():
        with ac.admit() as g2:
            assert not g2 and not g2.rejected_deadline
    assert ac.rejected == 1 and ac.rejected_deadline == 0


def test_tracker_settles_attained_missed_rejected():
    S = PORT.serve
    tr = S.RequestTracker(deadline_s=0.05, profile_every=0)
    ac = S.AdmissionController(max_inflight=1, timeout=0.5, deadline_s=0.05)
    fast = tr.begin("query")
    with ac.admit() as g:
        assert g
        with fast.phase("execute"):
            pass
        tr.settle(fast)
    assert fast.attained is True and fast.outcome == "ok"
    slow = tr.begin("query")
    with ac.admit() as g:
        with slow.phase("execute"):
            time.sleep(0.08)
        tr.settle(slow)
    assert slow.attained is False and slow.outcome == "ok"
    shed = tr.begin("query")
    with ac.admit():
        with ac.admit() as g:
            assert not g
            tr.settle(shed, g)
    assert shed.outcome == "rejected_deadline" and shed.attained is None
    assert shed.queue_wait_s == g.queue_wait_s
    assert (tr.attained, tr.missed, tr.rejected_deadline) == (1, 1, 1)
    assert tr.completed == 2 and tr.offered() == 3
    assert tr.phase_hist["execute"].count == 2


def test_harness_sheds_by_deadline_without_losing_correctness():
    """A saturating schedule (one slot, four workers, a deadline far below
    a query's time) sheds by deadline while the consistency ledger stays
    clean, and the report carries queue-wait and per-phase p99s."""
    ds = _obs_dataset("exp_sat", rows=4000)
    h = PORT.serve.ServeHarness(ds, n_ingest=2, n_query=4, pump_batch=64,
                                records_per_lane=1500, max_inflight=1,
                                deadline_s=0.004, admission_timeout=0.25,
                                profile_every=4)
    rep = h.run(duration_s=3.0)
    d = rep.as_dict()
    assert d["slo"]["rejected_deadline"] > 0
    assert d["slo"]["rejected_deadline"] == h.admission.rejected_deadline
    assert d["torn_reads"] == 0 and d["lost_acks"] == 0
    assert d["lost_acked_final"] == 0
    assert not d["query_errors"]
    assert d["queue_wait_p99_ms"] is not None
    assert d["phase_p99_ms"]["execute"] is not None
    assert d["slowest_phase_p99"] in ("queue_wait", "pin", "execute",
                                      "result")
    assert d["rejection_rate"] > 0
    offered = h.tracker.offered()
    assert offered == h.tracker.completed + h.admission.rejected
    assert h.admission.rejected == (h.tracker.rejected_slots
                                    + h.tracker.rejected_deadline)


def test_profile_ring_is_bounded_and_carries_span_trees():
    ds = _obs_dataset("exp_prof", rows=64)
    PORT.obs.clear()
    h = PORT.serve.ServeHarness(ds, n_ingest=1, n_query=2, pump_batch=32,
                                records_per_lane=200, deadline_s=30.0,
                                profile_every=1, profile_ring=4)
    h.run(duration_s=1.0)
    profiles = list(h.tracker.profiles)
    assert 0 < len(profiles) <= 4
    spans = h.tracker.profile_spans()
    names = {sp.name for sp in spans}
    assert "serve.request" in names
    assert any(n.startswith("serve.phase.") for n in names)
    for sp in spans:
        if sp.name == "serve.request":
            assert sp.t1 is not None
            assert sp.attrs["outcome"] in ("ok", "error", "rejected",
                                           "rejected_deadline")
    assert PORT.obs.events() == []          # global tracing stayed off


# ---------------------------------------------------------------------------
# the port's feed / serve metric-name registry
# ---------------------------------------------------------------------------

DOC = pathlib.Path(__file__).resolve().parents[1] / "docs" / "METRICS.md"


def _canon_name(name):
    for pat, form in (
            (r"feed\.joint\.[^.]+\.lag\..+", "feed.joint.<joint>.lag.<sub>"),
            (r"feed\.joint\.[^.]+\.(published|dropped)",
             "feed.joint.<joint>.{}"),
            (r"feed\.sink\.[^.]+\.(records|batch_records|backlog)",
             "feed.sink.<dataset>.{}"),
            (r"feed\.[^.]+\.(records|batch_records)", "feed.<feed>.{}")):
        m = re.fullmatch(pat, name)
        if m:
            return form.format(*m.groups())
    return name


def test_feed_serve_metric_registry():
    """A harness run with a deadline, profiling, a checkpoint and a crash,
    plus a secondary feed and a dataset sink, emits only ``feed.*`` and
    ``serve.*`` names the port's registry lists, with the kinds it
    lists; every listed name is emitted and documented in
    docs/METRICS.md."""
    obs, F = PORT.obs, PORT.feeds
    ds = _ds(PORT, parts=2, threshold=64)
    h = PORT.serve.ServeHarness(ds, n_ingest=2, n_query=2, pump_batch=32,
                                records_per_lane=150, max_inflight=1,
                                deadline_s=0.002, profile_every=2)
    h.run(duration_s=3.0, checkpoint_after=100, crash_after=200)
    primary = F.Feed("mreg", adaptor=F.SyntheticTokenAdaptor(4, 10),
                     joint=F.FeedJoint(window=4, name="mregj"))
    sec = F.Feed("mregs", source_joint=primary.joint,
                 store=F.DatasetSink(ds, batch_size=4))
    primary.pump(3)
    sec.pump(3)
    primary.pump(8)                         # evicts unconsumed records
    seen = {}
    for name, (kind, _v) in obs.typed_snapshot().items():
        if name.startswith(("feed.", "serve.")):
            seen.setdefault(_canon_name(name), set()).add(kind)
    reg = obs.FEED_SERVE_METRICS
    assert {k: {v} for k, v in reg.items() if k in seen} == seen
    assert set(reg) == set(seen)
    doc = DOC.read_text()
    assert all(f"`{name}`" in doc for name in reg)
