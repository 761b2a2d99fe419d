"""The slice test of the PyTorch port: the TinySocial columnar query path
(rung 2) through ``repro_torch.storage.query.run_query(..., vectorize=
True)`` against the reference's ``repro.storage.query.run_query`` on the
same seeded data, with the fused plan cache disabled in both packages:
the per-operator path of every chain (rung 3, the fused chain, has its
own tests in ``tests/test_torch_plancache.py``).

Rows must agree exactly under the differential harness's canonical form
(exact ``repr``, float64 aggregate values included: the port sums in the
reference's order), and so must the engines' accounting: ``rows_fallback``,
``fallback_reasons``, ``rows_vectorized`` and ``rows_index_vectorized``.
Seeded lifecycle schedules (insert, insert_batch, delete, flush, merge,
crash_and_recover) replay the same operations in both packages.  The
reference is imported under a test-side ``jax.experimental.enable_x64``
shim that is removed again when this module's tests end.
"""

import contextlib
import datetime as dt
import random
import sys
import types

import pytest

jax = pytest.importorskip("jax")

import repro_torch  # noqa: E402
from repro_torch import obs as P_obs  # noqa: E402
from repro_torch.columnar import plancache as P_pc  # noqa: E402
from repro_torch.configs import tinysocial as P_ts  # noqa: E402
from repro_torch.core import adm as P_adm  # noqa: E402
from repro_torch.core import algebra as P_A  # noqa: E402
from repro_torch.core import functions as P_fn  # noqa: E402
from repro_torch.core import lsm as P_lsm  # noqa: E402
from repro_torch.storage import dataset as P_dsm  # noqa: E402
from repro_torch.storage import query as P_q  # noqa: E402
from repro_torch.storage.carry import dataset_from_reference  # noqa: E402

from _torch_doubles import (DOUBLE_SIZES, double_dataset,  # noqa: E402
                            double_plans)
from _torch_ref import canon, wide_dataset, wide_plans  # noqa: E402

PORT = types.SimpleNamespace(A=P_A, adm=P_adm, fn=P_fn, lsm=P_lsm,
                             dsm=P_dsm, run_query=P_q.run_query, ts=P_ts)


@contextlib.contextmanager
def _reference_x64():
    """Import the reference with ``jax.experimental.enable_x64`` restored
    as a wrapper of ``jax.enable_x64(True)``; on exit drop the reference
    modules imported meanwhile and the shim itself."""
    import jax.experimental as jexp
    had = hasattr(jexp, "enable_x64")
    before = set(sys.modules)
    if not had:
        @contextlib.contextmanager
        def enable_x64():
            with jax.enable_x64(True):
                yield
        jexp.enable_x64 = enable_x64
    try:
        yield
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == "repro" or name.startswith("repro."):
                mod = sys.modules.pop(name)
                parent, _, child = name.rpartition(".")
                if getattr(sys.modules.get(parent), child, None) is mod:
                    delattr(sys.modules[parent], child)
        if not had:
            del jexp.enable_x64


@pytest.fixture(scope="module")
def REF():
    with _reference_x64():
        from repro.columnar import plancache
        from repro.configs import tinysocial
        from repro.core import adm, algebra, functions, lsm
        from repro.storage import dataset, query
        plancache.set_enabled(False)
        try:
            yield types.SimpleNamespace(
                A=algebra, adm=adm, fn=functions, lsm=lsm, dsm=dataset,
                run_query=query.run_query, ts=tinysocial)
        finally:
            plancache.set_enabled(True)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")
    P_pc.set_enabled(False)        # the per-operator path, as in REF
    yield
    P_pc.set_enabled(True)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def _canon(rows):
    """``test_differential._canon``: each row's items sorted by key, by
    exact ``repr``, the rows sorted."""
    return sorted(repr(sorted(r.items(), key=lambda kv: kv[0]))
                  for r in rows)


def _assert_rows_agree(got, ref):
    cg, cr = _canon(got), _canon(ref)
    assert len(cg) == len(cr), (len(cg), len(cr))
    for g, r in zip(cg, cr):
        assert g == r, (g, r)


STAT_KEYS = ("rows_fallback", "fallback_reasons", "rows_vectorized",
             "rows_index_vectorized")


def _agree(port_ds, ref_ds, port_plan, ref_plan, ref):
    rows_p, ex_p = PORT.run_query(port_plan, port_ds, vectorize=True)
    rows_r, ex_r = ref.run_query(ref_plan, ref_ds, vectorize=True)
    _assert_rows_agree(rows_p, rows_r)
    for key in STAT_KEYS:
        assert getattr(ex_p.stats, key) == getattr(ex_r.stats, key), key
    return ex_p


# ---------------------------------------------------------------------------
# TinySocial: the table-3 plan classes
# ---------------------------------------------------------------------------

LO, HI = dt.datetime(2010, 1, 1), dt.datetime(2010, 2, 1)
MLO = dt.datetime(2014, 2, 1)


def table3_plans(A):
    """The table-3 plan classes (benchmarks/table3_queries.py) built with
    one package's algebra."""
    sel_sm = A.select(A.scan("MugshotMessages"),
                      pred=lambda r: r["timestamp"] <= dt.datetime(2014, 1, 4),
                      fields=["timestamp"],
                      ranges={"timestamp": (dt.datetime(2014, 1, 1),
                                            dt.datetime(2014, 1, 4))})
    ts_range = {"timestamp": (MLO, dt.datetime(2015, 1, 1))}
    return {
        "index_range_scan": A.select(
            A.scan("MugshotUsers"),
            pred=lambda r: LO <= r["user-since"] <= HI,
            fields=["user-since"], ranges={"user-since": (LO, HI)}),
        "exact_range_aggregate": A.aggregate(
            A.select(A.scan("MugshotMessages"),
                     pred=lambda r: r["timestamp"] >= MLO,
                     fields=["timestamp"], ranges=ts_range,
                     ranges_exact=True, hints=["skip-index"]),
            {"cnt": ("count", "*"), "avg_author": ("avg", "author-id")}),
        "skip_index_select": A.select(
            A.scan("MugshotMessages"),
            pred=lambda r: MLO <= r["timestamp"] <= dt.datetime(2014, 2, 20),
            fields=["timestamp"],
            ranges={"timestamp": (MLO, dt.datetime(2014, 2, 20))},
            hints=["skip-index"]),
        "index_chain_aggregate": A.aggregate(
            A.select(A.scan("MugshotMessages"),
                     pred=lambda r: r["timestamp"] >= MLO,
                     fields=["timestamp"], ranges=ts_range),
            {"cnt": ("count", "*"), "avg_author": ("avg", "author-id")}),
        "grouped_topk": A.limit(A.order_by(
            A.group_by(A.scan("MugshotMessages"), ["author-id"],
                       {"cnt": ("count", "*")}), ["cnt"], desc=True), 10),
        "select_join": A.join(sel_sm, A.scan("MugshotUsers"),
                              ["author-id"], ["id"]),
    }


# classes whose per-operator plan aggregates the gathered index survivors:
# those columns are new per query and ship until the fused chain (rung 3)
GATHERED = {"index_chain_aggregate"}


@pytest.fixture(scope="module")
def tinysocial(REF):
    _, port = PORT.ts.build_dataverse(300, 3000, num_partitions=4,
                                      flush_threshold=128)
    _, ref = REF.ts.build_dataverse(300, 3000, num_partitions=4,
                                    flush_threshold=128)
    return port, ref


@pytest.mark.parametrize("name", list(table3_plans(P_A)))
def test_table3_plan_agrees_with_reference(REF, tinysocial, name):
    port, ref = tinysocial
    pp, rp = table3_plans(PORT.A)[name], table3_plans(REF.A)[name]
    ex = _agree(port, ref, pp, rp, REF)
    assert ex.stats.rows_vectorized > 0
    # warm repeat: nothing re-ships and nothing is seen for the first time
    k0 = P_obs.snapshot()
    _, ex2 = PORT.run_query(pp, port, vectorize=True)
    assert ex2.stats.kernel_retraces == 0
    if name in GATHERED:
        k1 = P_obs.snapshot()
        agg_h2d = (k1.get("kernel.fused_filter_aggregate.h2d_bytes", 0)
                   - k0.get("kernel.fused_filter_aggregate.h2d_bytes", 0))
        assert ex2.stats.h2d_bytes == agg_h2d
    else:
        assert ex2.stats.h2d_bytes == 0


def test_index_paths_launch_every_kernel_class(tinysocial):
    """The slice's plans reach K1, K2 and K4 (K3 runs in every merge)."""
    port, _ = tinysocial
    before = {k: P_obs.snapshot().get(f"kernel.{k}.dispatches", 0)
              for k in ("range_mask", "fused_filter_aggregate",
                        "t_occurrence_mask", "sorted_intersect_mask")}
    for plan in table3_plans(PORT.A).values():
        PORT.run_query(plan, port, vectorize=True)
    _, fresh = PORT.ts.build_dataverse(40, 600, num_partitions=2,
                                       flush_threshold=16)
    after = P_obs.snapshot()
    for k, v in before.items():
        assert after.get(f"kernel.{k}.dispatches", 0) > v, k


# ---------------------------------------------------------------------------
# 9 and 17 predicate columns: K2 takes any number, as the reference does
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_datasets(REF):
    return {"W": wide_dataset(PORT)}, {"W": wide_dataset(REF)}


@pytest.mark.parametrize("plan", ["scan", "skip_index", "index_chain"])
@pytest.mark.parametrize("k", [9, 17])
def test_wide_range_aggregates_agree_with_reference(REF, wide_datasets, k,
                                                    plan):
    """Aggregates over exact selects that hand K2 (scan, skip-index) or
    the index path's validate step ``k`` predicate columns: rows by exact
    repr and the engines' accounting equal the reference's, every row
    vectorized, K2 dispatched."""
    port, ref = wide_datasets
    key = "kernel.fused_filter_aggregate.dispatches"
    k0 = P_obs.snapshot().get(key, 0)
    rows_p, ex_p = PORT.run_query(wide_plans(PORT.A, k)[plan], port,
                                  vectorize=True)
    rows_r, ex_r = REF.run_query(wide_plans(REF.A, k)[plan], ref,
                                 vectorize=True)
    assert canon(rows_p) == canon(rows_r)
    for stat in STAT_KEYS:
        assert getattr(ex_p.stats, stat) == getattr(ex_r.stats, stat), stat
    assert ex_p.stats.rows_fallback == 0 and rows_p[0]["c"] > 0
    assert P_obs.snapshot().get(key, 0) > k0


@pytest.mark.parametrize("k", [9, 17])
def test_wide_range_index_chain_small_partitions(REF, k):
    """The wide index-chain aggregate over 160 records (the tests above
    use 600): the per-operator path's K2 sums gathered batches of 17-31
    survivors, which the reference pads to 32 and sums in its 32-slot
    order under all ``k`` predicate columns (U = 1 at 9, 4 at 17), though
    the port folds those past 8 into one slot."""
    port, ref = wide_dataset(PORT, n=160), wide_dataset(REF, n=160)
    rows_p, _ = PORT.run_query(wide_plans(PORT.A, k)["index_chain"],
                               {"W": port}, vectorize=True)
    rows_r, _ = REF.run_query(wide_plans(REF.A, k)["index_chain"],
                              {"W": ref}, vectorize=True)
    assert canon(rows_p) == canon(rows_r)


# ---------------------------------------------------------------------------
# lifecycle schedules, replayed in both packages
# ---------------------------------------------------------------------------

VOCAB = ["tpu", "jax", "lsm", "tonight", "tonite", "coffee", "fuzzy",
         "mesh", "verona"]


def _record_type(adm):
    return adm.RecordType("DiffT", (
        adm.Field("id", adm.INT64),
        adm.Field("g", adm.INT64),
        adm.Field("a", adm.INT64, optional=True),
        adm.Field("b", adm.INT64, optional=True),
        adm.Field("txt", adm.STRING, optional=True),
        adm.Field("loc", adm.POINT, optional=True),
    ), open=True)


def _plan(pkg, rng, kind):
    A = pkg.A
    lo = rng.randrange(-60, 50)
    hi = lo + rng.randrange(0, 60)
    lo_ = None if rng.random() < 0.15 else lo
    hints = ["skip-index"] if rng.random() < 0.25 else []
    sel = A.select(A.scan("D"),
                   pred=lambda r: "a" in r and (lo_ is None or r["a"] >= lo_)
                   and r["a"] <= hi,
                   fields=["a"], ranges={"a": (lo_, hi)},
                   ranges_exact=rng.random() < 0.5, hints=hints)
    if kind == "btree":
        return sel
    if kind == "agg":
        return A.aggregate(sel, {"c": ("count", "*"), "s": ("sum", "a"),
                                 "mn": ("min", "b"), "av": ("avg", "b")})
    if kind == "group":
        return A.group_by(sel, ["g"], {"c": ("count", "*"),
                                       "mx": ("max", "a")})
    if kind == "topk":
        return A.limit(A.order_by(sel, ["id"], desc=rng.random() < 0.5),
                       rng.randrange(1, 9))
    if kind == "spatial":
        center = (rng.uniform(0.0, 1.0), rng.uniform(0.0, 1.0))
        radius = rng.uniform(0.05, 0.4)
        dist = pkg.fn.spatial_distance
        return A.select(A.scan("D"),
                        pred=lambda r: "loc" in r
                        and dist(r["loc"], center) <= radius,
                        fields=["loc"], spatial=("loc", center, radius))
    token = rng.choice(VOCAB)
    tokens = pkg.fn.word_tokens
    return A.select(A.scan("D"),
                    pred=lambda r: "txt" in r and token in tokens(r["txt"]),
                    fields=["txt"], keyword=("txt", token, 0))


def _replay(pkg, seed):
    """One seeded lifecycle schedule; returns the dataset and the plans
    queried at each checkpoint (the dataset's state is identical in both
    packages because the rng draws are)."""
    rng = random.Random(seed)
    parts = rng.choice([2, 3, 4])
    threshold = rng.choice([6, 13, 31])
    ds = pkg.dsm.PartitionedDataset(
        "D", _record_type(pkg.adm), "id", num_partitions=parts,
        flush_threshold=threshold,
        merge_policy=pkg.lsm.TieredMergePolicy(k=rng.choice([2, 3])))
    ds.create_index("a")
    ds.create_index("txt", kind="keyword")
    ds.create_index("loc", kind="rtree")

    def mk_row():
        r = {"id": rng.randrange(120), "g": rng.randrange(4)}
        if rng.random() < 0.8:
            r["a"] = rng.randrange(-50, 50)
        if rng.random() < 0.5:
            r["b"] = rng.randrange(0, 30)
        if rng.random() < 0.6:
            r["txt"] = " ".join(rng.choice(VOCAB) for _ in range(2))
        if rng.random() < 0.5:
            r["loc"] = (rng.uniform(0.0, 1.0), rng.uniform(0.0, 1.0))
        if rng.random() < 0.4:
            r["x"] = rng.choice([rng.randrange(100), rng.uniform(0.0, 9.0),
                                 rng.choice(VOCAB)])
        return r

    checkpoints = []
    for _ in range(rng.randrange(5, 10)):
        op = rng.choice(["insert", "insert", "batch", "delete", "flush",
                         "merge", "recover", "query", "query"])
        if op == "insert":
            for _ in range(rng.randrange(1, threshold + 3)):
                ds.insert(mk_row())
        elif op == "batch":
            ds.insert_batch(
                [mk_row() for _ in range(rng.randrange(1, 2 * threshold))])
        elif op == "delete":
            for _ in range(rng.randrange(1, 6)):
                ds.delete(rng.randrange(120))
        elif op == "flush":
            for part in ds.partitions:
                part.primary.flush()
        elif op == "merge":
            part = ds.partitions[rng.randrange(parts)]
            valid = [c for c in part.primary.components if c.valid]
            if len(valid) >= 2:
                k = rng.randrange(2, len(valid) + 1)
                start = rng.randrange(0, len(valid) - k + 1)
                part.primary.merge(valid[start:start + k])
        elif op == "recover":
            ds = ds.crash_and_recover()
        else:
            kind = rng.choice(["btree", "agg", "group", "topk", "spatial",
                               "keyword"])
            checkpoints.append(pkg.run_query(_plan(pkg, rng, kind),
                                             {"D": ds}, vectorize=True))
    for kind in ("agg", "spatial", "keyword"):
        checkpoints.append(pkg.run_query(_plan(pkg, rng, kind), {"D": ds},
                                         vectorize=True))
    return ds, checkpoints


@pytest.mark.parametrize("seed", range(20))
def test_lifecycle_schedule_agrees_with_reference(REF, seed):
    port_ds, port_res = _replay(PORT, 1000 + seed)
    ref_ds, ref_res = _replay(REF, 1000 + seed)
    assert len(port_res) == len(ref_res)
    for (rows_p, ex_p), (rows_r, ex_r) in zip(port_res, ref_res):
        _assert_rows_agree(rows_p, rows_r)
        for key in STAT_KEYS:
            assert getattr(ex_p.stats, key) == getattr(ex_r.stats, key), key
    _assert_rows_agree(port_ds.scan(), ref_ds.scan())


# ---------------------------------------------------------------------------
# carrying a reference dataset's state into the port
# ---------------------------------------------------------------------------

def test_dataset_from_reference(REF, tinysocial):
    _, ref = tinysocial
    for name in ("MugshotUsers", "MugshotMessages"):
        carried = dataset_from_reference(ref[name])
        assert carried.num_partitions == ref[name].num_partitions
        assert carried.index_fields == ref[name].index_fields
        _assert_rows_agree(carried.scan(), ref[name].scan())
    port = {n: dataset_from_reference(d) for n, d in ref.items()}
    for name in ("index_range_scan", "index_chain_aggregate"):
        rows_p, _ = PORT.run_query(table3_plans(PORT.A)[name], port,
                                   vectorize=True)
        rows_r, _ = REF.run_query(table3_plans(REF.A)[name], ref,
                                  vectorize=True)
        _assert_rows_agree(rows_p, rows_r)


# ---------------------------------------------------------------------------
# float64 aggregates: the reference's exact bits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def double_datasets(REF):
    return {n: (double_dataset(PORT, n, parts), double_dataset(REF, n, parts))
            for n, parts in DOUBLE_SIZES}


@pytest.mark.parametrize("n", [n for n, _ in DOUBLE_SIZES])
@pytest.mark.parametrize("plan", list(double_plans(P_A)))
def test_double_aggregates_equal_reference_bits(REF, double_datasets, n,
                                                plan):
    """The port's float64 sum folds in the reference's (XLA's) order, so
    sum, avg, min and max equal the reference's by exact repr, not within
    a tolerance."""
    port, ref = double_datasets[n]
    rows_p, ex_p = PORT.run_query(double_plans(PORT.A)[plan], port,
                                  vectorize=True)
    rows_r, _ = REF.run_query(double_plans(REF.A)[plan], ref, vectorize=True)
    assert ex_p.stats.rows_vectorized > 0 and ex_p.stats.rows_fallback == 0
    assert repr(rows_p) == repr(rows_r)


def test_tree_sum_is_the_window_order():
    """``tree_sum`` against a scalar transcription of the window order,
    and independent of the pow2 length the values are padded to."""
    import numpy as np
    import torch
    from repro_torch.kernels.columnar_ops import tree_sum

    def scalar(xs):
        while True:
            xs = xs + [0.0] * (-len(xs) % 32)
            sums = []
            for w in range(0, len(xs), 32):
                s = 0.0
                for v in xs[w:w + 32]:
                    s += v
                sums.append(s)
            if len(sums) == 1:
                return sums[0]
            xs = sums
    rng = np.random.default_rng(7)
    for n in (1, 31, 33, 1000, 1025, 40000):
        x = rng.standard_normal(n) * 1e3
        want = scalar(x.tolist())
        assert float(tree_sum(torch.from_numpy(x))) == want
        padded = np.zeros(1 << (n - 1).bit_length() + 3)
        padded[:n] = x
        assert float(tree_sum(torch.from_numpy(padded))) == want
