"""Shared by the port's rung-3 and rung-4 tests: the reference imported
under a test-side ``jax.experimental.enable_x64`` shim (jax 0.9 dropped
it), a dataset built the same way in both packages, and the rows'
canonical form."""

import contextlib
import sys
import types


@contextlib.contextmanager
def reference_x64():
    """Import the reference with ``jax.experimental.enable_x64`` restored
    as a wrapper of ``jax.enable_x64(True)``; on exit drop the reference
    modules imported meanwhile and the shim itself, so the reference's own
    test files see the interpreter unchanged."""
    import jax
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


def reference_namespace():
    """The reference's modules the rung-3 and rung-4 tests drive (call
    inside :func:`reference_x64`)."""
    from repro.columnar import plancache
    from repro.core import adm, algebra, lsm
    from repro.storage import dataset, query
    return types.SimpleNamespace(PC=plancache, adm=adm, A=algebra, lsm=lsm,
                                 dsm=dataset, run_query=query.run_query)


def port_namespace():
    from repro_torch import obs
    from repro_torch.columnar import operators, plancache
    from repro_torch.columnar.batch import Column, ColumnBatch, build_column
    from repro_torch.core import adm, algebra, lsm
    from repro_torch.kernels import device_pool
    from repro_torch.runtime import spmd
    from repro_torch.storage import dataset, query
    return types.SimpleNamespace(
        obs=obs, O=operators, PC=plancache, Column=Column,
        ColumnBatch=ColumnBatch, build_column=build_column, adm=adm,
        A=algebra, lsm=lsm, DP=device_pool, SP=spmd, dsm=dataset,
        run_query=query.run_query)


def rec_type(adm, name="ChainT"):
    return adm.RecordType(name, (
        adm.Field("id", adm.INT64),
        adm.Field("a", adm.INT64),
        adm.Field("b", adm.INT64),
        adm.Field("x", adm.DOUBLE),
        adm.Field("t", adm.DATETIME),
    ), open=True)


def dataset(pkg, n=120, parts=2, *, index_b=False, threshold=32, seed=0,
            index_x=False, halves=False):
    """``n`` seeded records (ints, a DOUBLE, a DATETIME, an open field that
    is a string or an int) in ``parts`` partitions, flushed every
    ``threshold`` inserts, never merged, with a B+-tree index on ``a``
    (and on ``b`` / ``x`` when asked).  ``halves``: the DOUBLE is i / 2,
    whose sums are exact in any order."""
    import datetime as dt
    import numpy as np
    rng = np.random.default_rng(seed)
    ds = pkg.dsm.PartitionedDataset(
        "D", rec_type(pkg.adm), "id", num_partitions=parts,
        flush_threshold=threshold,
        merge_policy=pkg.lsm.TieredMergePolicy(k=99))
    ds.create_index("a")
    if index_b:
        ds.create_index("b")
    if index_x:
        ds.create_index("x")
    base = dt.datetime(2014, 1, 1)
    a = rng.integers(0, 50, n)
    b = rng.integers(0, 40, n)
    x = np.arange(n) * 0.5 if halves else rng.standard_normal(n) * 1e3
    secs = rng.integers(0, 86_400 * 60, n)
    for i in range(n):
        ds.insert({"id": i, "a": int(a[i]), "b": int(b[i]),
                   "x": float(x[i]),
                   "t": base + dt.timedelta(seconds=int(secs[i])),
                   "o": f"s{i}" if i % 3 else i})
    return ds


def canon(rows):
    """Rows in a canonical order, each by its exact repr."""
    return sorted(repr(sorted(r.items(), key=lambda kv: kv[0]))
                  for r in rows)


# ---------------------------------------------------------------------------
# random dataset lifecycles and relational plans, as the reference's
# tests/test_differential.py builds them (_build with index kinds a and b,
# _relational_plan), for any package with the reference's layout
# ---------------------------------------------------------------------------

VOCAB = ["tpu", "jax", "lsm", "tonight", "tonite", "coffee", "fuzzy",
         "mesh", "verona"]


def lifecycle_type(adm):
    return adm.RecordType("DiffT", (
        adm.Field("id", adm.INT64),
        adm.Field("g", adm.INT64),
        adm.Field("a", adm.INT64, optional=True),
        adm.Field("b", adm.INT64, optional=True),
        adm.Field("txt", adm.STRING, optional=True),
        adm.Field("loc", adm.POINT, optional=True),
    ), open=True)


def lifecycle_dataset(pkg, rng, n_rows, parts, threshold):
    """A random lifecycle (``random.Random`` draws in the reference's
    order): B+-tree indexes on a and b created before or after the
    inserts (backfill), inserts with optional and open fields of drifting
    kind, interleaved deletes, more deletes, and a crash recovery with
    probability 0.3; memtables left unflushed."""
    ds = pkg.dsm.PartitionedDataset(
        "D", lifecycle_type(pkg.adm), "id", num_partitions=parts,
        flush_threshold=threshold,
        merge_policy=pkg.lsm.TieredMergePolicy(k=rng.choice([2, 3, 4])))
    late = set()
    if rng.random() < 0.5:
        ds.create_index("a")
    else:
        late.add("a")
    if rng.random() < 0.5:
        ds.create_index("b", kind="btree")
    else:
        late.add("b")
    key_space = max(2 * n_rows, 4)
    for _ in range(n_rows):
        r = {"id": rng.randrange(key_space), "g": rng.randrange(4)}
        if rng.random() < 0.9:
            r["a"] = rng.randrange(-50, 50)
        if rng.random() < 0.7:
            r["b"] = rng.randrange(0, 30)
        if rng.random() < 0.8:
            r["txt"] = " ".join(rng.choice(VOCAB)
                                for _ in range(rng.randrange(1, 5)))
        if rng.random() < 0.7:
            r["loc"] = (rng.uniform(0.0, 1.0), rng.uniform(0.0, 1.0))
        if rng.random() < 0.5:
            r["x"] = rng.choice([rng.randrange(100), rng.uniform(0.0, 9.0),
                                 rng.choice(VOCAB)])
        if rng.random() < 0.3:
            r["flag"] = rng.random() < 0.5
        ds.insert(r)
        if rng.random() < 0.1:
            ds.delete(rng.randrange(key_space))
    for fld in ("a", "b"):
        if fld in late:
            ds.create_index(fld)
    for _ in range(rng.randrange(n_rows // 4 + 1)):
        ds.delete(rng.randrange(key_space))
    if rng.random() < 0.3:
        ds.crash_and_recover()
    return ds


def _range_pred(fld, lo, hi):
    return lambda r: fld in r \
        and (lo is None or r[fld] >= lo) and (hi is None or r[fld] <= hi)


def _btree_select(A, rng):
    lo = rng.randrange(-60, 50)
    hi = lo + rng.randrange(0, 60)
    lo_, hi_ = lo, hi
    if rng.random() < 0.15:
        lo_ = None
    elif rng.random() < 0.15:
        hi_ = None
    hints = ["skip-index"] if rng.random() < 0.25 else []
    return A.select(A.scan("D"), pred=_range_pred("a", lo_, hi_),
                    fields=["a"], ranges={"a": (lo_, hi_)},
                    ranges_exact=rng.random() < 0.5, hints=hints)


def _multi_select(A, rng):
    lo_a = rng.randrange(-60, 40)
    hi_a = lo_a + rng.randrange(5, 70)
    lo_b = rng.randrange(0, 20)
    hi_b = lo_b + rng.randrange(0, 15)
    pa, pb = _range_pred("a", lo_a, hi_a), _range_pred("b", lo_b, hi_b)
    return A.select(A.scan("D"),
                    pred=lambda r: pa(r) and pb(r), fields=["a", "b"],
                    ranges={"a": (lo_a, hi_a), "b": (lo_b, hi_b)},
                    ranges_exact=rng.random() < 0.5)


def relational_plan(A, rng, kind):
    """The reference's _relational_plan over the algebra module ``A``."""
    if kind == "btree":
        return _btree_select(A, rng)
    if kind == "multi":
        return _multi_select(A, rng)
    if kind == "agg":
        return A.aggregate(_btree_select(A, rng),
                           {"c": ("count", "*"), "s": ("sum", "a"),
                            "mn": ("min", "b"), "av": ("avg", "b")})
    if kind == "group":
        return A.group_by(_btree_select(A, rng), ["g"],
                          {"c": ("count", "*"), "mx": ("max", "a")})
    if kind == "topk":
        return A.limit(A.order_by(_btree_select(A, rng), ["id"],
                                  desc=rng.random() < 0.5),
                       rng.randrange(1, 9))
    if kind == "project":
        return A.project(_btree_select(A, rng), ["id", "g", "a"])
    raise AssertionError(kind)


def mesh_lifecycles(pkg, seed, check, n_cases=12):
    """The schedule of the reference's
    test_differential_mesh_lifecycle_schedules, calling ``check(ds,
    plan)`` where it queries: random lifecycles, each with a random plan
    kind, then one dataset whose flushes, a delete and a crash recovery
    interleave with aggregate queries.  Returns that last dataset."""
    import random
    rng = random.Random(seed)
    for _ in range(n_cases):
        ds = lifecycle_dataset(pkg, rng, rng.randrange(0, 90),
                               rng.choice([2, 3, 4]),
                               rng.choice([4, 9, 17, 33]))
        kind = rng.choice(["btree", "multi", "agg", "group", "topk",
                           "project"])
        check(ds, relational_plan(pkg.A, rng, kind))
    ds = pkg.dsm.PartitionedDataset(
        "D", lifecycle_type(pkg.adm), "id", num_partitions=4,
        flush_threshold=9, merge_policy=pkg.lsm.TieredMergePolicy(k=2))
    ds.create_index("a")
    for step in range(6):
        for _ in range(18):
            r = {"id": rng.randrange(200), "g": rng.randrange(4)}
            if rng.random() < 0.9:
                r["a"] = rng.randrange(-50, 50)
            ds.insert(r)
        if step == 2:
            for part in ds.partitions:
                part.primary.flush()
        if step == 3:
            ds.delete(rng.randrange(200))
        if step == 4:
            ds.crash_and_recover()
        check(ds, relational_plan(pkg.A, rng, "agg"))
    return ds


# ---------------------------------------------------------------------------
# many range predicates: 9 and 17 predicate columns reach K2 and A6
# ---------------------------------------------------------------------------

WIDE_FIELDS = 19             # f0 (indexed) .. f18


def wide_dataset(pkg, n=600, parts=4, threshold=64, seed=11):
    """``n`` seeded records of ``WIDE_FIELDS`` numeric fields (every third
    a DOUBLE, the rest INT64) in ``parts`` partitions, flushed every
    ``threshold`` inserts, never merged, with a B+-tree index on f0.
    Each partition keeps more than 32 survivors of every plan of
    :func:`wide_plans` at the default ``n``: a float64 sum over 17 to 31
    rows is a separate open fault (ROADMAP, section C.1), which the
    strict xfail test ``test_wide_range_index_chain_small_partitions``
    shows at ``n=160``."""
    import numpy as np
    adm = pkg.adm
    rtype = adm.RecordType("WideT", (adm.Field("id", adm.INT64),) + tuple(
        adm.Field(f"f{j}", adm.DOUBLE if j % 3 == 2 else adm.INT64)
        for j in range(WIDE_FIELDS)), open=True)
    ds = pkg.dsm.PartitionedDataset(
        "W", rtype, "id", num_partitions=parts, flush_threshold=threshold,
        merge_policy=pkg.lsm.TieredMergePolicy(k=99))
    ds.create_index("f0")
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 100, (n, WIDE_FIELDS))
    dbls = rng.standard_normal((n, WIDE_FIELDS)) * 100.0
    for i in range(n):
        ds.insert({"id": i, **{
            f"f{j}": float(dbls[i, j]) if j % 3 == 2 else int(ints[i, j])
            for j in range(WIDE_FIELDS)}})
    return ds


def _wide_range(j):
    return (-250.0, 250.0) if j % 3 == 2 else (2, 97)


def wide_plans(A, k):
    """Aggregates over selects that hand the kernels ``k`` predicate
    columns: ``scan`` ranges over f1 .. fk (none indexed) and
    ``skip_index`` over f0 .. f(k-1) with the skip-index hint, both exact
    (K2 fuses the select); ``index_chain`` probes f0's index and validates
    f1 .. fk (A6, or the per-operator path's K2)."""
    aggs = {"c": ("count", "*"), "s": ("sum", "f1"), "mn": ("min", "f2"),
            "av": ("avg", "f5"), "mx": ("max", "f3")}

    def sel(fields, **kw):
        ranges = {f"f{j}": _wide_range(j) for j in fields}

        def pred(r):
            return all(lo <= r[f] <= hi for f, (lo, hi) in ranges.items())
        return A.select(A.scan("W"), pred=pred, fields=sorted(ranges),
                        ranges=ranges, ranges_exact=True, **kw)
    return {
        "scan": A.aggregate(sel(range(1, k + 1)), aggs),
        "skip_index": A.aggregate(sel(range(k), hints=["skip-index"]),
                                  aggs),
        "index_chain": A.aggregate(sel(range(k + 1)), aggs)}


# ---------------------------------------------------------------------------
# the exchange: seeded partition batches for any package's ColumnBatch
# ---------------------------------------------------------------------------

EXCHANGE_CASES = ("hash", "empty_source", "empty_dest", "one_dest",
                  "invalid_keys", "two_keys", "f64_key", "bool_key")
# cases whose key the card hashes (one int64 or bool column, every row
# valid); the others take the host's partition ids
EXCHANGE_HASHED = ("hash", "empty_source", "empty_dest", "one_dest",
                   "bool_key")
_EXCHANGE_SIZES = (37, 129, 64, 1, 200, 3, 77, 65)


def _keys_bound_for(rng, p, n, keep):
    """``n`` int64 keys whose partition (hash_partition_array) passes
    ``keep``."""
    import numpy as np
    out = []
    while len(out) < n:
        k = rng.integers(-(1 << 62), 1 << 62, 4 * n + 8, dtype=np.int64)
        h = (k.astype(np.uint64) * np.uint64(11400714819323198485)) \
            >> np.uint64(40)
        out.extend(k[keep((h % np.uint64(p)).astype(np.int64))].tolist())
    return np.asarray(out[:n], np.int64)


def exchange_parts(Column, ColumnBatch, p, case, seed=0):
    """(batches of the ``p`` sources, partition keys) for an exchange
    case: ``hash`` an int64 key every row valid (hashed on the card), a
    float64 column with NaN, -0.0, +0.0 and infinities and a bool column
    with invalid rows; ``empty_source`` source 1 has no rows;
    ``empty_dest`` no row is bound for the last partition; ``one_dest``
    every row for partition 0; ``invalid_keys`` invalid key rows (which
    ``partition_ids`` refuses with a KeyError in both packages);
    ``two_keys`` a two-column key and ``f64_key`` a float64 key of
    integral and fractional values and -0.0 (the host's partition ids);
    ``bool_key`` the bool column, every row valid, as the key."""
    import numpy as np
    rng = np.random.default_rng(seed + 97 * p + EXCHANGE_CASES.index(case))
    sizes = list(_EXCHANGE_SIZES[:p])
    if case == "empty_source":
        sizes[1] = 0
    parts = []
    for n in sizes:
        if case == "empty_dest":
            k = _keys_bound_for(rng, p, n, lambda q: q != p - 1)
        elif case == "one_dest":
            k = _keys_bound_for(rng, p, n, lambda q: q == 0)
        else:
            k = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
            k[: n // 3] = rng.integers(0, 50, n // 3)
        kv = np.ones(n, bool)
        if case == "invalid_keys":
            kv = rng.random(n) < 0.8
        x = rng.standard_normal(n) * 1e3
        x[rng.random(n) < 0.1] = np.nan
        x[rng.random(n) < 0.1] = -0.0
        x[rng.random(n) < 0.1] = 0.0
        x[rng.random(n) < 0.05] = -np.inf
        f = rng.random(n) < 0.5
        y = np.where(rng.random(n) < 0.5, rng.integers(-5, 5, n) * 1.0,
                     rng.standard_normal(n) / 7.0)
        y[rng.random(n) < 0.1] = -0.0
        fv = np.ones(n, bool) if case == "bool_key" else rng.random(n) < 0.9
        parts.append(ColumnBatch({
            "k": Column("i64", k, kv, None),
            "b": Column("i64", rng.integers(0, 7, n, dtype=np.int64),
                        np.ones(n, bool), None),
            "x": Column("f64", x, rng.random(n) < 0.9, None),
            "f": Column("bool", f, fv, None),
            "y": Column("f64", y, np.ones(n, bool), None)}, n))
    keys = {"two_keys": ("k", "b"), "f64_key": ("y",),
            "bool_key": ("f",)}.get(case, ("k",))
    return parts, keys
