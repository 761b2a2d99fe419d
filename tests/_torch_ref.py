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
