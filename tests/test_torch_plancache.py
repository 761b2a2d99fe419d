"""Rung 3 of the PyTorch port: the fused index chain (A6) behind
``repro_torch.columnar.plancache``, with the plan cache on in both
packages.

Seeded chains run in the port and in the reference on the same records
and must agree exactly: rows by their exact ``repr`` (float64 sums fold in
the reference's order, so DOUBLE aggregates agree bit for bit), and the
engines' accounting — ``fallback_reasons``, ``plan_cache_hits`` and
``plan_cache_misses``, ``kernel_retraces`` and the index cardinalities.
The reference's residency tests (``tests/test_residency.py``: upload-once
residency, plan-key splits, fused equal to unfused) are mirrored on the
port, and A6's plain version is held against the reference's
``_chain_math`` run through ``jax.jit`` on the same numpy inputs,
stacked rows, padding and missing tiers included.  The reference is
imported under the test-side x64 shim of ``tests/_torch_ref.py``.
"""

import datetime as dt

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro_torch  # noqa: E402
from repro_torch.kernels import chain_ops as CH  # noqa: E402
from repro_torch.kernels import columnar_ops as P_K  # noqa: E402

from _torch_ref import (canon, dataset, port_namespace,  # noqa: E402
                        reference_namespace, reference_x64, wide_dataset,
                        wide_plans)

PORT = port_namespace()


@pytest.fixture(scope="module")
def REF():
    with reference_x64():
        ref = reference_namespace()
        ref.PC.set_enabled(True)
        from repro.columnar.plancache import _chain_math
        ref.chain_math = _chain_math
        # the reference's jit caches start empty with its fresh import;
        # so do the port's seen kernel shapes
        P_K._SEEN.clear()
        yield ref


@pytest.fixture(autouse=True)
def _cpu_and_cache_on():
    repro_torch.set_device("cpu")
    PORT.PC.set_enabled(True)
    yield
    PORT.PC.set_enabled(True)


T0 = dt.datetime(2014, 1, 1)


def chain_plans(A):
    """Secondary-index chains: mask mode (exact, residual, a two-index
    conjunction, a DATETIME validate range) and aggregate mode (int64,
    DOUBLE and DATETIME columns, and an obj column reduced on the host)."""
    def sel(ranges, exact=True, extra_pred=None, fields=("a",)):
        def pred(r):
            ok = all(f in r and (lo is None or r[f] >= lo)
                     and (hi is None or r[f] <= hi)
                     for f, (lo, hi) in ranges.items())
            return ok and (extra_pred is None or extra_pred(r))
        return A.select(A.scan("D"), pred=pred, fields=list(fields),
                        ranges=dict(ranges), ranges_exact=exact)
    a_rng = {"a": (10, 29)}
    return {
        "exact": sel(a_rng),
        "residual": sel(a_rng, exact=False,
                        extra_pred=lambda r: r["id"] % 3 == 0,
                        fields=("a", "id")),
        "conjunction": sel({"a": (10, 29), "b": (5, 30)},
                           fields=("a", "b")),
        "datetime_range": sel({"a": (5, 40),
                               "t": (T0 + dt.timedelta(days=3),
                                     T0 + dt.timedelta(days=40))},
                              fields=("a", "t")),
        "aggregate": A.aggregate(sel(a_rng), {
            "c": ("count", "*"), "s": ("sum", "a"), "mb": ("min", "b"),
            "Mx": ("max", "x"), "av": ("avg", "x"), "sx": ("sum", "x"),
            "mt": ("min", "t"), "co": ("count", "o")}),
        "aggregate_validate": A.aggregate(
            sel({"a": (0, 45), "x": (-500.0, None)}, fields=("a", "x")),
            {"c": ("count", "*"), "sx": ("sum", "x"), "mn": ("min", "x")}),
    }


STATS = ("fallback_reasons", "plan_cache_hits", "plan_cache_misses",
         "kernel_retraces", "rows_fallback", "rows_index_vectorized")


@pytest.fixture(scope="module")
def chain_datasets(REF):
    kw = dict(n=300, parts=3, index_b=True, threshold=37, seed=5)
    return {"D": dataset(PORT, **kw)}, {"D": dataset(REF, **kw)}


@pytest.mark.parametrize("name", list(chain_plans(PORT.A)))
def test_fused_chain_agrees_with_reference(REF, chain_datasets, name):
    port, ref = chain_datasets
    pp, rp = chain_plans(PORT.A)[name], chain_plans(REF.A)[name]
    for rep in ("cold", "warm"):
        rows_p, ex_p = PORT.run_query(pp, port, vectorize=True)
        rows_r, ex_r = REF.run_query(rp, ref, vectorize=True)
        assert canon(rows_p) == canon(rows_r), (name, rep)
        for key in STATS:
            assert getattr(ex_p.stats, key) == getattr(ex_r.stats, key), \
                (name, rep, key)
        assert ex_p.stats.plan_cache_hits + ex_p.stats.plan_cache_misses \
            == 3, name                       # the chain fused everywhere
    assert ex_p.stats.h2d_bytes == 0 and ex_p.stats.kernel_retraces == 0


def test_fused_chain_dispatches_a6(chain_datasets):
    port, _ = chain_datasets
    snap = PORT.obs.snapshot()
    PORT.run_query(chain_plans(PORT.A)["exact"], port, vectorize=True)
    after = PORT.obs.snapshot()
    key = "kernel.fused_index_chain.dispatches"
    assert after.get(key, 0) - snap.get(key, 0) == 3
    for k in ("t_occurrence_mask", "range_mask", "fused_filter_aggregate"):
        key = f"kernel.{k}.dispatches"
        assert after.get(key, 0) == snap.get(key, 0), k


def test_aggregate_with_residual_declines(REF, chain_datasets):
    """The reference's decline at plancache.py:233: an aggregate over a
    residual-checked chain runs the per-operator path in both."""
    port, ref = chain_datasets

    def plan(A):
        return A.aggregate(
            A.select(A.scan("D"), pred=lambda r: 10 <= r["a"] <= 29,
                     fields=["a"], ranges={"a": (10, 29)}),
            {"c": ("count", "*"), "s": ("sum", "x")})
    rows_p, ex_p = PORT.run_query(plan(PORT.A), port, vectorize=True)
    rows_r, ex_r = REF.run_query(plan(REF.A), ref, vectorize=True)
    assert canon(rows_p) == canon(rows_r)
    assert ex_p.stats.plan_cache_hits + ex_p.stats.plan_cache_misses == 0
    assert ex_r.stats.plan_cache_hits + ex_r.stats.plan_cache_misses == 0


@pytest.fixture(scope="module")
def wide_datasets(REF):
    return {"W": wide_dataset(PORT)}, {"W": wide_dataset(REF)}


@pytest.mark.parametrize("plan", ["scan", "skip_index", "index_chain"])
@pytest.mark.parametrize("k", [9, 17])
def test_wide_range_aggregates_agree_with_reference(REF, wide_datasets, k,
                                                    plan):
    """``k`` predicate columns with the plan cache on: the index chain
    (``k`` validate ranges) fuses into A6 in every partition as the
    reference's chain does, counted by the plan cache alike, and the
    scans fuse into K2; rows by exact repr and the engines' accounting
    equal the reference's, cold and warm."""
    port, ref = wide_datasets
    pp, rp = wide_plans(PORT.A, k)[plan], wide_plans(REF.A, k)[plan]
    for rep in ("cold", "warm"):
        rows_p, ex_p = PORT.run_query(pp, port, vectorize=True)
        rows_r, ex_r = REF.run_query(rp, ref, vectorize=True)
        assert canon(rows_p) == canon(rows_r), rep
        for key in STATS:
            assert getattr(ex_p.stats, key) == getattr(ex_r.stats, key), \
                (rep, key)
        fused = ex_p.stats.plan_cache_hits + ex_p.stats.plan_cache_misses
        assert fused == (4 if plan == "index_chain" else 0), rep
    assert ex_p.stats.h2d_bytes == 0 and ex_p.stats.kernel_retraces == 0


# ---------------------------------------------------------------------------
# the reference's residency tests (tests/test_residency.py), on the port
# ---------------------------------------------------------------------------

def _select_plan(A, lo=10, hi=29):
    return A.select(A.scan("D"), pred=lambda r: lo <= r["a"] <= hi,
                    fields=["a"], ranges={"a": (lo, hi)}, ranges_exact=True)


def _agg_plan(A):
    return A.aggregate(_select_plan(A), {"c": ("count", "*"),
                                         "s": ("sum", "a")})


def test_repeated_chain_hits_pool_and_ships_nothing():
    ds = {"D": dataset(PORT, seed=11)}
    PORT.PC.plan_cache.clear()      # the first run here sees a new shape
    _, ex1 = PORT.run_query(_select_plan(PORT.A), ds, vectorize=True)
    assert ex1.stats.rows_fallback == 0
    assert ex1.stats.plan_cache_misses >= 1
    assert ex1.stats.h2d_bytes > 0
    r1 = PORT.DP.pool.resident_bytes()
    assert r1 > 0
    s0 = PORT.DP.pool.stats()
    _, ex2 = PORT.run_query(_select_plan(PORT.A), ds, vectorize=True)
    s1 = PORT.DP.pool.stats()
    assert ex2.stats.h2d_bytes == 0
    assert ex2.stats.kernel_retraces == 0
    assert ex2.stats.plan_cache_hits >= 1
    assert ex2.stats.plan_cache_misses == 0
    assert s1["hits"] > s0["hits"]
    assert s1["misses"] == s0["misses"]
    assert PORT.DP.pool.resident_bytes() == r1


def test_warm_aggregate_chain_ships_nothing():
    ds = {"D": dataset(PORT, seed=12)}
    a = ds["D"].scan()
    rows1, _ = PORT.run_query(_agg_plan(PORT.A), ds, vectorize=True)
    rows2, ex2 = PORT.run_query(_agg_plan(PORT.A), ds, vectorize=True)
    assert rows1 == rows2
    assert rows1[0]["c"] == sum(1 for r in a if 10 <= r["a"] <= 29)
    assert ex2.stats.h2d_bytes == 0
    assert ex2.stats.kernel_retraces == 0
    assert ex2.stats.plan_cache_hits >= 1


def test_plan_keys_split_on_ops_buckets_and_dtypes():
    ds = {"D": dataset(PORT, seed=13)}
    PC = PORT.PC
    PC.plan_cache.clear()
    PORT.run_query(_select_plan(PORT.A), ds, vectorize=True)
    e0 = PC.plan_cache.entry_count()
    _, ex = PORT.run_query(_select_plan(PORT.A), ds, vectorize=True)
    assert PC.plan_cache.entry_count() == e0
    assert ex.stats.kernel_retraces == 0
    # a different op sequence (the chain under LOCAL_AGG): new entries
    PORT.run_query(_agg_plan(PORT.A), ds, vectorize=True)
    e1 = PC.plan_cache.entry_count()
    assert e1 > e0
    # a different pow2 bucket (5x the rows): new entries
    big = {"D": dataset(PORT, n=600, seed=13)}
    PORT.run_query(_select_plan(PORT.A), big, vectorize=True)
    e2 = PC.plan_cache.entry_count()
    assert e2 > e1

    def with_range(fld, lo, hi):
        return PORT.A.select(
            PORT.A.scan("D"),
            pred=lambda r: 10 <= r["a"] <= 29 and lo <= r[fld] <= hi,
            fields=["a", fld],
            ranges={"a": (10, 29), fld: (lo, hi)}, ranges_exact=True)
    # a different validate dtype (float64 against int64): new entries
    PORT.run_query(with_range("b", 0, 20), ds, vectorize=True)
    e3 = PC.plan_cache.entry_count()
    assert e3 > e2
    PORT.run_query(with_range("x", 0.0, 20.0), ds, vectorize=True)
    assert PC.plan_cache.entry_count() > e3


def test_fused_chain_matches_unfused_and_row_engine():
    """Bit-identical rows in the same order (the DOUBLE values are halves,
    so every summation order gives the same sums, as in the reference's
    test)."""
    ds = {"D": dataset(PORT, index_b=True, seed=14, halves=True)}
    for name, plan in chain_plans(PORT.A).items():
        rows_row, _ = PORT.run_query(plan, ds, vectorize=False)
        PORT.PC.set_enabled(False)
        rows_leg, ex_leg = PORT.run_query(plan, ds, vectorize=True)
        PORT.PC.set_enabled(True)
        rows_fus, ex_fus = PORT.run_query(plan, ds, vectorize=True)
        assert ex_fus.stats.plan_cache_hits \
            + ex_fus.stats.plan_cache_misses >= 1, name
        assert ex_leg.stats.plan_cache_hits \
            + ex_leg.stats.plan_cache_misses == 0, name
        assert rows_fus == rows_leg, name
        assert canon(rows_fus) == canon(rows_row), name


# ---------------------------------------------------------------------------
# A6's plain version against the reference's _chain_math
# ---------------------------------------------------------------------------

def _chain_inputs(rng, fields, tiers, total_p2, live_p2, n_live, preds,
                  aggs, missing):
    """One partition row's numpy operands.  ``missing``: the row's last
    tier of field 0 is absent (zero width, bounds (0, 0, 0))."""
    tier_pos, tier_b = [], []
    for f in range(fields):
        fp, fb = [], []
        off = 0
        for t in range(tiers):
            w = 1 << int(rng.integers(2, 7))
            pos = rng.integers(0, max(total_p2 // tiers, 1), w)
            a = int(rng.integers(0, w))
            b = int(rng.integers(a, w + 1))
            if missing and f == 0 and t == tiers - 1:
                pos, a, b = np.zeros(1, np.int64), 0, 0
            fp.append(pos.astype(np.int64))
            fb.append((a, b, off))
            off += total_p2 // tiers
        tier_pos.append(fp)
        tier_b.append(fb)
    idx = np.zeros(live_p2, np.int64)
    idx[:n_live] = rng.integers(0, total_p2, n_live)
    pcols = []
    for kind in preds:
        valid = rng.random(live_p2) < 0.9
        if kind == "f64":
            x = rng.standard_normal(live_p2) * 1e3
            lo, hi = np.float64(-400.0), np.float64(900.0)
        else:                    # int64 or encoded datetime (microseconds)
            x = 1_388_534_400_000_000 * (kind == "dt") \
                + rng.integers(0, 10**9, live_p2)
            lo = np.int64(1_388_534_400_000_000 * (kind == "dt") + 10**8)
            hi = np.int64(lo + 6 * 10**8)
        pcols.append((x, valid, lo, hi))
    acols = []
    for kind in aggs:
        valid = rng.random(live_p2) < 0.9
        if kind == "f64":
            x = rng.standard_normal(live_p2) * 1e3
        elif kind == "code":
            x = rng.integers(0, 50, live_p2).astype(np.int32)
        else:
            x = 1_388_534_400_000_000 * (kind == "dt") \
                + rng.integers(-10**6, 10**9, live_p2)
        acols.append((x, valid))
    return tier_pos, tier_b, idx, pcols, acols


def _reference_chain(REF, row, total_p2, live_p2):
    tier_pos, tier_b, idx, n_live, pcols, acols = row
    jnp = jax.numpy
    with jax.enable_x64(True):
        fn = jax.jit(REF.chain_math, static_argnames=("total_p2",
                                                      "live_p2"))
        out = fn(tuple(tuple(jnp.asarray(p) for p in fp) for fp in tier_pos),
                 tuple(tuple(tuple(np.asarray(v, np.int64) for v in t)
                             for t in fb) for fb in tier_b),
                 jnp.asarray(idx), np.asarray(n_live, np.int64),
                 tuple((jnp.asarray(x), jnp.asarray(v), lo, hi)
                       for x, v, lo, hi in pcols),
                 tuple((jnp.asarray(x), jnp.asarray(v)) for x, v in acols),
                 total_p2=total_p2, live_p2=live_p2)
        return jax.device_get(out)


CHAIN_CASES = {
    "one_field_mask": dict(fields=1, tiers=1, preds=[], aggs=[]),
    "two_fields_tiers": dict(fields=2, tiers=3, preds=["i64"], aggs=[]),
    "three_fields_aggs": dict(fields=3, tiers=2, preds=["f64", "dt"],
                              aggs=["i64", "f64", "dt", "code"]),
    "multi_tier_doubles": dict(fields=1, tiers=4, preds=["dt"],
                               aggs=["f64", "f64"]),
}


def _stacked_chain(case, rows):
    """CHAIN_CASES[case] stacked over ``rows`` rows: (per-row numpy
    operands, then A6's stacked arguments).  Rows are zero-padded into
    common tier widths and a common live_p2, row 1 misses a tier, and (R
    > 1) the last row is an empty padding row with n_live = 0."""
    c = CHAIN_CASES[case]
    rng = np.random.default_rng(hash(case) % 2**32 + rows)
    total_p2, live_p2 = 256, 2048
    per_row = []
    for r in range(rows):
        n_live = 0 if rows > 1 and r == rows - 1 else \
            int(rng.integers(1, live_p2 + 1))
        per_row.append(_chain_inputs(rng, c["fields"], c["tiers"], total_p2,
                                     live_p2, n_live, c["preds"], c["aggs"],
                                     missing=r == 1) + (n_live,))
    # stack: every tier padded to the rows' widest, as run_all pads
    tiers = []
    abo = np.zeros((rows, c["fields"] * c["tiers"], 3), np.int64)
    for f in range(c["fields"]):
        fp = []
        for t in range(c["tiers"]):
            w = max(pr[0][f][t].shape[0] for pr in per_row)
            st = np.zeros((rows, w), np.int64)
            for r, pr in enumerate(per_row):
                st[r, :pr[0][f][t].shape[0]] = pr[0][f][t]
                abo[r, f * c["tiers"] + t] = pr[1][f][t]
            fp.append(torch.from_numpy(st))
        tiers.append(fp)
    idx = torch.from_numpy(np.stack([pr[2] for pr in per_row]))
    n_live = np.asarray([pr[5] for pr in per_row], np.int64)
    preds = []
    for j in range(len(c["preds"])):
        preds.append((torch.from_numpy(np.stack([pr[3][j][0]
                                                 for pr in per_row])),
                      torch.from_numpy(np.stack([pr[3][j][1]
                                                 for pr in per_row])),
                      np.asarray([pr[3][j][2] for pr in per_row]),
                      np.asarray([pr[3][j][3] for pr in per_row])))
    aggs = [(torch.from_numpy(np.stack([pr[4][j][0] for pr in per_row])),
             torch.from_numpy(np.stack([pr[4][j][1] for pr in per_row])))
            for j in range(len(c["aggs"]))]
    return per_row, (tiers, abo, idx, n_live, preds, aggs, total_p2,
                     live_p2)


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_plain_equals_reference_chain_math(REF, case, rows):
    """Row r of a stacked call equals ``_chain_math`` on row r's own
    operands: rows zero-padded into common tier widths and a common
    ``live_p2``, a row with a missing tier, and (at R = 4) an empty padding
    row with ``n_live = 0``."""
    c = CHAIN_CASES[case]
    per_row, args = _stacked_chain(case, rows)
    tiers, abo, idx, n_live, preds, aggs, total_p2, live_p2 = args
    raw, mask = CH.chain_plain(tiers, abo, idx, n_live, preds, aggs,
                               total_p2, live_p2)
    counts, per_col = CH.split_raw(raw, [k == "f64" for k in c["aggs"]],
                                   CH.N_COUNTS)
    for r, pr in enumerate(per_row):
        want = _reference_chain(
            REF, (pr[0], pr[1], pr[2], pr[5], pr[3], pr[4]), total_p2,
            live_p2)
        n_cand, n_found, n_valid, wmask, wper = want
        assert (counts[0][r], counts[1][r], counts[2][r]) == \
            (int(n_cand), int(n_found), int(n_valid)), (case, r)
        assert np.array_equal(mask[r], np.asarray(wmask)), (case, r)
        for j, (s, mn, mx, cnt) in enumerate(wper):
            gs, gmn, gmx, gc = (x[r] for x in per_col[j])
            assert int(gc) == int(cnt), (case, r, j)
            assert repr(gs.item()) == repr(np.asarray(s).item()), \
                (case, r, j, "sum")
            if int(cnt):
                assert gmn.item() == np.asarray(mn).item(), (case, r, j)
                assert gmx.item() == np.asarray(mx).item(), (case, r, j)
    assert counts[0][-1] >= 0
    if rows > 1:                  # the padding row selects nothing
        assert counts[0][-1] == 0 and not mask[-1].any()


@pytest.mark.parametrize("n_live", [17, 29, 32])
@pytest.mark.parametrize("ranges", [1, 2, 3])
def test_chain_plain_at_32_lanes_matches_chain_math(REF, ranges, n_live):
    """At ``live_p2`` = 32, where the loop K2 takes the reference's 32-slot
    order (``columnar_ops.sum32_unroll``), the reference's ``_chain_math``
    still sums left to right: A6's plain version (``tree_sum``) equals it
    bit for bit, with every live lane found and 1-3 validate ranges that
    keep most of them.  Four draws a case."""
    total_p2 = 64
    for seed in range(4):
        rng = np.random.default_rng(100 * ranges + n_live + seed)
        tier_pos = [[np.arange(total_p2, dtype=np.int64)]]
        tier_b = [[(0, total_p2, 0)]]
        idx = np.zeros(32, np.int64)
        idx[:n_live] = rng.integers(0, total_p2, n_live)
        pcols = []
        for j in range(ranges):
            valid = rng.random(32) < 0.95
            if j % 2:
                pcols.append((rng.integers(0, 100, 32, dtype=np.int64),
                              valid, np.int64(2), np.int64(98)))
            else:
                pcols.append((rng.standard_normal(32), valid,
                              np.float64(-3.0), np.float64(3.0)))
        acols = [(rng.standard_normal(32) * 100.0, rng.random(32) < 0.9),
                 (rng.integers(-9, 9, 32, dtype=np.int64),
                  np.ones(32, bool))]
        want = _reference_chain(REF, (tier_pos, tier_b, idx, n_live, pcols,
                                      acols), total_p2, 32)
        args = ([[torch.from_numpy(tier_pos[0][0][None, :])]],
                np.asarray([[[0, total_p2, 0]]], np.int64),
                torch.from_numpy(idx[None, :]),
                np.asarray([n_live], np.int64),
                [(torch.from_numpy(x[None, :]), torch.from_numpy(v[None, :]),
                  np.asarray([lo]), np.asarray([hi]))
                 for x, v, lo, hi in pcols],
                [(torch.from_numpy(x[None, :]), torch.from_numpy(v[None, :]))
                 for x, v in acols], total_p2, 32)
        raw, mask = CH.chain_plain(*args)
        n_cand, n_found, n_valid, wmask, wper = want
        assert tuple(raw[0, :3]) == (int(n_cand), int(n_found),
                                     int(n_valid))
        assert int(n_found) == n_live and int(n_valid) > n_live // 2
        assert np.array_equal(mask[0], np.asarray(wmask))
        _, per_col = CH.split_raw(raw, [True, False], CH.N_COUNTS)
        for (gs, gmn, gmx, gc), (s, mn, mx, c) in zip(per_col, wper):
            assert int(gc[0]) == int(c)
            for g, w in ((gs, s), (gmn, mn), (gmx, mx)):
                assert repr(g[0].item()) == repr(np.asarray(w).item())


# ---------------------------------------------------------------------------
# A6 on the card, transcribed: stamped flags in a pooled buffer and the
# row axis's fold order (tests/_torch_walk.py)
# ---------------------------------------------------------------------------

def _walk_chain(pool, args):
    """A6's raw and mask as the kernels compute them: the scatter's stamps
    in ``pool``, the gather, the predicates, then each row's slots folded
    in the row kernel's order."""
    from _torch_walk import chain_masks, rows_raw
    tiers, abo, idx, n_live, preds, aggs, total_p2, live_p2 = args
    rows = int(idx.shape[0])
    fl, stamp = pool.dispatch(rows, len(tiers), total_p2,
                              [[t.numpy() for t in fp] for fp in tiers],
                              abo)
    cand, found = chain_masks(fl, stamp, idx.numpy(), n_live, total_p2)
    mask = found.copy()
    for x, v, lo, hi in preds:
        x = x.numpy()
        mask &= v.numpy() & (x >= np.asarray(lo)[:, None]) \
            & (x <= np.asarray(hi)[:, None])
    counts = [(int(cand[r].sum()), int(found[r].sum()), int(mask[r].sum()))
              for r in range(rows)]
    return rows_raw(mask, [(x.numpy(), v.numpy()) for x, v in aggs], rows,
                    live_p2, counts), mask


@pytest.mark.parametrize("rows", [1, 3, 5])
@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_walk_transcription(REF, case, rows):
    """The transcribed kernels (stamped flags, the row kernels' fold
    order) equal A6's plain version bit for bit at 1, 3 and
    5 rows, and each row equals the reference's ``_chain_math``."""
    from _torch_walk import FlagPool
    per_row, args = _stacked_chain(case, rows)
    raw, mask = _walk_chain(FlagPool(), args)
    praw, pmask = CH.chain_plain(*args)
    assert np.array_equal(mask, pmask), case
    assert np.array_equal(raw, praw), case
    total_p2, live_p2 = args[6], args[7]
    for r, pr in enumerate(per_row):
        n_cand, n_found, n_valid, wmask, _ = _reference_chain(
            REF, (pr[0], pr[1], pr[2], pr[5], pr[3], pr[4]), total_p2,
            live_p2)
        assert tuple(raw[r, :3]) == (int(n_cand), int(n_found),
                                     int(n_valid)), (case, r)
        assert np.array_equal(mask[r], np.asarray(wmask)), (case, r)


def test_chain_flag_stamps_transcription():
    """301 dispatches of varied shapes through one pooled flag buffer (the
    first the largest, a wrap past stamp 255, then a grown buffer): each
    dispatch's candidate and found lanes equal A6's plain version, so no
    slot stamped by an earlier dispatch reads as set."""
    from _torch_walk import FlagPool
    rng = np.random.default_rng(20)
    pool = FlagPool()
    for i in range(301):
        rows = 3 if i == 0 else int(rng.integers(1, 4))
        fields = 2 if i == 0 else int(rng.integers(1, 3))
        total_p2 = 128 if i == 300 else 64
        live_p2 = 64
        tiers, abo = [], np.zeros((rows, 2 * fields, 3), np.int64)
        for f in range(fields):
            fp = []
            for t in range(2):
                w = int(rng.integers(1, 40))
                fp.append(torch.from_numpy(
                    rng.integers(0, total_p2 // 2, (rows, w))))
                for r in range(rows):
                    a = int(rng.integers(0, w))
                    abo[r, 2 * f + t] = (a, int(rng.integers(a, w + 1)),
                                         t * total_p2 // 2)
            tiers.append(fp)
        idx = torch.from_numpy(rng.integers(-3, total_p2 + 3,
                                            (rows, live_p2)))
        n_live = rng.integers(0, live_p2 + 1, rows)
        args = (tiers, abo, idx, n_live, [], [], total_p2, live_p2)
        raw, mask = _walk_chain(pool, args)
        praw, pmask = CH.chain_plain(*args)
        assert np.array_equal(mask, pmask) and np.array_equal(raw, praw), i
    assert pool.clears == 3           # the new buffer, a wrap, the growth
