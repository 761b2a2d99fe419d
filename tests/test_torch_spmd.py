"""Rung 4 of the PyTorch port: the partition runtime
(``repro_torch.runtime.spmd``), where the executor's per-partition loops
run as one stacked launch over ``n`` partition lanes of one device.

At one lane the port is held against the reference's own mesh path (a
one-device ``shard_map``, which runs in-process): rows by their exact
``repr``, and ``spmd_dispatches``, ``spmd_partitions``,
``fallback_reasons``, the plan cache's hits and misses and
``kernel_retraces``.  At 2 and 4 lanes (the reference would need as many
devices) the port's rows equal the port's own loop and the reference's
loop, as the reference's contract at ``tests/test_spmd.py:344,354``
demands of its meshes.  The reference's tests of the module are mirrored
on the port: bit-identity with the loop, one dispatch for all partitions,
the loop without a mesh and with too few stackable partitions, the stack
cache, plan keys split on the mesh, warm mesh queries shipping nothing,
the merges against numpy, the exchange against the host bucketing and
its decline of string schemas, the mesh context and ``rows_for``.

Two of the reference's tests have no counterpart on one card:
``test_pool_reshard_evicts_other_placement`` (:220) and
``test_mesh_switch_reshards_cleanly`` (:372) check that a buffer moving
between a device placement and a sharding over several devices is
evicted from the old one.  The port's lanes all live on the one device,
so a stacked operand has one placement whatever the mesh, and nothing
reshards.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro_torch  # noqa: E402
from repro_torch.kernels import columnar_ops as P_K  # noqa: E402

from _torch_ref import (EXCHANGE_CASES, EXCHANGE_HASHED,  # noqa: E402
                        canon, dataset, exchange_parts, port_namespace,
                        reference_namespace, reference_x64, wide_dataset,
                        wide_plans)

PORT = port_namespace()
SP = PORT.SP


@pytest.fixture(scope="module")
def REF():
    with reference_x64():
        ref = reference_namespace()
        ref.PC.set_enabled(True)
        P_K._SEEN.clear()
        yield ref


@pytest.fixture(autouse=True)
def _cpu_and_cache_on():
    repro_torch.set_device("cpu")
    PORT.PC.set_enabled(True)
    yield
    PORT.PC.set_enabled(True)


def _chain_plan(A, lo=10, hi=29):
    return A.select(A.scan("D"), pred=lambda r: lo <= r["a"] <= hi,
                    fields=["a"], ranges={"a": (lo, hi)},
                    ranges_exact=True)


def _chain_agg_plan(A):
    return A.aggregate(_chain_plan(A),
                       {"c": ("count", "*"), "s": ("sum", "a"),
                        "mn": ("min", "b"), "av": ("avg", "x")})


def _scan_select_plan(A):
    # a range over the un-indexed DOUBLE column: no index chain, so the
    # mesh path is batched_range_masks under SELECT
    return A.select(A.scan("D"), pred=lambda r: 10.0 <= r["x"] <= 600.0,
                    fields=["a", "x"], ranges={"x": (10.0, 600.0)},
                    ranges_exact=True)


def _scan_agg_plan(A):
    return A.aggregate(_scan_select_plan(A),
                       {"c": ("count", "*"), "s": ("sum", "a"),
                        "m": ("min", "x"), "sx": ("sum", "x"),
                        "co": ("count", "o")})


def _grouped_plan(A):
    # a group-by over numeric columns: its hash repartition is the
    # exchange when the lanes equal the partitions
    return A.group_by(A.scan("D"), ["b"], {"c": ("count", "*"),
                                           "mx": ("max", "a")})


PLANS = {"chain": _chain_plan, "chain_agg": _chain_agg_plan,
         "scan_select": _scan_select_plan, "scan_agg": _scan_agg_plan,
         "grouped": _grouped_plan}
STATS = ("fallback_reasons", "spmd_dispatches", "spmd_partitions",
         "plan_cache_hits", "plan_cache_misses", "kernel_retraces",
         "rows_fallback")


@pytest.fixture(scope="module")
def mesh_datasets(REF):
    kw = dict(n=160, parts=4, threshold=24, seed=3)
    return {"D": dataset(PORT, **kw)}, {"D": dataset(REF, **kw)}


@pytest.mark.parametrize("name", list(PLANS))
def test_one_lane_agrees_with_reference_mesh(REF, mesh_datasets, name):
    port, ref = mesh_datasets
    for rep in ("cold", "warm"):
        rows_p, ex_p = PORT.run_query(PLANS[name](PORT.A), port,
                                      vectorize=True, mesh=1)
        rows_r, ex_r = REF.run_query(PLANS[name](REF.A), ref,
                                     vectorize=True, mesh=1)
        assert canon(rows_p) == canon(rows_r), (name, rep)
        for key in STATS:
            assert getattr(ex_p.stats, key) == getattr(ex_r.stats, key), \
                (name, rep, key)
    if name != "grouped":
        assert ex_p.stats.spmd_dispatches >= 1


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("name", list(PLANS))
def test_lanes_equal_the_loop(REF, mesh_datasets, name, lanes):
    """At 2 and 4 lanes the rows equal the port's loop and the reference's
    loop; a warm repeat ships nothing but the exchange's send planes,
    which are built per query (as in the reference)."""
    port, ref = mesh_datasets
    rows_l, ex_l = PORT.run_query(PLANS[name](PORT.A), port, vectorize=True)
    rows_r, _ = REF.run_query(PLANS[name](REF.A), ref, vectorize=True)
    rows_m, ex_m = PORT.run_query(PLANS[name](PORT.A), port, vectorize=True,
                                  mesh=lanes)
    assert canon(rows_m) == canon(rows_l) == canon(rows_r)
    assert ex_m.stats.fallback_reasons == ex_l.stats.fallback_reasons
    # the exchange runs only where the lanes equal the 4 partitions
    assert (ex_m.stats.spmd_dispatches >= 1) == \
        (name != "grouped" or lanes == 4)
    snap = PORT.obs.snapshot()
    _, ex_w = PORT.run_query(PLANS[name](PORT.A), port, vectorize=True,
                             mesh=lanes)
    exch = PORT.obs.snapshot().get("kernel.spmd_exchange.h2d_bytes", 0) \
        - snap.get("kernel.spmd_exchange.h2d_bytes", 0)
    assert ex_w.stats.h2d_bytes == exch
    assert (exch > 0) == (name == "grouped" and lanes == 4)
    assert ex_w.stats.kernel_retraces == 0


@pytest.fixture(scope="module")
def wide_datasets(REF):
    return {"W": wide_dataset(PORT)}, {"W": wide_dataset(REF)}


@pytest.mark.parametrize("plan", ["scan", "skip_index", "index_chain"])
@pytest.mark.parametrize("k", [9, 17])
def test_wide_range_aggregates_on_the_mesh(REF, wide_datasets, k, plan):
    """``k`` predicate columns on the partition mesh: at one lane rows and
    accounting equal the reference's one-device mesh; at 4 lanes one
    stacked dispatch (stacked K2, or stacked A6 for the index chain)
    gives the loop's rows and the reference's loop's, and a warm repeat
    ships and retraces nothing."""
    port, ref = wide_datasets
    pp, rp = wide_plans(PORT.A, k)[plan], wide_plans(REF.A, k)[plan]
    rows_p, ex_p = PORT.run_query(pp, port, vectorize=True, mesh=1)
    rows_r, ex_r = REF.run_query(rp, ref, vectorize=True, mesh=1)
    assert canon(rows_p) == canon(rows_r)
    for key in STATS:
        assert getattr(ex_p.stats, key) == getattr(ex_r.stats, key), key
    rows_l, ex_l = PORT.run_query(pp, port, vectorize=True)
    rows_rl, _ = REF.run_query(rp, ref, vectorize=True)
    for rep in ("cold", "warm"):
        rows_m, ex_m = PORT.run_query(pp, port, vectorize=True, mesh=4)
        assert canon(rows_m) == canon(rows_l) == canon(rows_rl), rep
        assert ex_m.stats.fallback_reasons == ex_l.stats.fallback_reasons
        assert (ex_m.stats.spmd_dispatches, ex_m.stats.spmd_partitions) \
            == (1, 4), rep
    assert ex_m.stats.h2d_bytes == 0 and ex_m.stats.kernel_retraces == 0


# ---------------------------------------------------------------------------
# the reference's tests/test_spmd.py, on the port
# ---------------------------------------------------------------------------

def _ds(**kw):
    kw.setdefault("n", 160)
    kw.setdefault("parts", 4)
    kw.setdefault("threshold", 24)
    return {"D": dataset(PORT, **kw)}


def _loop_vs_mesh(ds, plan, lanes):
    rows_l, ex_l = PORT.run_query(plan, ds, vectorize=True)
    rows_m, ex_m = PORT.run_query(plan, ds, vectorize=True, mesh=lanes)
    assert canon(rows_l) == canon(rows_m)
    assert ex_l.stats.fallback_reasons == ex_m.stats.fallback_reasons
    return ex_l, ex_m


@pytest.mark.parametrize("mk_plan", [_chain_plan, _chain_agg_plan,
                                     _scan_select_plan, _scan_agg_plan])
def test_mesh_matches_loop_bit_for_bit(mk_plan):
    ds = _ds(seed=21)
    _, ex_m = _loop_vs_mesh(ds, mk_plan(PORT.A), 1)
    assert ex_m.stats.spmd_dispatches >= 1
    assert ex_m.stats.spmd_partitions == 4
    _, ex_w = PORT.run_query(mk_plan(PORT.A), ds, vectorize=True, mesh=1)
    assert ex_w.stats.h2d_bytes == 0
    assert ex_w.stats.kernel_retraces == 0


def test_one_dispatch_replaces_the_partition_loop():
    ds = _ds(seed=22)
    d0, p0 = SP.dispatch_totals()
    _, ex = PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True, mesh=1)
    d1, p1 = SP.dispatch_totals()
    assert (d1 - d0, p1 - p0) == (1, 4)
    assert ex.stats.spmd_dispatches == 1
    assert ex.stats.spmd_partitions == 4


def test_loop_fallback_without_mesh():
    ds = _ds(seed=23)
    _, ex = PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True)
    assert ex.stats.spmd_dispatches == 0
    assert ex.stats.spmd_partitions == 0


def test_fallback_when_too_few_stackable_partitions():
    ds = _ds(n=60, parts=1, seed=24)
    rows_l, _ = PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True)
    f0 = PORT.obs.counter("mesh.spmd_fallbacks").value
    rows_m, ex = PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True,
                                mesh=1)
    assert canon(rows_l) == canon(rows_m)
    assert ex.stats.spmd_dispatches == 0
    assert PORT.obs.counter("mesh.spmd_fallbacks").value > f0


def test_stack_cache_returns_identical_object_for_same_inputs():
    sc = SP.StackCache()
    a = np.arange(5, dtype=np.int64)
    b = np.arange(3, dtype=np.int64)
    s1 = sc.stack([a, b], rows=2, width=8, dtype=np.int64)
    s2 = sc.stack([a, b], rows=2, width=8, dtype=np.int64)
    assert s1 is s2
    assert s1.shape == (2, 8)
    assert np.array_equal(s1[0, :5], a) and np.array_equal(s1[1, :3], b)
    assert (s1[0, 5:] == 0).all() and (s1[1, 3:] == 0).all()
    s3 = sc.stack([a, b], rows=2, width=16, dtype=np.int64)
    assert s3 is not s1
    s4 = sc.stack([a, b], rows=2, width=8, dtype=np.int64, fill=-1)
    assert s4 is not s1 and (s4[0, 5:] == -1).all()
    s5 = sc.stack([a, None], rows=2, width=8, dtype=np.int64)
    assert (s5[1] == 0).all()


def test_stack_cache_entry_dies_with_its_inputs():
    import gc
    sc = SP.StackCache()
    a = np.arange(4, dtype=np.int64)
    sc.stack([a], rows=1, width=4, dtype=np.int64)
    assert sc.entry_count() == 1
    del a
    gc.collect()
    assert sc.entry_count() == 0


def test_plan_cache_keys_split_on_mesh():
    ds = _ds(seed=25)
    PORT.PC.plan_cache.clear()
    PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True)
    e0 = PORT.PC.plan_cache.entry_count()
    assert e0 > 0
    PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True, mesh=1)
    e1 = PORT.PC.plan_cache.entry_count()
    assert e1 > e0
    PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True)
    PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True, mesh=1)
    assert PORT.PC.plan_cache.entry_count() == e1
    # and on the lane count
    PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True, mesh=2)
    assert PORT.PC.plan_cache.entry_count() > e1


def test_warm_mesh_query_ships_zero_bytes():
    ds = _ds(seed=26)
    PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True, mesh=1)
    _, ex = PORT.run_query(_chain_plan(PORT.A), ds, vectorize=True, mesh=1)
    assert ex.stats.h2d_bytes == 0
    assert ex.stats.kernel_retraces == 0
    assert ex.stats.plan_cache_hits >= 1
    assert ex.stats.plan_cache_misses == 0


def test_four_lanes_attribute_uploads_to_every_lane():
    """:354's shard attribution: a cold 4-lane query's stacked uploads
    count evenly against each lane."""
    ds = _ds(seed=27)
    PORT.DP.pool.clear()
    h0 = [PORT.obs.counter(f"mesh.shard{k}.h2d_bytes").value
          for k in range(4)]
    _, ex_m = _loop_vs_mesh(ds, _chain_agg_plan(PORT.A), 4)
    assert ex_m.stats.spmd_dispatches >= 1
    h1 = [PORT.obs.counter(f"mesh.shard{k}.h2d_bytes").value
          for k in range(4)]
    deltas = [b - a for a, b in zip(h0, h1)]
    assert all(d > 0 for d in deltas) and len(set(deltas)) == 1
    _, ex_w = PORT.run_query(_chain_agg_plan(PORT.A), ds, vectorize=True,
                             mesh=4)
    assert ex_w.stats.h2d_bytes == 0
    assert ex_w.stats.kernel_retraces == 0


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("op,merge,red", [
    ("sum", SP.psum_merge, np.sum),
    ("min", SP.pmin_merge, np.min),
    ("max", SP.pmax_merge, np.max)])
def test_collective_merge_matches_numpy(op, merge, red, lanes):
    """The merges against numpy, with the rows padded to the lanes by the
    operation's identity (3 partials on 2 and 4 lanes), a NaN in one
    column, and int64 partials."""
    rng = np.random.default_rng(11)
    parts = [rng.normal(size=(7,)) for _ in range(3)]
    parts[1][4] = np.nan
    ints = rng.integers(-10**12, 10**12, (3, 5))
    with SP.use_partition_mesh(lanes):
        got = merge(parts)
        got_i = merge(ints)
        got_1 = merge(np.asarray([2.5, -1.0, 4.0]))
    assert np.array_equal(np.asarray(got), red(parts, axis=0),
                          equal_nan=True)
    assert np.array_equal(got_i, red(ints, axis=0))
    assert got_1.shape == (1,) and got_1[0] == red([2.5, -1.0, 4.0])


@pytest.mark.parametrize("rows", [2, 3])
@pytest.mark.parametrize("k", [1, 3, 5, 9, 17])
def test_stacked_float64_sum_at_32_lanes_matches_agg_fn(REF, k, rows):
    """Stacked K2's plain version at ``live_p2`` = 32, every slot bit for
    bit against the reference's own stacked core (``_agg_fn`` on its
    one-device mesh): its vmapped [R, 32] reduce sums each row left to
    right, not in the loop path's 32-slot order (``columnar_ops.
    sum32_unroll``), at every number of predicate columns."""
    import jax
    import torch
    from repro.runtime import spmd as RS
    from repro_torch.kernels import spmd_ops as SO
    rng = np.random.default_rng(100 * k + rows)
    n = 32
    datas, valids, los, his = [], [], [], []
    for j in range(k):
        if j % 2:
            datas.append(rng.integers(0, 100, (rows, n), dtype=np.int64))
            los.append(np.full(rows, 3, np.int64))
            his.append(np.full(rows, 97, np.int64))
        else:
            datas.append(rng.standard_normal((rows, n)))
            los.append(np.full(rows, -3.0))
            his.append(np.full(rows, 3.0))
        valids.append(rng.random((rows, n)) < 0.97)
    adatas = [rng.standard_normal((rows, n)) * 100.0,
              rng.integers(-50, 50, (rows, n), dtype=np.int64)]
    avalids = [rng.random((rows, n)) < 0.9, np.ones((rows, n), bool)]
    fn = RS._agg_fn(RS.partition_mesh(1), k, 2, n)
    with jax.enable_x64(True):
        total, mask, per_col = jax.device_get(fn(
            tuple(datas), tuple(valids), tuple(los), tuple(his),
            tuple(adatas), tuple(avalids)))
    pcols = [(torch.from_numpy(d), torch.from_numpy(v), lo, hi)
             for d, v, lo, hi in zip(datas, valids, los, his)]
    acols = [(torch.from_numpy(d), torch.from_numpy(v))
             for d, v in zip(adatas, avalids)]
    raw, pmask = SO.filter_aggregate_rows_plain(pcols, acols, rows, n)
    assert np.array_equal(pmask, np.asarray(mask))
    assert np.array_equal(raw[:, 0], np.asarray(total))
    for j, (s, mn, mx, cnt) in enumerate(per_col):
        got = raw[:, 1 + 4 * j:5 + 4 * j]
        assert np.array_equal(got[:, 0], np.asarray(cnt))
        for f, want in ((1, s), (2, mn), (3, mx)):
            want = np.ascontiguousarray(want)
            bits = want.view(np.int64) if want.dtype == np.float64 else want
            assert np.array_equal(got[:, f], bits), (j, f)


def test_merge_needs_an_active_mesh():
    with pytest.raises(RuntimeError, match="mesh"):
        SP.psum_merge(np.ones((2, 3)))


def _host_buckets(cparts, keys, p):
    O, CB = PORT.O, PORT.ColumnBatch
    buckets = [[] for _ in range(p)]
    for i, b in enumerate(cparts):
        if not len(b):
            continue
        ids = O.partition_ids(b, keys, p)
        for j in range(p):
            sel = ids == j
            if sel.any():
                buckets[j].append(b.filter(sel))
    return [CB.concat(bs) if bs else CB({}, 0) for bs in buckets]


def _num_batch(rng, n):
    return PORT.ColumnBatch({
        "k": PORT.Column("i64", rng.integers(0, 100, n).astype(np.int64),
                         np.ones(n, bool), None),
        "v": PORT.Column("f64", rng.normal(size=n), rng.random(n) < 0.9,
                         None),
    }, n)


EXCHANGE_P = (2, 3, 4, 8)
_REF_EXCHANGE = r"""
import pickle, sys
sys.path[:0] = [{tests!r}, {src!r}]
from _torch_ref import EXCHANGE_CASES, exchange_parts, reference_x64
out = {{}}
with reference_x64():
    from repro.columnar.batch import Column, ColumnBatch
    from repro.runtime import spmd
    for p in {ps!r}:
        for case in EXCHANGE_CASES:
            parts, keys = exchange_parts(Column, ColumnBatch, p, case)
            with spmd.use_partition_mesh(p):
                try:
                    batches, moved = spmd.exchange_batches(parts, keys, p)
                except KeyError:
                    out[(p, case)] = "KeyError"
                    continue
            out[(p, case)] = (moved, [
                {{nm: (c.data[:len(b)], c.valid[:len(b)])
                  for nm, c in b.columns.items()}} for b in batches])
with open({path!r}, "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def ref_exchanges(tmp_path_factory):
    """The reference's ``exchange_batches`` on every exchange case, run in
    a process of its own on 8 forced host devices (its exchange is an
    ``all_to_all`` over a mesh of p devices): {(p, case): (moved, each
    destination's {column: (data, valid)}), or the name of the error it
    raised}."""
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path
    tests = Path(__file__).resolve().parent
    path = tmp_path_factory.mktemp("ref_exchange") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = _REF_EXCHANGE.format(tests=str(tests),
                                src=str(tests.parent / "src"),
                                ps=EXCHANGE_P, path=str(path))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", EXCHANGE_CASES)
@pytest.mark.parametrize("p", EXCHANGE_P)
def test_exchange_matches_host_bucketing(ref_exchanges, p, case):
    """The exchange against the host bucketing (``columnar/lower.py``) and
    the reference's ``exchange_batches``, byte for byte (NaN, -0.0 and
    invalid rows included): rows, order, ``moved``; one dispatch, whose
    h2d and d2h bytes are the layout's buffers, the host-ids counter
    moved only where the key is not hashed on the card, and a warm
    repeat retraces nothing.  Invalid key rows: ``partition_ids`` raises,
    in the host bucketing, the reference's exchange and the port's."""
    cparts, keys = exchange_parts(PORT.Column, PORT.ColumnBatch, p, case)
    if case == "invalid_keys":
        assert ref_exchanges[(p, case)] == "KeyError"
        with pytest.raises(KeyError):
            _host_buckets(cparts, keys, p)
        with SP.use_partition_mesh(p), pytest.raises(KeyError):
            SP.exchange_batches(cparts, keys, p)
        return
    host = _host_buckets(cparts, keys, p)
    key = "kernel.spmd_exchange."
    s0 = PORT.obs.snapshot()
    t0 = P_K.trace_count()
    with SP.use_partition_mesh(p):
        got = SP.exchange_batches(cparts, keys, p)
        s1 = PORT.obs.snapshot()
        t1 = P_K.trace_count()
        assert SP.exchange_batches(cparts, keys, p) is not None
        plan = SP._exchange_plan(cparts, keys, p)
    assert P_K.trace_count() == t1 >= t0
    assert got is not None

    def diff(name):
        return s1.get(name, 0) - s0.get(name, 0)
    lay = SP._ops.exchange_layout(plan[1], [c[0][0].dtype for c in plan[0]],
                                  plan[2] if isinstance(plan[2], int)
                                  else None, p)
    assert diff(key + "dispatches") == 1
    assert diff(key + "h2d_bytes") == lay.send_bytes
    assert diff(key + "d2h_bytes") == lay.recv_bytes
    hashed = case in EXCHANGE_HASHED
    assert diff("mesh.exchange_host_pids") == (0 if hashed else 1)
    assert isinstance(plan[2], int) == hashed
    out, moved = got
    assert moved == sum(
        int((PORT.O.partition_ids(b, keys, p) != i).sum())
        for i, b in enumerate(cparts) if len(b))
    ref_moved, ref_out = ref_exchanges[(p, case)]
    assert moved == ref_moved
    if case == "empty_dest":
        assert len(out[p - 1]) == 0
    if case == "one_dest":
        assert all(len(out[j]) == 0 for j in range(1, p))
    for j in range(p):
        assert len(out[j]) == len(host[j]) == len(
            next(iter(ref_out[j].values()), ((),))[0])
        if not len(out[j]):
            continue
        for nm in ("k", "b", "x", "f", "y"):
            a, b = out[j].columns[nm], host[j].columns[nm]
            n = len(out[j])
            assert a.kind == b.kind
            for got_a, want in ((a.data[:n], b.data[:n]),
                                (a.valid[:n], b.valid[:n])):
                assert _same_bits(got_a, want), (j, nm)
            rd, rv = ref_out[j][nm]
            assert _same_bits(a.data[:n], rd) and \
                _same_bits(a.valid[:n], rv), (j, nm)


def test_exchange_declines_string_schemas_and_other_lane_counts():
    rng = np.random.default_rng(5)
    p = 4

    def mk(n):
        b = _num_batch(rng, n)
        vals = [f"s{int(v) % 3}" for v in b.columns["k"].data[:n]]
        b.columns["s"] = PORT.build_column(vals, "str")
        return b
    cparts = [mk(8) for _ in range(p)]
    with SP.use_partition_mesh(p):
        assert SP.exchange_batches(cparts, ("k",), p) is None
    nums = [_num_batch(rng, 8) for _ in range(p)]
    with SP.use_partition_mesh(2):      # lanes != partitions: host path
        assert SP.exchange_batches(nums, ("k",), p) is None


def test_mesh_context_and_key():
    assert SP.active_mesh() is None
    assert SP.mesh_key() is None
    with SP.use_partition_mesh(1):
        m = SP.active_mesh()
        assert m is not None and SP.mesh_size() == 1
        key = SP.mesh_key()
        assert key is not None and key[0] == SP.PART_AXIS
        with SP.use_partition_mesh(1):
            assert SP.mesh_key() == key
        with SP.use_partition_mesh(4):
            assert SP.mesh_size() == 4 and SP.mesh_key() != key
        assert SP.active_mesh() is m
    assert SP.active_mesh() is None
    with pytest.raises(ValueError):
        SP.partition_mesh(0)
    with pytest.raises(TypeError):
        with SP.use_partition_mesh(mesh=object()):
            pass


def test_rows_for_rounds_up_to_mesh_multiple():
    m = SP.partition_mesh(1)
    assert SP.rows_for(1, m) == 1
    assert SP.rows_for(3, m) == 3
    m4 = SP.partition_mesh(4)
    assert SP.rows_for(3, m4) == 4 and SP.rows_for(5, m4) == 8
    assert SP.rows_for(0, m4) == 4


# ---------------------------------------------------------------------------
# the mesh axis of tests/test_differential.py
# (test_differential_mesh_lifecycle_schedules), which needs 2 or 4 devices
# in the reference: the port's lanes all live on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devs", [2, 4])
def test_mesh_lifecycle_schedules_mirror(REF, devs):
    """Random dataset lifecycles (flush / merge / delete / crash recovery,
    the reference's schedule and seed for ``devs``) queried at ``devs``
    lanes equal the port's loop and the reference's one-device loop, rows
    by exact repr and fallback reasons; a warm mesh repeat retraces
    nothing."""
    import random
    from _torch_ref import mesh_lifecycles, relational_plan
    port_res, ref_res = [], []

    def port_check(ds, plan):
        rows_l, ex_l = PORT.run_query(plan, {"D": ds}, vectorize=True)
        rows_m, ex_m = PORT.run_query(plan, {"D": ds}, vectorize=True,
                                      mesh=devs)
        assert canon(rows_m) == canon(rows_l)
        assert ex_m.stats.fallback_reasons == ex_l.stats.fallback_reasons
        port_res.append((canon(rows_m), ex_m.stats.fallback_reasons))

    def ref_check(ds, plan):
        rows, ex = REF.run_query(plan, {"D": ds}, vectorize=True)
        ref_res.append((canon(rows), ex.stats.fallback_reasons))

    seed = 20260807 * devs + 11
    ds = mesh_lifecycles(PORT, seed, port_check)
    mesh_lifecycles(REF, seed, ref_check)
    assert port_res == ref_res
    plan = relational_plan(PORT.A, random.Random(3), "agg")
    PORT.run_query(plan, {"D": ds}, vectorize=True, mesh=devs)
    _, ex = PORT.run_query(plan, {"D": ds}, vectorize=True, mesh=devs)
    assert ex.stats.kernel_retraces == 0


# ---------------------------------------------------------------------------
# the row axis on the card, transcribed (tests/_torch_walk.py): A6's
# mask-mode walk of one wave over every row's logical blocks, and stacked
# K2's fold order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 3, 5, 8])
@pytest.mark.parametrize("n", [37, 5000, 3 * 2048, 600_000])
@pytest.mark.parametrize("wave", [7, 132, 264])
def test_rows_walk_covers_every_logical_block_once(rows, n, wave):
    """A6's mask-mode grid takes at most ``wave`` blocks, every (row,
    logical block) exactly once, and each row's count adds cover its
    logical blocks."""
    from _torch_walk import agg_blocks, walk
    nblk = agg_blocks(n)
    blocks, tickets = walk(rows, nblk, wave)
    assert len(blocks) <= wave
    seen = sorted(L for _, ls in blocks for L in ls)
    assert seen == list(range(rows * nblk))
    for r in range(rows):
        assert sum(c for _, row, c in tickets if row == r) == nblk


@pytest.mark.parametrize("rows", [1, 3, 5])
@pytest.mark.parametrize("n", [37, 5000, 2 * 2048 + 16])
def test_rows_walk_transcription_equals_stacked_plain(rows, n):
    """Stacked K2 transcribed (each logical block's partial in the
    kernel's lane layout and fold order, the row fold in block order,
    float64 sums as 1,024-row nodes) equals its plain version bit for bit:
    int64, float64 with NaN and int32-code columns under an int64 and a
    float64 predicate, each row with its own bounds."""
    import torch
    from _torch_walk import rows_raw
    from repro_torch.kernels import spmd_ops as SO
    rng = np.random.default_rng(n + rows)
    ts = rng.integers(0, 10**9, (rows, n))
    xf = rng.normal(1e3, 3e2, (rows, n))
    xf[rng.random((rows, n)) < 0.01] = np.nan
    code = rng.integers(0, 50, (rows, n)).astype(np.int32)
    valid = [rng.random((rows, n)) < 0.9 for _ in range(3)]
    lo_t = 10**8 + 10**7 * np.arange(rows)
    hi_t = np.full(rows, 8 * 10**8)
    lo_f, hi_f = np.full(rows, 700.0), 1200.0 + 50.0 * np.arange(rows)
    pcols = [(torch.from_numpy(ts), torch.from_numpy(valid[0]), lo_t, hi_t),
             (torch.from_numpy(xf), torch.from_numpy(valid[1]), lo_f, hi_f)]
    acols = [(torch.from_numpy(ts), torch.from_numpy(valid[2])),
             (torch.from_numpy(xf), torch.from_numpy(valid[1])),
             (torch.from_numpy(code), torch.from_numpy(valid[0]))]
    praw, pmask = SO.filter_aggregate_rows_plain(pcols, acols, rows, n)
    mask = valid[0] & (ts >= lo_t[:, None]) & (ts <= hi_t[:, None]) \
        & valid[1] & (xf >= lo_f[:, None]) & (xf <= hi_f[:, None])
    raw = rows_raw(mask, [(x.numpy(), v.numpy()) for x, v in acols], rows,
                   n, [(int(m.sum()),) for m in mask])
    assert np.array_equal(mask, pmask)
    assert np.array_equal(raw, praw)


@pytest.mark.parametrize("rows,n", [
    (rows, n) for n in (592, 3 * 2048 + 16, 33 * 1024 + 16)
    for rows in (1, 3, 4, 5, 8)] + [(1, 264 * 2048 + 4096),
                                    (2, 264 * 2048 + 4096)])
def test_k2s_walk_transcription_equals_stacked_plain(rows, n):
    """The second stacked K2 design transcribed (``_torch_walk.k2s_walk``:
    G grid blocks a row, each a range of logical blocks and their chunks;
    blocks finishing in a random order, a ticket a chunk on its group of
    32 node sums) equals its plain version (NaN equal to NaN: torch's
    min / max give a NaN of their own bits) and, bit for bit, the first
    design's transcription: int64, float64 with NaN and int32-code
    columns, n off the 2,048-row chunk, off a group of 32 nodes and past
    264 chunks (logical blocks of two), an empty row, and every group
    folded once, by the block whose chunk completed it."""
    import torch
    from _torch_walk import GROUP_CHUNKS, k2s_grid, k2s_walk, rows_raw
    from repro_torch.kernels import selfcheck as SC
    from repro_torch.kernels import spmd_ops as SO
    rng = np.random.default_rng(n + rows)
    ts = rng.integers(0, 10**9, (rows, n))
    xf = rng.normal(1e3, 3e2, (rows, n))
    xf[rng.random((rows, n)) < 0.01] = np.nan
    code = rng.integers(0, 50, (rows, n)).astype(np.int32)
    valid = [rng.random((rows, n)) < 0.9 for _ in range(3)]
    if rows > 1:
        valid[2][-1] = False                     # an empty row
    lo_t = 10**8 + 10**7 * np.arange(rows)
    hi_t = np.full(rows, 8 * 10**8)
    pcols = [(torch.from_numpy(ts), torch.from_numpy(valid[0]), lo_t, hi_t)]
    acols = [(torch.from_numpy(ts), torch.from_numpy(valid[2])),
             (torch.from_numpy(xf), torch.from_numpy(valid[1])),
             (torch.from_numpy(code), torch.from_numpy(valid[2]))]
    praw, pmask = SO.filter_aggregate_rows_plain(pcols, acols, rows, n)
    mask = valid[0] & (ts >= lo_t[:, None]) & (ts <= hi_t[:, None])
    cols = [(x.numpy(), v.numpy()) for x, v in acols]
    counts = [(int(m.sum()),) for m in mask]
    raw, walks = k2s_walk(mask, cols, rows, n, counts, seed=n + rows)
    assert SC.raw_compare((raw, mask), (praw, pmask), [6, 7, 8]) == 0.0
    assert np.array_equal(raw, rows_raw(mask, cols, rows, n, counts))
    chunks = -(-n // 2048)
    per, G = k2s_grid(rows, n)
    assert G * rows <= 264 + rows and per * G >= min(chunks, 264)
    for took, finished, tickets in walks:
        assert sorted(c for t in took for c in t) == list(range(chunks))
        want = [min(GROUP_CHUNKS, chunks - g * GROUP_CHUNKS)
                for g in range(-(-chunks // GROUP_CHUNKS))]
        for lv, (fin, tk) in enumerate(zip(finished, tickets)):
            assert sorted(fin) == list(range(len(want))), lv
            assert [int(t) for t in tk] == want, lv
            want = [min(32, len(want) - g * 32)
                    for g in range(-(-len(want) // 32))]
        assert len(tickets[-1]) == 1
