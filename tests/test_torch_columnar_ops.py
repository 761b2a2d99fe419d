"""K1-K3 of the PyTorch port (``repro_torch.kernels.columnar_ops``) held
against the reference's exact x64 path (``force_pallas=False``) on the
same numpy inputs, and, on f32-exact integer inputs, against the Pallas
kernels in interpret mode.

On the CPU the port's wrappers run the kernels' plain versions; the CUDA
kernels themselves are held against those in test_torch_kernels_gpu.py.
The reference is imported under a test-side ``jax.experimental.
enable_x64`` shim (jax 0.9 dropped that name), which is removed again when
this module's tests end so other test files see the interpreter as it
was.
"""

import contextlib
import math
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro_torch  # noqa: E402
from repro_torch.kernels import columnar_ops as PK  # noqa: E402


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
def RK():
    with _reference_x64():
        from repro.kernels import columnar_ops
        yield columnar_ops


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _same(a, b, rel=0.0):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= rel * max(abs(a), abs(b))
    return a == b and type(a) is type(b)


def _assert_agg_equal(got, ref):
    assert got["count"] == ref["count"]
    assert got["cnts"] == ref["cnts"]
    for key, rel in (("sums", 1e-12), ("mins", 0.0), ("maxs", 0.0)):
        assert len(got[key]) == len(ref[key])
        for g, r in zip(got[key], ref[key]):
            assert _same(g, r, rel), (key, g, r)


def _case(kind, n, seed):
    """(preds, aggs, n) for one input family, from a fixed numpy seed."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.8
    if kind == "int64_big":
        x = rng.integers(-2 ** 40, 2 ** 40, n, dtype=np.int64)
        preds = [(x, valid, -2 ** 39, 2 ** 39 + 12345)]
        aggs = [(x, valid)]
    elif kind == "f64_nan":
        x = rng.normal(size=n)
        x[rng.random(n) < 0.1] = np.nan
        y = rng.integers(0, 100, n, dtype=np.int64)
        preds = [(y, valid, 10, 80)]
        aggs = [(x, valid), (y, np.ones(n, bool))]
    elif kind == "unbounded_floatbound":
        x = rng.integers(-50, 50, n, dtype=np.int64)
        y = rng.uniform(-1, 1, n)
        preds = [(x, valid, 2.5, None), (y, rng.random(n) < 0.9, None, 0.25)]
        aggs = [(y, valid), (x, valid)]
    elif kind == "int32_codes":
        x = rng.integers(0, 20, n).astype(np.int32)
        preds = [(x, valid, 3, 11)]
        aggs = [(x, valid)]
    elif kind == "bool_widened":
        x = (rng.random(n) < 0.5).astype(np.int64)
        z = rng.integers(0, 1000, n, dtype=np.int64)
        preds = [(x, valid, 1, 1), (z, valid, None, 700)]
        aggs = [(x, valid), (z, valid)]
    elif kind == "padded":
        np2 = 1 << int(n - 1).bit_length()
        x = np.zeros(np2, np.int64)
        x[:n] = rng.integers(0, 100, n)
        v = np.zeros(np2, bool)
        v[:n] = valid
        preds = [(x, v, 20, 60)]
        aggs = [(x, v)]
    else:
        raise AssertionError(kind)
    return preds, aggs, n


KINDS = ["int64_big", "f64_nan", "unbounded_floatbound", "int32_codes",
         "bool_widened", "padded"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 37, 1000, 4099])
def test_range_mask_matches_x64(RK, kind, n):
    preds, _, n = _case(kind, n, seed=n * 31 + len(kind))
    got = PK.range_mask(preds, n)
    ref = RK.range_mask(preds, n, force_pallas=False)
    assert got.dtype == bool and got.shape == (n,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 37, 1000, 4099])
def test_fused_filter_aggregate_matches_x64(RK, kind, n):
    preds, aggs, n = _case(kind, n, seed=n * 17 + len(kind))
    _assert_agg_equal(PK.fused_filter_aggregate(preds, aggs, n),
                      RK.fused_filter_aggregate(preds, aggs, n,
                                                force_pallas=False))


@pytest.mark.parametrize("variant", ["no_preds", "no_aggs", "neither",
                                     "empty"])
def test_fused_filter_aggregate_edges(RK, variant):
    rng = np.random.default_rng(5)
    n = 300
    x = rng.integers(-9, 9, n, dtype=np.int64)
    v = rng.random(n) < 0.7
    preds, aggs = [(x, v, -3, 4)], [(x, v), (x.astype(np.float64), v)]
    if variant == "no_preds":
        preds = []
    elif variant == "no_aggs":
        aggs = []
    elif variant == "neither":
        preds, aggs, n = [], [], 256
    else:
        n = 0
    _assert_agg_equal(PK.fused_filter_aggregate(preds, aggs, n),
                      RK.fused_filter_aggregate(preds, aggs, n,
                                                force_pallas=False))


def test_range_mask_edges(RK):
    x = np.arange(10, dtype=np.int64)
    v = np.ones(10, bool)
    assert PK.range_mask([(x, v, 1, 2)], 0).shape == (0,)
    np.testing.assert_array_equal(PK.range_mask([], 7),
                                  RK.range_mask([], 7, force_pallas=False))


@pytest.mark.parametrize("kind", ["int64_big", "f64", "mixed", "subset"])
@pytest.mark.parametrize("sizes", [(50, 20), (3000, 2000), (9000, 300)])
def test_sorted_intersect_matches_x64(RK, kind, sizes):
    n, m = sizes
    rng = np.random.default_rng(n + m + len(kind))
    if kind == "int64_big":
        keys = np.unique(rng.integers(-2 ** 45, 2 ** 45, n, dtype=np.int64))
        cands = np.unique(np.concatenate(
            [rng.choice(keys, m // 2),
             rng.integers(-2 ** 45, 2 ** 45, m - m // 2, dtype=np.int64)]))
    elif kind == "f64":
        keys = np.unique(rng.normal(size=n))
        cands = np.unique(np.concatenate([rng.choice(keys, m // 2),
                                          rng.normal(size=m - m // 2)]))
    elif kind == "mixed":                  # int64 keys, float64 cands
        keys = np.unique(rng.integers(0, 4 * n, n, dtype=np.int64))
        c = np.unique(rng.integers(0, 4 * n, m)).astype(np.float64)
        c[::4] += 0.5
        cands = np.unique(c)
    else:                                  # every third key a candidate
        keys = np.unique(rng.integers(0, 10 * n, n, dtype=np.int64))
        cands = keys[::3].copy()
    got = PK.sorted_intersect_mask(keys, cands)
    ref = RK.sorted_intersect_mask(keys, cands, force_pallas=False)
    assert got.shape == keys.shape
    np.testing.assert_array_equal(got, ref)


def test_sorted_intersect_empty(RK):
    k = np.arange(5, dtype=np.int64)
    for keys, cands in ((k, k[:0]), (k[:0], k)):
        np.testing.assert_array_equal(
            PK.sorted_intersect_mask(keys, cands),
            RK.sorted_intersect_mask(keys, cands, force_pallas=False))


def _merge_case(kind, seed):
    rng = np.random.default_rng(seed)
    comps = []
    for c in range(rng.integers(2, 5)):
        size = int(rng.integers(0, 60)) if c else int(rng.integers(1, 60))
        if kind == "object":
            a = np.array(sorted({f"k{int(v):04d}"
                                 for v in rng.integers(0, 120, size)}),
                         dtype=object)
        else:
            a = np.unique(rng.integers(0, 120, size)).astype(np.int64)
            if kind == "mixed" and c % 2:
                a = a.astype(np.float64)           # lossless promotion
            if kind == "lossy" and c == 1:
                a = a.astype(np.float64) + 0.5     # object-merge fallback
                a = np.concatenate([a, [2.0 ** 60]])
            if kind == "big":
                a = a + 2 ** 50
        comps.append(a)
    tombs = [rng.random(len(a)) < 0.3 for a in comps]
    return comps, tombs


@pytest.mark.parametrize("kind", ["int", "mixed", "lossy", "object", "big"])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_merge_take_matches_reference(RK, kind, drop, seed):
    comps, tombs = _merge_case(kind, seed * 7 + len(kind))
    got = PK.sorted_merge_take(comps, tombs, drop_tombstones=drop)
    ref = RK.sorted_merge_take(comps, tombs, drop_tombstones=drop,
                               force_pallas=False)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    got2 = PK.sorted_merge_take(comps)
    ref2 = RK.sorted_merge_take(comps, force_pallas=False)
    for g, r in zip(got2, ref2):
        np.testing.assert_array_equal(g, r)


def test_sorted_merge_take_all_empty(RK):
    z = [np.zeros(0, np.int64)] * 3
    for g, r in zip(PK.sorted_merge_take(z),
                    RK.sorted_merge_take(z, force_pallas=False)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_and_counts_match_pallas_interpret(RK, seed):
    """On f32-exact integer inputs the TPU kernels (interpret mode) give
    the same masks and counts as the port."""
    rng = np.random.default_rng(100 + seed)
    n = 700
    x = rng.integers(-1000, 1000, n, dtype=np.int64)
    y = rng.integers(0, 50, n, dtype=np.int64)
    v = rng.random(n) < 0.85
    preds = [(x, v, -200, 600), (y, np.ones(n, bool), 5, None)]
    np.testing.assert_array_equal(
        PK.range_mask(preds, n),
        RK.range_mask(preds, n, force_pallas=True, interpret=True))
    got = PK.fused_filter_aggregate(preds, [(y, v)], n)
    ref = RK.fused_filter_aggregate(preds, [(y, v)], n, force_pallas=True,
                                    interpret=True)
    assert got["count"] == ref["count"] and got["cnts"] == ref["cnts"]
    keys = np.unique(rng.integers(0, 5000, 600, dtype=np.int64))
    cands = np.unique(rng.integers(0, 5000, 200, dtype=np.int64))
    np.testing.assert_array_equal(
        PK.sorted_intersect_mask(keys, cands),
        RK.sorted_intersect_mask(keys, cands, force_pallas=True,
                                 interpret=True))


def test_trace_count_counts_first_sightings_only():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 10, 100, dtype=np.int64)
    preds = [(x, np.ones(100, bool), 2, 5)]
    PK.range_mask(preds, 100)
    t0 = PK.trace_count()
    PK.range_mask(preds, 100)
    PK.range_mask(preds, 90)            # same pow2 bucket
    assert PK.trace_count() == t0
    PK.range_mask([(x.astype(np.float64), np.ones(100, bool), 2, 5)], 100)
    assert PK.trace_count() == t0 + 1   # new dtype: one first sighting


@pytest.mark.parametrize("n,want", [(1, 1), (2048, 1), (2049, 2),
                                    (1 << 19, 256), ((1 << 19) + 3, 257),
                                    (1 << 22, 264), (1 << 30, 264)])
def test_k2_grid_rule(n, want):
    """K2's grid, and so its fold order, is a function of n alone: one
    8-row run a thread of 256, capped at the scratch's 264 blocks."""
    assert PK.agg_blocks(n) == want
