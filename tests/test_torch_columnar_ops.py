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
import torch  # noqa: E402
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


def _nib(w):
    """csrc/common.cuh's nib: 4 bytes of a uint32 -> 4 bits (byte i
    nonzero -> bit i)."""
    return sum(((w >> np.uint32(8 * i)) & np.uint32(0xFF) != 0)
               .astype(np.uint32) << np.uint32(i) for i in range(4))


def _k1_runs(cols, n, run=8, threads=256):
    """A transcription of csrc/range_mask.cu: passes of up to 8 columns;
    about one wave of warps, grid-stride over runs of 32 x ``run`` rows,
    lane i of a run rows 64 k + 2 i + e as mask bit 2 k + e; a full run
    stores its bits as 2-byte pairs o[32 q] from the lane's first row (a
    later pass first ANDs in the old bits, read as nib(o[64 q] |
    o[64 q + 32] << 16)), a partial run its rows below n one by one."""
    out = np.zeros(n + (n & 1), dtype=np.uint8)     # even: 2-byte view
    o16 = out.view(np.uint16)
    wrun = 32 * run
    wruns = -(-n // wrun)
    nwarps = max(1, min(-(-wruns // (threads // 32)), 132 * 8)) \
        * (threads // 32)
    b = np.arange(run)
    for g in range(0, len(cols), 8):
        for w in range(nwarps):
            for wr in range(w, wruns, nwarps):
                base = wr * wrun + 2 * np.arange(32)
                rows = base[:, None] + 64 * (b >> 1) + (b & 1)    # [32, run]
                r = np.minimum(rows, n - 1)
                ok = rows < n
                for x, v, lo, hi in cols[g:g + 8]:
                    ok &= (v[r] != 0) & (x[r] >= lo) & (x[r] <= hi)
                mask = (ok.astype(np.uint32) << b.astype(np.uint32)).sum(1)
                if wr * wrun + wrun <= n:
                    if g:
                        old = np.zeros(32, np.uint32)
                        for q in range(run // 4):
                            lo16 = o16[(base + 128 * q) // 2].astype(np.uint32)
                            hi16 = o16[(base + 128 * q + 64) // 2].astype(
                                np.uint32)
                            old |= _nib(lo16 | (hi16 << np.uint32(16))) \
                                << np.uint32(4 * q)
                        mask &= old
                    for q in range(run // 2):
                        o16[(base + 64 * q) // 2] = \
                            ((mask >> np.uint32(2 * q)) & 1) \
                            | (((mask >> np.uint32(2 * q + 1)) & 1) << 8)
                else:
                    for i in range(32):
                        for bit in range(run):
                            row = rows[i, bit]
                            if row < n:
                                m = bool((mask[i] >> bit) & 1)
                                out[row] = (out[row] != 0 and m) if g else m
    return out[:n].astype(bool)


@pytest.mark.parametrize("kind", KINDS + ["nine_columns"])
@pytest.mark.parametrize("n", [1, 37, 1000, 4099, 8193])
def test_range_mask_runs_transcription(RK, kind, n):
    """K1's runs and passes, transcribed, against the plain version and
    the reference's x64 path: partial runs, 2-byte pair stores, and nine
    predicates as a pass of eight then one ANDed in."""
    if kind == "nine_columns":
        cases = [_case(k, n, seed=n + i)[0]
                 for i, k in enumerate(KINDS + ["int64_big"])]
        preds = [p for ps in cases for p in ps][:9]
        assert len(preds) == 9
    else:
        preds, _, n = _case(kind, n, seed=n * 7 + len(kind))
    np2 = max(PK._pow2_len(n), max(int(p[0].shape[0]) for p in preds))
    cols = []
    for p in preds:
        x, v, lo, hi = PK._pad_pred(p, np2)
        blo, bhi = PK._prep_bounds(x, lo, hi)
        x = PK._kernel_array(x)
        cols.append((x, v, blo.astype(x.dtype), bhi.astype(x.dtype)))
    got = _k1_runs(cols, np2)
    plain = PK.range_mask_plain(
        [(torch.from_numpy(x), torch.from_numpy(v), lo, hi)
         for x, v, lo, hi in cols], np2).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        got[:n], RK.range_mask(preds, n, force_pallas=False))


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


# ---------------------------------------------------------------------------
# K3's tiling (csrc/sorted_intersect.cu), transcribed to settle it here
# ---------------------------------------------------------------------------

def _narrow(a, b, s, cnt):
    """``narrow``: the probes a + t*s for t < cnt held c < x, the one at
    t = cnt failed or left [a, b)."""
    if a < b:
        hi = min(a + cnt * s, b)
        a, b = (a + (cnt - 1) * s + 1, hi) if cnt else (a, a)
    return a, b


def _k3_window(c, lo, hi, probes, stage):
    """The kernel's window search: a first round of ``probes`` probes at
    fixed places over all of ``c``, then rounds over both brackets while
    [a0, b1] exceeds the stage and a bracket is open.  Returns (L, H,
    rounds)."""
    m = c.shape[0]
    brackets = [[0, m], [0, m]]
    rounds = 0
    while True:
        for br, x in zip(brackets, (lo, hi)):
            s = -(-(br[1] - br[0]) // probes) if rounds else -(-m // probes)
            i = br[0] + np.arange(probes) * s
            p = i < br[1]
            p[p] = c[i[p]] < x
            cnt = int(p.sum())
            assert p[:cnt].all()         # the probes below x are a prefix
            br[:] = _narrow(br[0], br[1], s, cnt)
        rounds += 1
        (a0, b0), (a1, b1) = brackets
        H = b1 + 1 if b1 < m else m
        if H - a0 <= stage or (a0 >= b0 and a1 >= b1):
            return a0, max(H, a0), rounds


def _k3_tiles(keys, n, cands, tile, probes, stage):
    """A transcription of ``sorted_intersect_tile_kernel``: per tile of
    ``tile`` keys, a window that holds lb(first) to lb(last) by block-wide
    probes, walked in chunks of ``stage`` candidates with the kernel's
    halving search; keys outside [first, last] searched over all
    candidates.  Returns (mask over keys, counts of what ran)."""
    m = cands.shape[0]
    out = np.zeros(keys.shape[0], dtype=bool)
    ran = {"tiles": 0, "chunks": 0, "outside": 0, "global": 0, "rounds": 0}
    for t0 in range(0, n, tile):         # tiles past n are written false
        t_end = min(t0 + tile, n)
        k = keys[t0:t_end]
        lo, hi = keys[t0], keys[t_end - 1]
        L, H, rounds = _k3_window(cands, lo, hi, probes, stage)
        ran["tiles"] += 1
        ran["rounds"] = max(ran["rounds"], rounds)
        ran["outside"] += bool(m and (lo > cands[-1] or hi < cands[0]))
        cov = (lo <= k) & (k <= hi)
        hit = np.zeros(k.shape[0], dtype=bool)
        for cs in range(L, H, stage):
            win = cands[cs:min(cs + stage, H)]
            at = np.zeros(k.shape[0], dtype=np.int64)
            w = win.shape[0]             # the last candidate <= each key
            while w > 1:
                half = w >> 1
                at = np.where(win[at + half] <= k, at + half, at)
                w -= half
            hit |= cov & (win[at] == k)
            ran["chunks"] += 1
        for j in np.flatnonzero(~cov):   # from global memory
            a, b = 0, m
            while a < b:
                mid = a + ((b - a) >> 1)
                a, b = (mid + 1, b) if cands[mid] < k[j] else (a, mid)
            hit[j] = a < m and cands[a] == k[j]
            ran["global"] += 1
        out[t0:t_end] = hit
    return out, ran


# (n, m, tile, probes, stage): the kernel's own tiling, and a small one
# whose windows span many tiles and chunks
K3_TILINGS = [(5000, 60_000, 1024, 512, 4096), (300, 4000, 16, 4, 8)]


@pytest.mark.parametrize("cands,dtype", [
    ("subset", np.int64), ("wide", np.int64), ("gaps", np.int64),
    ("subset", np.float64), ("wide", np.float64), ("shuffled", np.int64)])
@pytest.mark.parametrize("pad", [False, True])
def test_sorted_intersect_tiling_transcription(RK, cands, dtype, pad):
    """The tiling of csrc/sorted_intersect.cu, transcribed, against the
    plain version and the reference's x64 path on the GPU tests' inputs
    (``selfcheck.k3_arrays``): tile edges with n not a multiple of the
    tile, the window search, chunked windows, tiles past every
    candidate, edge padding on both sides, keys out of order (plain version only: the reference's
    x64 path needs sorted keys)."""
    from repro_torch.kernels import selfcheck as SC
    import torch
    for n0, m0, tile, probes, stage in K3_TILINGS:
        m0 = min(m0, n0) if cands == "subset" else m0
        keys, n, cs = SC.k3_arrays(n0, m0, n0 + m0, dtype, cands, pad)
        got, ran = _k3_tiles(keys, n, cs, tile, probes, stage)
        plain = PK.sorted_intersect_plain(torch.from_numpy(keys), n,
                                          torch.from_numpy(cs)).numpy()
        np.testing.assert_array_equal(got, plain)
        assert got[n:].sum() == 0
        if cands != "shuffled":
            np.testing.assert_array_equal(got[:n], RK.sorted_intersect_mask(
                keys[:n], cs, force_pallas=False))
        assert ran["tiles"] == -(-n // tile)
        assert ran["rounds"] <= math.ceil(math.log(max(cs.shape[0], 2),
                                                   probes)) + 1
        if cands == "wide":              # windows of many chunks
            assert ran["chunks"] > 2 * ran["tiles"]
        if cands == "gaps":             # tiles past or before every cand
            assert ran["outside"] > 0
        if cands == "shuffled":
            assert ran["global"] > 0
        else:
            assert ran["global"] == 0


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


# ---------------------------------------------------------------------------
# more than 8 predicate columns (K2, stacked K2 and A6 fold the ones past
# slot 7 into slot 7's validity with K1)
# ---------------------------------------------------------------------------

def _wide_preds(rng, k, n):
    """``k`` int64 and float64 predicate columns (NaN in the floats) of
    which the conjunction keeps some rows."""
    out = []
    for j in range(k):
        if j % 3 == 2:
            x = rng.normal(0.0, 1.0, n)
            x[rng.random(n) < 0.02] = np.nan
            out.append((x, rng.random(n) < 0.97, -2.0, None))
        else:
            x = rng.integers(0, 100, n, dtype=np.int64)
            out.append((x, rng.random(n) < 0.97, 3, 98))
    return out


@pytest.mark.parametrize("k", [9, 17])
@pytest.mark.parametrize("n", [37, 4099])
def test_fused_filter_aggregate_wide_matches_x64(RK, k, n):
    rng = np.random.default_rng(k * n)
    preds = _wide_preds(rng, k, n)
    aggs = [(preds[0][0], preds[0][1]), (rng.normal(size=n),
                                         rng.random(n) < 0.9)]
    got = PK.fused_filter_aggregate(preds, aggs, n)
    assert got["count"] > 0
    _assert_agg_equal(got, RK.fused_filter_aggregate(preds, aggs, n,
                                                     force_pallas=False))


def test_float64_sum_of_17_to_31_rows_matches_x64_bits(RK):
    """K2's float64 sum over 17-31 rows, bit for bit against the
    reference's x64 path, which pads them to 32 and masks the padding with
    its live-row predicate (``columnar_ops.sum32_unroll`` at K = 1).
    ``_assert_agg_equal`` allows sums 1e-12 apart, so it cannot see
    this."""
    differ = []
    for n in (17, 20, 24, 29, 31):
        for seed in range(4):
            x = np.random.default_rng(seed).standard_normal(n) * 100.0
            aggs = [(x, np.ones(n, bool))]
            got = PK.fused_filter_aggregate([], aggs, n)["sums"][0]
            ref = RK.fused_filter_aggregate([], aggs, n,
                                            force_pallas=False)["sums"][0]
            if got != ref:
                differ.append((n, seed, got, ref))
    assert not differ, differ


def _loose_preds(rng, k, n):
    """``k`` predicate columns of int64, int32 and float64 values (NaN in
    the floats) that keep most rows, so that a sum has many terms."""
    out = []
    for j in range(k):
        valid = rng.random(n) < 0.95
        if j % 3 == 0:
            out.append((rng.integers(0, 100, n, dtype=np.int64), valid, 2,
                        None))
        elif j % 3 == 1:
            out.append((rng.integers(0, 50, n).astype(np.int32), valid,
                        None, 48))
        else:
            x = rng.standard_normal(n)
            x[rng.random(n) < 0.02] = np.nan
            out.append((x, valid, -3.0, None))
    return out


@pytest.mark.parametrize("n", [17, 24, 31, 32])
@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 8, 9, 15, 16, 17, 24])
def test_float64_sum_at_32_slots_matches_x64_bits(RK, k, n):
    """K2's plain version at a padded length of 32 under ``k`` predicate
    columns (the live-row predicate adds one where ``k`` = 0 and n < 32),
    bit for bit against the reference's x64 path: the four-lane,
    U-accumulator order of ``columnar_ops.sum32_unroll`` (U = 4, 2, 1, 4
    as K grows), and the window order with no predicate at n = 32.  Four
    draws a case, two float64 aggregate columns and an int64 one."""
    for seed in range(4):
        rng = np.random.default_rng(1000 * k + 10 * n + seed)
        preds = _loose_preds(rng, k, n)
        aggs = [(rng.standard_normal(n) * 100.0, rng.random(n) < 0.9),
                (rng.integers(-50, 50, n, dtype=np.int64),
                 np.ones(n, bool)),
                (rng.standard_normal(n) * 1e6, np.ones(n, bool))]
        got = PK.fused_filter_aggregate(preds, aggs, n)
        ref = RK.fused_filter_aggregate(preds, aggs, n, force_pallas=False)
        assert got["count"] == ref["count"] and got["count"] > 0
        assert got["cnts"] == ref["cnts"]
        for key in ("sums", "mins", "maxs"):
            assert [repr(v) for v in got[key]] == \
                [repr(v) for v in ref[key]], (key, seed)


def test_sum32_order_table():
    """``sum32_unroll``: the order only at a padded length of 32 with a
    predicate, U = 4, 4, 2, 2 for K = 1-4, 1 for K = 5-15 and 4 from 16
    on; ``sum32`` at U = 1 is four strided lanes."""
    assert [PK.sum32_unroll(32, k) for k in range(0, 26)] == \
        [0, 4, 4, 2, 2] + [1] * 11 + [4] * 10
    assert PK.sum32_unroll(16, 3) == PK.sum32_unroll(64, 3) == 0
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(32))
    lanes = [0.0] * 4
    for i, v in enumerate(x.tolist()):
        lanes[i % 4] = lanes[i % 4] + v
    want = (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])
    assert PK.sum32(x, 1).item() == want
    assert PK.masked_sum(x, 0).item() == PK.tree_sum(x).item()


@pytest.mark.parametrize("k", [1, 8, 9, 17])
@pytest.mark.parametrize("rows", [0, 3])
def test_fold_extra_preds_keeps_the_conjunction(k, rows):
    """``fold_extra_preds`` with the plain K1 (stacked K1 for ``rows`` > 0)
    as its mask: at most 8 slots, slots 0-6 the columns themselves, and
    the slots' conjunction, and so K2's plain result, equal to that of
    all ``k`` columns; up to 8 columns nothing is folded."""
    from repro_torch.kernels import spmd_ops as SO
    rng = np.random.default_rng(k + rows)
    n = 1000
    cols = []
    for x, v, lo, hi in _wide_preds(rng, k, n * max(rows, 1)):
        x, v = torch.from_numpy(x), torch.from_numpy(v)
        blo, bhi = PK._prep_bounds(x.numpy(), lo, hi)
        if rows:
            cols.append((x.view(rows, n), v.view(rows, n),
                         np.full(rows, blo), np.full(rows, bhi)))
        else:
            cols.append((x, v, blo, bhi))
    if rows:
        def mask(c):
            return SO.range_mask_rows_plain(c, rows, n)
    else:
        def mask(c):
            return PK.range_mask_plain(c, n)
    folded = PK.fold_extra_preds(cols, mask)
    assert len(folded) == min(k, 8)
    assert all(f is c for f, c in zip(folded[:7], cols))
    if k <= 8:
        assert all(f is c for f, c in zip(folded, cols))
    assert torch.equal(mask(folded), mask(cols))
    assert mask(cols).any()
    if not rows:
        agg = [(cols[0][0], cols[0][1], None, None)]
        dev = torch.device("cpu")
        assert PK.filter_aggregate_plain(folded, agg, n, dev) == \
            PK.filter_aggregate_plain(cols, agg, n, dev)
