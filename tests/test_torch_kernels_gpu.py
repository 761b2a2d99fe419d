"""The PyTorch port's CUDA kernels (K1-K9, A7, and rungs 3 and 4: A6,
stacked K1 and K2, the exchange and the merges) against their plain
PyTorch versions on the card, at small shapes and at the main paths' shapes, and
the port's query and model serving paths on the card against the same
paths on the CPU.

Marked ``gpu``: every test needs a CUDA device and ``nvcc`` and skips
without one.  Run on the card with
``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
"""

import pytest
import torch

import repro_torch
from repro_torch.kernels import selfcheck as SC

from _torch_doubles import DOUBLE_SIZES

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested on the CPU)")
    repro_torch.set_device("cuda")
    yield torch.device("cuda", 0)
    repro_torch.set_device("cpu")


SMALL_N = [1, 37, 1000, 70_001]


@pytest.mark.parametrize("n", SMALL_N)
@pytest.mark.parametrize("kinds", [["ts"], ["id", "f64"], ["code", "ts"],
                                   ["id", "ts", "f64", "code"] * 3])
def test_range_mask_kernel(dev, n, kinds):
    r = SC.run_case(SC.k1_case(n, kinds, seed=n, dev=dev), timed=False)
    assert r["ok"], r


# K = 1, 2 (every column's loads in flight) and 9 (a pass of 8 columns,
# two in flight, then one ANDed into the mask); "nan" rows are NaN every
# third row, valid every other row
K1_KINDS = [["ts"], ["nan", "code"],
            ["id", "ts", "f64", "code", "nan", "id", "ts", "f64", "code"]]


@pytest.mark.parametrize("n", [15, 16, 17, 255, 256, 257, 511, 512, 513,
                               (1 << 19) + 3])
@pytest.mark.parametrize("kinds", K1_KINDS)
def test_range_mask_run_edges(dev, n, kinds):
    """Runs of 32 x 8 rows a warp: a partial run's rows load and store
    one by one, whole runs as vectors."""
    r = SC.run_case(SC.k1_case(n, kinds, seed=n + len(kinds), dev=dev),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("offset", [(1, 1), (1, 0), (0, 1), (0, 8), (2, 8)])
@pytest.mark.parametrize("n", [17, 70_001])
@pytest.mark.parametrize("kinds", K1_KINDS)
def test_range_mask_offset_views(dev, offset, n, kinds):
    """Columns whose data (in elements) and validity (in bytes) start off
    their storage, as contiguous views do: int64 data 8 bytes and validity
    1 byte off a 16-byte boundary load their rows one by one; 16-byte
    aligned data and 2-byte aligned validity still load as vectors."""
    r = SC.run_case(SC.k1_case(n, kinds, seed=n, dev=dev, offset=offset),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("n", SMALL_N)
@pytest.mark.parametrize("preds,aggs", [
    (["ts", "id"], ["id", "f64"]), ([], ["f64", "code"]), (["code"], []),
    (["f64"], ["id", "ts", "f64", "code"] * 3)])
def test_filter_aggregate_kernel(dev, n, preds, aggs):
    r = SC.run_case(SC.k2_case(n, preds, aggs, seed=n + 1, dev=dev),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("sizes", [(1, 1), (50, 20), (5000, 64),
                                   (100_000, 30_000)])
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_sorted_intersect_kernel(dev, sizes, dtype):
    n, m = sizes
    r = SC.run_case(SC.k3_case(n, m, seed=n + m, dev=dev, dtype=dtype),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("sizes", [(1, 1), (2049, 2048), (5000, 200_000),
                                   (70_001, 3000)])
@pytest.mark.parametrize("cands", ["subset", "wide", "gaps"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
@pytest.mark.parametrize("pad", [False, True])
def test_sorted_intersect_tiles(dev, sizes, cands, dtype, pad):
    """K3's tiles and windows: candidates that are the keys' subset (the
    merge), drawn independently of them (PK bitmaps: a window up to ~40
    tiles of 1,024 keys wide at 5,000 keys over 200,000 candidates) or in
    two narrow stretches (tiles that hold none, tiles past every
    candidate); n not a multiple of the tile; both arrays edge-padded to
    pow2 as the device pool pads them."""
    n, m = sizes
    m = min(m, n) if cands == "subset" else m
    r = SC.run_case(SC.k3_case(n, m, seed=n + m, dev=dev, dtype=dtype,
                               cands=cands, pad=pad), timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("sizes", [(40, 30), (5000, 9000)])
def test_sorted_intersect_shuffled_keys(dev, sizes):
    """Keys out of order (outside K3's contract): a key outside its tile's
    [first, last] is searched from global memory, so the mask stays
    exact."""
    n, m = sizes
    r = SC.run_case(SC.k3_case(n, m, seed=n, dev=dev, cands="shuffled",
                               pad=True), timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("threshold", [1, 2, 3])
@pytest.mark.parametrize("sizes,tiers", [((8, 8), 1), ((1000, 3000), 4),
                                         ((64_000, 40_000), 40)])
def test_t_occurrence_kernel(dev, threshold, sizes, tiers):
    n, m = sizes
    r = SC.run_case(SC.k4_case(n, m, threshold, seed=n + threshold, dev=dev,
                               tiers=tiers), timed=False)
    assert r["ok"], r


# K4's sorted row-tile kernel (T > 1): (n, n_out, segments, positions a
# segment, position range before the offset, offsets, distinct positions)
K4_SORTED = {
    "duplicates": (5000, 8192, 8, 4000, (0, 5000), (0,), False),
    "one_segment": (3000, 4096, 1, 2500, (0, 3000), (0,), False),
    "40_segments": (20000, 32768, 40, 15000, (0, 20000), (0,), True),
    "120_segments": (3000, 4096, 120, 2000, (0, 3000), (0,), True),
    "outside_rows": (2000, 2048, 6, 1500, (-500, 2600), (-300, 0, 700),
                     False),
    "ragged_tile": (1000, 1024, 16, 900, (0, 1000), (0,), True),
    "wide_n_out": (300, 4096, 5, 250, (0, 300), (0,), True),
    "skewed": (30000, 32768, 12, 6000, (0, 30000), (0,), False),
    "skewed_120": (3000, 4096, 120, 1500, (0, 3000), (0,), False),
}


def _k4_sorted_parts(kind, seed):
    """Host (positions, start, stop, offset) of one K4_SORTED case: each
    segment a slice (start > 0 past a few leading positions) of a sorted
    array, an empty slice among them."""
    import numpy as np
    n, _, nseg, per, (lo, hi), offs, distinct = K4_SORTED[kind]
    rng = np.random.default_rng(seed)
    parts = []
    for j in range(nseg):
        if distinct:
            pos = rng.choice(np.arange(lo, hi), min(per, hi - lo), False)
        elif kind.startswith("skewed"):  # 90% of hits in the first 5% of rows
            head = rng.integers(lo, lo + (hi - lo) // 20, per * 9 // 10)
            pos = np.concatenate([head, rng.integers(lo, hi, per // 10)])
        else:
            pos = rng.integers(lo, hi, per)
        pos = np.sort(pos.astype(np.int64))
        a = int(rng.integers(0, 5))
        b = a if j == nseg // 2 and nseg > 1 else int(pos.shape[0])
        parts.append((pos, a, b, int(offs[j % len(offs)])))
    return parts


@pytest.mark.parametrize("kind", list(K4_SORTED))
@pytest.mark.parametrize("threshold", [2, 3, 7, "above"])
def test_t_occurrence_sorted_kernel(dev, kind, threshold):
    """K4 at T > 1 over sorted segments, one launch of the row-tile
    kernel: duplicate positions, 1, 40 and 120 segments (past the 96 the
    parameters hold: the table goes to the device), positions outside
    [0, n) after their offsets, n not a multiple of the tile, n_out far
    past n, hits crowded into a few tiles (the interpolated windows miss
    rows; with 120 such segments a tile's misses overflow their list and
    the tile is counted exactly), T above the segment count; and the same
    segments unmarked, which take the scatter kernel."""
    from repro_torch.kernels import fuzzy_ops as FO
    n, n_out, nseg = K4_SORTED[kind][:3]
    T = nseg + 1 if threshold == "above" else threshold
    parts = _k4_sorted_parts(kind, seed=nseg + T)
    for sorted_ in (True, False):
        case = SC._k4(SC.dev_segments(parts, dev, sorted_), n, n_out, T,
                      kind)
        r = SC.run_case(case, timed=False)
        assert r["ok"], r
        before = (FO.tocc_cuda.launches, FO.tocc_cuda.launches_sorted)
        case["run"]()
        torch.cuda.synchronize()
        assert FO.tocc_cuda.launches == before[0] + 1
        assert FO.tocc_cuda.launches_sorted == before[1] + sorted_


# K5 queries: the word boundaries of the bit-parallel kernel (32 and 64
# code points) and past them (the DP); repeated characters, Latin-1 and
# CJK code points (the Peq hash)
def _k5_query(m, kind, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "cjk":               # m distinct code points above 255
        return "".join(chr(0x4E00 + 37 * k) for k in rng.permutation(m))
    return "".join(rng.choice(list("Uab é中"), m))


@pytest.mark.parametrize("m", [0, 1, 15, 31, 32, 33, 63, 64, 65, 100])
@pytest.mark.parametrize("L", [2, 9, 40, 130])
@pytest.mark.parametrize("kind", ["mixed", "cjk"])
def test_edit_distance_bit_parallel(dev, m, L, kind):
    """K5 against its plain DP at every d in (0, 1, 3, 1000): candidates
    shorter and longer than the query, empty ones, rows of 2 code points
    (no 16-byte vectors) up to 130 (several chunks)."""
    import numpy as np
    query = _k5_query(m, kind, seed=m + L)
    rng = np.random.default_rng(m * L + 1)
    strs = SC._random_strings(rng, 300, L, "Uab é中一严") + [
        "", query[:L]]
    for d in (0, 1, 3, 1000):
        r = SC.run_case(SC.k5_case(strs, query, d, dev), timed=False)
        assert r["ok"], r


@pytest.mark.parametrize("B,L", [(1, 0), (5, 3), (33, 20), (1000, 70)])
@pytest.mark.parametrize("query", ["", "Nmb", "User Number 123",
                                   "é" * 63, "User Number 123" * 5])
def test_edit_distance_kernel(dev, B, L, query):
    """Empty strings and query, d = 0, non-ASCII code points, strings
    longer than the query, and queries past the shared-memory row (the
    scratch path)."""
    import numpy as np
    strs = SC._random_strings(np.random.default_rng(B + L), B, L)
    for d in (0, 1, 3, 1000):
        r = SC.run_case(SC.k5_case(strs, query, d, dev), timed=False)
        assert r["ok"], r


@pytest.mark.parametrize("P,s1,s2,vocab", [(1, 1, 1, 4), (17, 5, 9, 50),
                                           (1000, 32, 16, 1 << 40),
                                           (5000, 64, 128, 300)])
def test_set_intersect_kernel(dev, P, s1, s2, vocab):
    r = SC.run_case(SC.k6_case(P, s1, s2, vocab, seed=P, dev=dev),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("P,s1,s2", [(3, 1, 1), (999, 33, 1),
                                     (1001, 67, 67), (257, 5, 67),
                                     (130, 1500, 67), (40, 16, 10_000),
                                     (16, 8, 60_000)])
@pytest.mark.parametrize("unsorted_a", [False, True])
@pytest.mark.parametrize("lens", ["subset", "edge"])
@pytest.mark.parametrize("vocab", [1 << 20, 1 << 41])
def test_set_intersect_batches(dev, P, s1, s2, unsorted_a, lens, vocab):
    """K6's batches: odd S2 (67, 1), P not a multiple of the batch, a rows
    longer than a round of items (S1 = 1,500), a b row staged past 48 KB
    (S2 = 10,000) and one too wide to stage (S2 = 60,000: searched from
    global memory), unsorted a rows, lengths of 0 and above S1, codes
    below 2**21 and above 2**40."""
    r = SC.run_case(SC.k6_case(P, s1, s2, vocab, seed=P + s2, dev=dev,
                               unsorted_a=unsorted_a, lens=lens),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("P,s1,s2", [(1001, 67, 67), (6, 3, 5)])
def test_set_intersect_unaligned_views(dev, P, s1, s2):
    """Operands that start 8 bytes off a 16-byte boundary, as a view one
    row into its storage gives them (odd row widths): every batch's b span
    peels its first element (and an odd tail its last)."""
    r = SC.run_case(SC.k6_case(P, s1, s2, 1 << 20, seed=P, dev=dev,
                               offset=True), timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("R,W,P", [(1, 1, 1), (7, 3, 50), (1000, 32, 5000),
                                   (64, 100, 3000)])
def test_bitset_intersect_kernel(dev, R, W, P):
    r = SC.run_case(SC.a7_case(R, W, P, 0.3, seed=R, dev=dev), timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("W", [1, 3, 32, 100])
@pytest.mark.parametrize("one_row", [False, True])
def test_bitset_intersect_widths(dev, W, one_row):
    """Groups of 1 to 8 lanes a pair over 16-byte chunks (W = 32, and 100
    with its 25 chunks in a loop) or words (W = 1, 3); every pair on one
    row as well as uniform pairs."""
    r = SC.run_case(SC.a7_case(777, W, 4099, 0.4, seed=W, dev=dev,
                               one_row=one_row), timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("records", [300, 3500])
def test_bitset_intersect_clustered_order(dev, records):
    """The clustered FuzzyJoin's candidate order: a record's pairs in a
    run, its partners inside its cluster of 100."""
    r = SC.run_case(SC.a7_clustered_case(records, seed=records, dev=dev),
                    timed=False)
    assert r["ok"], r


def test_bitset_intersect_large_matrix(dev):
    """A record matrix of 8 MB (2**16 rows of W = 32), past any on-chip
    memory, with pairs drawn over all of it."""
    r = SC.run_case(SC.a7_case(1 << 16, 32, 100_003, 0.2, seed=3, dev=dev),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("P", [1, 33, 1001, 38_512])
def test_bitset_intersect_counts_live_pairs(dev, P):
    """Through the wrapper: P live pairs (not a power of two) over pooled
    index buffers padded to 2**k, counted on the card, equal numpy's
    popcount of the ANDed rows."""
    import numpy as np
    from repro_torch.kernels import fuzzy_ops as FO
    rng = np.random.default_rng(P)
    R = 1500
    bits = rng.integers(0, 2 ** 32, (R, 4), dtype=np.uint64).astype(
        np.uint32)
    ai, bi = rng.integers(0, R, P), rng.integers(0, R, P)
    before = SC.launch_counts()["bitset_intersect_counts"]
    got = FO.bitset_intersect_counts(bits, ai, bi)
    want = np.unpackbits((bits[ai] & bits[bi]).view(np.uint8),
                         axis=1).sum(1)
    assert got.shape == (P,)
    np.testing.assert_array_equal(got, want)
    assert SC.launch_counts()["bitset_intersect_counts"] == before + 1


@pytest.mark.parametrize("i", range(15))
def test_main_path_shapes(dev, i):
    r = SC.run_case(SC.main_path_cases(dev)[i], timed=False)
    assert r["ok"], r


def test_query_path_on_card_equals_cpu(dev):
    """TinySocial ingested and queried on the card gives the rows, the
    stored records and the engine accounting of the same run on the
    CPU."""
    import datetime as dt
    from repro_torch.configs.tinysocial import build_dataverse
    from repro_torch.core import algebra as A
    from repro_torch.storage.query import run_query
    lo = dt.datetime(2014, 2, 1)
    plans = [
        A.select(A.scan("MugshotMessages"),
                 pred=lambda r: r["timestamp"] >= lo, fields=["timestamp"],
                 ranges={"timestamp": (lo, dt.datetime(2015, 1, 1))}),
        A.aggregate(A.select(A.scan("MugshotMessages"),
                             pred=lambda r: r["timestamp"] >= lo,
                             fields=["timestamp"],
                             ranges={"timestamp": (lo, None)},
                             ranges_exact=True, hints=["skip-index"]),
                    {"c": ("count", "*"), "s": ("sum", "author-id")}),
        A.select(A.scan("MugshotMessages"),
                 pred=lambda r: r["timestamp"] >= lo, fields=["timestamp"],
                 ranges={"timestamp": (lo, None)}, hints=["skip-index"]),
    ]
    from repro_torch.columnar import plancache
    out = {}
    # the per-operator chain (the fused one has its own test below), so
    # the index probe launches K4
    plancache.set_enabled(False)
    try:
        for name in ("cuda", "cpu"):
            repro_torch.set_device(name)
            _, ds = build_dataverse(400, 6000, num_partitions=3,
                                    flush_threshold=100)
            res = []
            for plan in plans:
                rows, ex = run_query(plan, ds, vectorize=True)
                res.append((sorted(repr(sorted(r.items())) for r in rows),
                            ex.stats.rows_fallback,
                            ex.stats.rows_vectorized))
            res.append(sorted(repr(sorted(r.items()))
                              for r in ds["MugshotMessages"].scan()))
            out[name] = res
    finally:
        repro_torch.set_device("cuda")
        plancache.set_enabled(True)
    assert out["cuda"] == out["cpu"]
    counts = SC.launch_counts()
    for k in ("range_mask", "fused_filter_aggregate", "sorted_intersect_mask",
              "t_occurrence_mask"):
        assert counts[k] > 0, k


@pytest.mark.parametrize("n,parts", DOUBLE_SIZES)
def test_double_aggregates_on_card_equal_cpu_bits(dev, n, parts):
    """sum, avg, min and max of a DOUBLE field on the card (K2, its
    float64 sums folded in the reference's window order) equal the CPU
    port's (the plain version, in the same order) by exact repr."""
    import types
    from _torch_doubles import double_dataset, double_plans
    from repro_torch.core import adm, algebra
    from repro_torch.storage import dataset
    from repro_torch.storage.query import run_query
    pkg = types.SimpleNamespace(adm=adm, dsm=dataset, A=algebra)
    out = {}
    SC.reset_launch_counts()
    for name in ("cuda", "cpu"):
        repro_torch.set_device(name)
        ds = double_dataset(pkg, n, parts)
        out[name] = [repr(run_query(p, ds, vectorize=True)[0])
                     for p in double_plans(algebra).values()]
    repro_torch.set_device("cuda")
    assert out["cuda"] == out["cpu"]
    assert SC.launch_counts()["fused_filter_aggregate"] > 0


def test_fuzzy_path_on_card_equals_cpu(dev):
    """Fuzzy selects, a fuzzy keyword probe and FuzzyJoin on the card give
    the rows, pairs and accounting of the same run on the CPU."""
    from repro_torch.configs.tinysocial import build_dataverse
    from repro_torch.core import algebra as A
    from repro_torch.data.dedup import FuzzyJoin
    from repro_torch.fuzzy import fuzzy_predicate
    from repro_torch.storage.query import run_query
    specs = [("name", "ed", "User Number 123", 1),
             ("name", "ed", "User Number 123", 3),
             ("name", "jaccard", "User Number 123", 0.8)]
    plans = [A.select(A.scan("MugshotUsers"), pred=fuzzy_predicate(s),
                      fields=["name"], fuzzy=s) for s in specs]
    plans.append(A.select(A.scan("MugshotUsers"), pred=lambda r: True,
                          fields=["alias"], keyword=("alias", "user12", 1)))
    recs = [(i, {f"t{(i * 7 + j) % 97}" for j in range(12)})
            for i in range(300)]
    wide = [(i, {f"w{i // 10}_{j}" for j in range(300)}
             | {f"u{i}_{j}" for j in range(120)}) for i in range(300)]
    out = {}
    SC.reset_launch_counts()
    for name in ("cuda", "cpu"):
        repro_torch.set_device(name)
        _, ds = build_dataverse(3000, 100, num_partitions=3,
                                flush_threshold=512)
        ds["MugshotUsers"].create_index("name", kind="ngram")
        ds["MugshotUsers"].create_index("alias", kind="keyword")
        res = []
        for plan in plans:
            rows, ex = run_query(plan, ds, vectorize=True)
            res.append((sorted(repr(sorted(r.items())) for r in rows),
                        ex.stats.rows_fallback, ex.stats.rows_fuzzy_vectorized))
        res.append(FuzzyJoin(threshold=0.5).run(recs))
        res.append(FuzzyJoin(threshold=0.3).run(wide))
        out[name] = res
    repro_torch.set_device("cuda")
    assert out["cuda"] == out["cpu"]
    counts = SC.launch_counts()
    for k in ("t_occurrence_mask", "edit_distances", "set_intersect_counts",
              "bitset_intersect_counts"):
        assert counts[k] > 0, k


# ---------------------------------------------------------------------------
# the model stack: K7 rmsnorm, K8 flash attention, K9 LSM decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,d", [(1, 16), (3, 96), (1000, 512), (37, 8192),
                                 (5, 10001), (3, 40000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel(dev, N, d, dtype):
    """Rows in registers (d a multiple of the vector width, up to 8192
    float32 or 16384 bfloat16 values) and the two-pass fallback."""
    r = SC.run_case(SC.k7_case(N, d, seed=N + d, dev=dev, dtype=dtype),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal,q_offset,kv_len,fused", [
    (1, 4, 4, 128, 128, 64, True, 0, None, False),     # MHA
    (2, 8, 2, 100, 100, 32, True, 0, None, False),     # GQA, unaligned
    (1, 4, 1, 40, 24, 16, True, 0, None, False),       # Sq > Skv
    (2, 4, 2, 24, 40, 16, True, 0, None, False),       # Sq < Skv
    (1, 4, 2, 8, 40, 16, True, 20, 26, False),         # offset, kv_len
    (2, 8, 2, 77, 77, 128, False, 0, None, False),     # full attention
    (2, 16, 2, 130, 130, 128, True, 0, None, True),    # the fused layout
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, B, H, KV, Sq, Skv, hd, causal,
                                q_offset, kv_len, fused, dtype):
    r = SC.run_case(SC.k8_case(B, H, KV, Sq, Skv, hd, seed=Sq + Skv,
                               dev=dev, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, fused=fused, dtype=dtype),
                    timed=False)
    assert r["ok"], r


def _k8_shape(case, G):
    """(B, H, KV, Sq, Skv, causal, q_offset, kv_len, fused) of one K8
    tensor-core case."""
    from repro_torch.kernels import flash_attention as FA
    H = 2 * G
    bq = FA.launch_plan(1, H, 2, 1)[1]
    return {
        # Sq, Skv not multiples of 16 or 64; the last query tile ragged
        "ragged": (2, H, 2, 77, 77, True, 0, None, False),
        # decode-like rows past an offset, keys cut at kv_len < Skv
        "offset": (1, H, 2, 40, 150, True, 100, 121, False),
        "full": (2, H, 2, 50, 100, False, 0, None, False),
        # the fused layout over two query tiles, the second ragged
        "fused": (2, H, 2, 2 * bq - 3, 2 * bq - 3, True, 0, None, True),
    }[case]


@pytest.mark.parametrize("case", ["ragged", "offset", "full", "fused"])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_tensor_cores(dev, case, G, hd, dtype):
    """K8's tensor-core tiles: every head dim, GQA groups of 1, 4 and 8
    (a CTA over 1, 4 or 8 heads of a KV head), ragged query and key
    edges, an offset with kv_len < Skv, full attention and two fused-
    layout query tiles, float32 (3xTF32) and bfloat16."""
    B, H, KV, Sq, Skv, causal, q_offset, kv_len, fused = _k8_shape(case, G)
    r = SC.run_case(SC.k8_case(B, H, KV, Sq, Skv, hd, seed=Sq + hd + G,
                               dev=dev, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, fused=fused, dtype=dtype),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_misaligned_view_raises(dev, which):
    """A view the TMA and the 16-byte loads cannot take (a base one
    element past 16 bytes) raises TypeError: nothing falls back."""
    from repro_torch.kernels import flash_attention as FA
    shapes = {"q": (1, 24, 4, 64), "k": (1, 24, 2, 64), "v": (1, 24, 2, 64)}
    t = {n: torch.randn(shp, device=dev) for n, shp in shapes.items()}
    n = t[which].numel()
    t[which] = torch.empty(n + 1, device=dev)[1:].view(shapes[which])
    t[which].normal_()
    before = FA.flash_cuda.launches
    with pytest.raises(TypeError):
        FA.flash_cuda(t["q"], t["k"], t["v"])
    assert FA.flash_cuda.launches == before


def _k2_run(dev, n, preds, aggs, seed, offset=False, reject=False):
    """A K2 case; ``offset`` moves the first aggregate column (data and
    validity) one element past 16-byte alignment, ``reject`` gives every
    predicate an empty range."""
    import numpy as np
    case = SC.k2_case(n, preds, aggs, seed=seed, dev=dev)
    pcols, acols = case["pcols"], case["acols"]
    if offset:
        x, v, lo, hi = acols[0]
        x2 = torch.empty(n + 1, dtype=x.dtype, device=dev)[1:]
        v2 = torch.empty(n + 1, dtype=v.dtype, device=dev)[1:]
        x2.copy_(x)
        v2.copy_(v)
        acols[0] = (x2, v2, lo, hi)
    if reject:
        for j, (x, v, lo, hi) in enumerate(pcols):
            pcols[j] = (x, v, np.asarray(hi), np.asarray(lo - 1)
                        if x.dtype != torch.float64 else np.asarray(-np.inf))
    return case


_K2_M9 = ["id", "f64", "ts", "code", "f64", "id", "code", "ts", "f64"]


@pytest.mark.parametrize("n", [1, 15, 17, (1 << 19) + 3])
@pytest.mark.parametrize("preds,aggs,variant", [
    (["ts", "code"], ["f64", "code"], "aligned"),  # int32 codes, NaN
    (["ts", "code"], ["f64", "code"], "offset"),
    (["ts", "code"], ["f64", "code"], "reject"),
    (["id"], _K2_M9, "aligned"),                   # M = 9: two launches
    (["id"], _K2_M9, "offset"),
    (["id"], _K2_M9, "reject"),
    ([], ["f64"], "aligned"),
    ([], ["f64"], "offset")])
def test_filter_aggregate_one_launch(dev, n, preds, aggs, variant):
    """K2's runs of 16 rows: partial runs at n = 1, 15, 17 and 2**19 + 3,
    an operand one element off 16-byte alignment (read row by row), every
    row rejected (count 0, min/max at their identities), NaN in float64
    aggregates, int32 codes, nine aggregates in two launches; and two
    calls queued back to back on the stream (one ticket and scratch)
    giving the same bits."""
    import math
    from repro_torch.kernels import columnar_ops as CO
    case = _k2_run(dev, n, preds, aggs, seed=n + len(aggs),
                   offset=variant == "offset", reject=variant == "reject")
    r = SC.run_case(case, timed=False)
    assert r["ok"], r
    first = case["run"]()
    second = case["run"]()                  # queued behind, no sync
    assert torch.equal(first, second)
    if variant == "reject":
        total, per_col = CO.decode_aggregate(first.cpu().numpy(),
                                             case["acols"])
        assert total == 0
        for (s, mn, mx, c), (x, _v, _lo, _hi) in zip(per_col,
                                                      case["acols"]):
            assert c == 0 and s == 0
            if x.dtype == torch.float64:
                assert (mn, mx) == (math.inf, -math.inf)
            else:
                info = torch.iinfo(torch.int64)
                assert (mn, mx) == (info.max, info.min)


@pytest.mark.parametrize("n", [1, 1000, 65536, (1 << 19) + 3,
                               (1 << 21) + 5])
@pytest.mark.parametrize("preds", [[], ["ts", "id"]])
def test_filter_aggregate_float64_sum_order(dev, n, preds):
    """K2's float64 sums over NaN-free columns equal the plain version's
    (``tree_sum``, the reference's order) bit for bit: one node, one and
    two upper levels of the window tree (2**21 + 5 rows: 2,049 nodes),
    with and without a predicate."""
    r = SC.run_case(SC.k2_case(n, preds, ["f64n", "id", "f64n"], seed=n,
                               dev=dev), timed=False)
    assert r["ok"] and r["max_abs_err"] == 0.0, r


@pytest.mark.parametrize("B,H,KV,hd,Sc", [(2, 8, 4, 32, 256),
                                          (3, 6, 2, 16, 384),
                                          (8, 64, 8, 128, 1088)])
@pytest.mark.parametrize("fill", ["empty", "partial", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_partial_kernel(dev, B, H, KV, hd, Sc, fill, dtype):
    """Empty (an L1 slot with valid_len 0), partial and full components."""
    vl = {"empty": 0, "partial": Sc - 17, "full": Sc}[fill]
    r = SC.run_case(SC.k9_case(B, H, KV, hd, Sc, vl, seed=Sc + vl, dev=dev,
                               dtype=dtype), timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("N", [1, 8, 66, 67])
@pytest.mark.parametrize("d", [16, 96, 8192, 8196])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_cluster_split(dev, N, d, dtype):
    """Both sides of the cluster threshold (N <= 66 splits each row over
    a cluster), rows that split into 8, 4 or 2 slices, and a d whose
    vectors split into none (one block a row, or the scalar kernel)."""
    from repro_torch.kernels import rmsnorm as RN
    case = SC.k7_case(N, d, seed=N * d, dev=dev, dtype=dtype)
    vw = 16 // (torch.finfo(dtype).bits // 8)
    want = 1 if N > RN.CLUSTER_MAX_ROWS or d % vw else next(
        (c for c in (8, 4, 2) if (d // vw) % c == 0), 1)
    assert case["cluster"] == want
    r = SC.run_case(case, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("vl", [0, 1, 63, 64, 65, 200, 513, 897, 1000])
@pytest.mark.parametrize("H,KV", [(8, 8), (64, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("forced", [0, 8])
def test_decode_partial_split_boundaries(dev, monkeypatch, vl, H, KV, dtype,
                                         forced):
    """K9's cluster split over S_c = 1000 rows (not a multiple of 64), G
    = 1 and 8: empty, one-row and one-tile components and one row past a
    tile (C = 1), C = 2 and 5, one row past the last split boundary (897:
    seven ranks of 128 rows and one of 1) and the whole cache (C = 8);
    and each with C forced to 8, which leaves ranks empty (1 row: seven;
    65 rows: six; 513 rows: three)."""
    from repro_torch.kernels import lsm_decode_attention as LD
    if forced:
        monkeypatch.setattr(LD, "launch_plan",
                            lambda n, *a: LD.split_plan(n, forced))
        want = forced
    else:
        # B * KV = 8 clusters fit on the card at any C: the rows decide
        want = LD.cluster_size(vl, 8, lambda c: 8)
        assert want == {0: 1, 1: 1, 63: 1, 64: 1, 65: 1, 200: 2, 513: 5,
                        897: 8, 1000: 8}[vl]
    case = SC.k9_case(1, H, KV, 128, 1000, vl, seed=vl + H, dev=dev,
                      dtype=dtype)
    assert case["cluster"] == want
    if vl == 897:
        assert LD.split_ranges(vl, 8)[-1] == (896, 897)
    r = SC.run_case(case, timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("C", [0, 16])
def test_cluster_launch_refused_raises(dev, monkeypatch, C):
    """A cluster size the kernels do not take (0) or the card refuses
    (16 without the non-portable attribute) raises: nothing runs the
    old kernel or the plain version instead."""
    from repro_torch.kernels import lsm_decode_attention as LD
    from repro_torch.kernels import rmsnorm as RN
    monkeypatch.setattr(LD, "launch_plan", lambda n, *a: (C, 64))
    monkeypatch.setattr(RN, "cluster_size", lambda *a, **k: C)
    k9 = SC.k9_case(2, 64, 8, 128, 1024, 1024, seed=3, dev=dev)
    k7 = SC.k7_case(8, 8192, seed=4, dev=dev)
    for case in (k9, k7):
        with pytest.raises(RuntimeError):
            case["run"]()
        torch.cuda.synchronize()


@pytest.mark.parametrize("i", range(8))
def test_serve_path_shapes(dev, i):
    r = SC.run_case(SC.serve_cases(dev)[i], timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("profiler", [True, False])
def test_timing_with_and_without_the_profiler(dev, monkeypatch, profiler):
    """A timed case gives a positive kernel time whether or not
    torch.profiler sees the card: without it (CUPTI held by another
    tracer), ``ms`` comes from CUDA events and says so."""
    if profiler and not SC.profiler_works():
        pytest.skip("torch.profiler records no device time on this card")
    monkeypatch.setattr(SC, "_PROFILER", [None if profiler else False])
    r = SC.run_case(SC.k7_case(4096, 8192, seed=1, dev=dev), iters=3)
    assert r["ok"], r
    assert r["ms_timer"] == ("profiler" if profiler else "cuda_events")
    assert r["ms"] > 0 and r["plain_ms"] > 0 and r["library_ms"] > 0, r
    assert (SC.device_ms(lambda: None) is None) is not profiler


@pytest.mark.parametrize("arch", ["deepseek-67b", "starcoder2-3b"])
def test_model_path_on_card_equals_cpu(dev, arch):
    """Reduced prefill and tiered decode (with flushes and merges) on the
    card give the CPU run's logits (the same weights) within 1e-4, the
    reduction orders being the only difference; K8, K9 and (for an
    RMSNorm model) K7 launch."""
    import dataclasses
    from repro_torch.launch.serve import build_config, prepare_cache
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    cfg = dataclasses.replace(build_config(arch), kv_tail_cap=4,
                              kv_l1_comps=2)
    gen = torch.Generator().manual_seed(0)
    params = {"cpu": init_params(M.model_specs(cfg), gen,
                                 torch.device("cpu"))}
    params["cuda"] = _to(params["cpu"], dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 30),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    SC.reset_launch_counts()
    for name in ("cuda", "cpu"):
        repro_torch.set_device(name)
        logits, cache = M.make_prefill_fn(cfg)(params[name],
                                               {"tokens": tokens[:, :13]})
        cache = prepare_cache(cfg, cache, 30)
        steps = [logits.cpu()]
        for t in range(13, 29):
            logits, cache = M.make_decode_fn(cfg)(
                params[name], cache, {"token": tokens[:, t:t + 1], "pos": t})
            steps.append(logits.cpu())
        out[name] = (torch.stack(steps), cache[0]["flushes"],
                     cache[0]["merges"])
    repro_torch.set_device("cuda")
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    assert out["cuda"][1:] == out["cpu"][1:] == (3, 1)
    counts = SC.launch_counts()
    path = ["flash_attention", "lsm_decode_attention"]
    if cfg.norm_kind == "rmsnorm":
        path.append("rmsnorm")
    for k in path:
        assert counts[k] > 0, k


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# rungs 3 and 4: A6, stacked K1 / K2, the exchange and the merges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("n_live", [1, 37, 1000, 70_001])
@pytest.mark.parametrize("fields,tiers,preds,aggs", [
    (1, 1, [], []),                                   # mask mode
    (2, 3, ["ts"], []),
    (3, 2, ["f64", "code"], ["id", "f64n", "ts", "code"]),
    (1, 4, ["ts", "id"], ["f64", "nan", "f64n"]),     # NaN in aggregates
    (2, 2, [], ["id", "f64n", "ts", "code", "f64n", "id", "code", "ts",
                "f64n"])])                            # M = 9: two launches
def test_fused_chain_kernel(dev, rows, n_live, fields, tiers, preds, aggs):
    """A6 against its plain version: 1-3 fields over multi-tier postings,
    int64 / float64 / datetime / int32-code predicates and aggregates,
    float64 sums bit for bit, and (at R = 4) a padding row with n_live 0
    and zero-width slices."""
    case = SC.a6_case(rows, n_live, tiers, fields, preds, aggs,
                      seed=n_live + rows + fields, dev=dev,
                      empty_last=rows > 1)
    r = SC.run_case(case, timed=False)
    assert r["ok"], r
    if rows > 1:
        from repro_torch.kernels import chain_ops as CH
        raw, mask = CH.fused_chain(*case["args"])
        assert (raw[-1, :3] == 0).all() and not mask[-1].any()


@pytest.mark.parametrize("pos_dtype", ["int32", "int64"])
@pytest.mark.parametrize("select", [0.0, 0.3, 1.0])
def test_fused_chain_slices(dev, pos_dtype, select):
    """Empty, partial and whole probe slices of int32 and int64 postings;
    a row's result equals the same row run alone (R = 1)."""
    import numpy as np
    from repro_torch.kernels import chain_ops as CH
    a = SC.a6_arrays(4, 5000, 3, 2, ["ts"], ["f64n", "id"], seed=9,
                     dev=dev, select=select, pos_dtype=np.dtype(pos_dtype))
    args = (a["tiers"], a["abo"], a["idx"], a["n_live"], a["preds"],
            a["aggs"], a["total_p2"], a["live_p2"])
    raw, mask = CH.fused_chain(*args)
    floats = [3 + 1, 3 + 2, 3 + 3]
    assert SC.raw_compare((raw, mask), CH.chain_plain(*args), floats) == 0
    for r in range(4):
        one = ([[t[r:r + 1] for t in fp] for fp in a["tiers"]],
               a["abo"][r:r + 1], a["idx"][r:r + 1], a["n_live"][r:r + 1],
               [(d[r:r + 1], v[r:r + 1], lo[r:r + 1], hi[r:r + 1])
                for d, v, lo, hi in a["preds"]],
               [(d[r:r + 1], v[r:r + 1]) for d, v in a["aggs"]],
               a["total_p2"], a["live_p2"])
        raw1, mask1 = CH.fused_chain(*one)
        assert np.array_equal(raw1[0], raw[r]) and \
            np.array_equal(mask1[0], mask[r])


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 37, 4096, (1 << 19)])
@pytest.mark.parametrize("kinds", [["ts"], ["id", "f64"], ["code", "ts"],
                                   ["id", "ts", "f64", "code", "nan", "id",
                                    "ts", "f64", "code"]])
def test_stacked_range_mask_equals_loop_kernel(dev, rows, n, kinds):
    """Stacked K1 against its plain version, and each row bit for bit
    against the loop's K1 on that row with that row's bounds."""
    from repro_torch.kernels import columnar_ops as CO
    case = SC.k1_rows_case(rows, n, kinds, seed=n + rows, dev=dev)
    r = SC.run_case(case, timed=False)
    assert r["ok"], r
    got = case["run"]()
    for i in range(rows):
        cols = [(x[i], v[i], lo[i], hi[i]) for x, v, lo, hi in case["cols"]]
        assert torch.equal(got[i], CO.range_mask_cuda(cols, n)), i


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("n", [1, 32, 37, 4096, (1 << 19)])
@pytest.mark.parametrize("preds,aggs", [
    (["ts"], ["id", "f64n"]), (["f64", "code"], ["code", "nan", "ts"]),
    (["id"], ["id", "f64n", "ts", "code", "f64n", "id", "code", "ts",
              "f64n"])])
def test_stacked_filter_aggregate_equals_loop_kernel(dev, rows, n, preds,
                                                     aggs):
    """Stacked K2 against its plain version (float64 sums bit for bit),
    and each row's counts and scalars bit for bit against the loop's K2 on
    that row.  At n = 32 the loop K2 sums float64 columns in the
    reference's 32-slot order, which the reference's stacked core does
    not take: there the stacked rows' sums are held against the stacked
    plain version only (by ``run_case``), every other slot against the
    loop's."""
    import numpy as np
    from repro_torch.kernels import columnar_ops as CO
    case = SC.k2_rows_case(rows, n, preds, aggs, seed=n + rows, dev=dev)
    r = SC.run_case(case, timed=False)
    assert r["ok"], r
    from repro_torch.kernels import spmd_ops as SO
    raw, _mask = SO.filter_aggregate_rows(case["pcols"], case["acols"],
                                          rows, n)
    floats = ("f64", "f64n", "nan")
    slots = [c for c in range(raw.shape[1])
             if not (CO.sum32_unroll(n, len(preds)) and c % 4 == 2
                     and aggs[(c - 2) // 4] in floats)]
    for i in range(rows):
        pcols = [(x[i], v[i], lo[i], hi[i])
                 for x, v, lo, hi in case["pcols"]]
        acols = [(x[i], v[i], None, None) for x, v in case["acols"]]
        loop = CO.filter_aggregate_cuda(pcols, acols, n, dev).cpu().numpy()
        assert np.array_equal(loop[slots], raw[i][slots]), i


def _exchange_on_card(dev, cparts, keys, p):
    """The exchange of ``cparts`` staged as ``exchange_batches`` stages it,
    on the card and by its plain version on the same send buffer: (the
    card's received buffer, the plain one's, the layout)."""
    from repro_torch.kernels import spmd_ops as SO
    from repro_torch.runtime import spmd as SP
    with SP.use_partition_mesh(p):
        cols, rows, key, _names, _kinds = SP._exchange_plan(cparts, keys, p)
    stage, lay = SO.stage_exchange(cols, rows, key, p)
    send = stage.to(dev, non_blocking=True)
    before = SO.exchange_cuda.launches
    got = SO.exchange_cuda(send, lay)
    assert SO.exchange_cuda.launches == before + 1
    return got, SO.exchange_plain(send, lay), lay


@pytest.mark.parametrize("case", ["hash", "empty_source", "empty_dest",
                                  "one_dest", "two_keys", "f64_key",
                                  "bool_key"])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_exchange_kernel(dev, p, case):
    """The exchange against its plain version, byte for byte with equal
    counts, at the CPU tests' cases (``_torch_ref.exchange_parts``: an
    empty source, a destination that receives nothing, every row to one
    destination, keys hashed on the card (int64, bool) or by the host
    (two keys, float64), float64 with NaN and -0.0, bool columns); and
    ``exchange_batches`` on the card gives the CPU run's batches."""
    from _torch_ref import exchange_parts, port_namespace
    port = port_namespace()
    cparts, keys = exchange_parts(port.Column, port.ColumnBatch, p, case)
    got, want, lay = _exchange_on_card(dev, cparts, keys, p)
    assert SC.exchange_compare(got, want, lay) == 0.0
    out = {}
    for name in ("cuda", "cpu"):
        repro_torch.set_device(name)
        with port.SP.use_partition_mesh(p):
            out[name] = port.SP.exchange_batches(cparts, keys, p)
    repro_torch.set_device("cuda")
    assert out["cuda"][1] == out["cpu"][1]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert len(a) == len(b) and sorted(a.columns) == sorted(b.columns)
        for nm in a.columns:
            assert a.columns[nm].data.tobytes() == b.columns[nm].data.tobytes()
            assert a.columns[nm].valid.tobytes() == \
                b.columns[nm].valid.tobytes()


@pytest.mark.parametrize("p,sizes,key", [
    (4, (70_001, 0, 65_537, 3), "hash"),       # odd starts: row-by-row moves
    (4, (65_536, 65_536, 64, 128), "pids"),    # whole 64-row groups
    (8, (1, 2, 3, 5, 8, 13, 21, 34), "hash"),
    (33, tuple(range(1, 34)), "pids"),         # a lane count past 32
    (1000, (300,) * 1000, "hash"),             # 6 warps a block
    (4096, (7,) * 4096, "pids")])              # one warp a block
def test_exchange_kernel_sizes(dev, p, sizes, key):
    """Many tiles, sources that start at odd rows, any lane count the
    kernel's counters hold (warps a block and rows a tile follow p): the
    kernel against its plain version, byte for byte."""
    import numpy as np
    from repro_torch.kernels import spmd_ops as SO
    rng = np.random.default_rng(p + len(sizes))
    cols = [[], [], []]
    for n in sizes:
        cols[0].append((rng.integers(-(1 << 62), 1 << 62, n),
                        np.ones(n, bool)))
        cols[1].append((rng.standard_normal(n), rng.random(n) < 0.8))
        cols[2].append((rng.random(n) < 0.5, rng.random(n) < 0.9))
    k = 0 if key == "hash" else [rng.integers(0, p, n) for n in sizes]
    stage, lay = SO.stage_exchange(cols, list(sizes), k, p)
    send = stage.to(dev, non_blocking=True)
    got = SO.exchange_cuda(send, lay)
    assert SC.exchange_compare(got, SO.exchange_plain(send, lay), lay) == 0.0


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("rows,m", [(1, 1), (4, 7), (8, 5000)])
@pytest.mark.parametrize("dtype", ["float64", "int64", "float32", "int32"])
def test_merge_kernel(dev, op, rows, m, dtype):
    import numpy as np
    r = SC.run_case(SC.merge_case(rows, m, op, seed=rows * m, dev=dev,
                                  dtype=np.dtype(dtype)), timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("i", range(8))
def test_rung_shapes(dev, i):
    r = SC.run_case(SC.rung_cases(dev)[i], timed=False)
    assert r["ok"], r


# ---------------------------------------------------------------------------
# more than 8 predicate columns: K2, stacked K2 and A6 take predicates 7,
# 8, ... ANDed by K1 (stacked K1) into slot 7's validity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(6))
def test_wide_pred_shapes(dev, i):
    r = SC.run_case(SC.wide_pred_cases(dev)[i], timed=False)
    assert r["ok"] and r["max_abs_err"] == 0.0, r


def _launches():
    from repro_torch.kernels import columnar_ops as CO
    from repro_torch.kernels import spmd_ops as SO
    return (CO.range_mask_cuda.launches, CO.filter_aggregate_cuda.launches,
            SO.range_mask_rows_cuda.launches)


@pytest.mark.parametrize("n", [1, 37, 70_001, (1 << 19) + 3])
@pytest.mark.parametrize("kinds", [SC.WIDE9[:8], SC.WIDE9, SC.WIDE17])
def test_filter_aggregate_wide_preds(dev, n, kinds):
    """K2 with 8, 9 and 17 predicate columns against its plain version,
    bit for bit (float64 sums in the reference's order, NaN in a
    predicate column), and its launches: one K1 first past 8 columns,
    none up to 8."""
    case = SC.k2_case(n, kinds, ["id", "f64n", "code"], seed=n + len(kinds),
                      dev=dev)
    r = SC.run_case(case, timed=False)
    assert r["ok"] and r["max_abs_err"] == 0.0, r
    before = _launches()
    case["run"]()
    after = _launches()
    assert (after[0] - before[0], after[1] - before[1]) == \
        (int(len(kinds) > 8), 1)


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("n", [37, 4096, 1 << 19])
@pytest.mark.parametrize("kinds", [SC.WIDE9, SC.WIDE17])
def test_stacked_filter_aggregate_wide_preds(dev, rows, n, kinds):
    """Stacked K2 with 9 and 17 predicate columns against its plain
    version (float64 sums bit for bit), each row bit for bit the loop
    K2's on that row, one stacked K1 launch first."""
    import numpy as np
    from repro_torch.kernels import columnar_ops as CO
    from repro_torch.kernels import spmd_ops as SO
    case = SC.k2_rows_case(rows, n, kinds, ["id", "f64n"], seed=n + rows,
                           dev=dev)
    r = SC.run_case(case, timed=False)
    assert r["ok"], r
    before = _launches()
    raw, _mask = SO.filter_aggregate_rows(case["pcols"], case["acols"],
                                          rows, n)
    assert _launches()[2] - before[2] == 1
    for i in range(rows):
        pcols = [(x[i], v[i], lo[i], hi[i])
                 for x, v, lo, hi in case["pcols"]]
        acols = [(x[i], v[i], None, None) for x, v in case["acols"]]
        loop = CO.filter_aggregate_cuda(pcols, acols, n, dev).cpu().numpy()
        assert np.array_equal(loop, raw[i]), i


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("aggs", [[], ["id", "f64n", "code"]])
@pytest.mark.parametrize("kinds", [SC.WIDE9, SC.WIDE17])
def test_fused_chain_wide_preds(dev, rows, aggs, kinds):
    """A6 with 9 and 17 validate ranges in mask and aggregate mode
    against its plain version, a padding row at R = 4, one stacked K1
    launch before the dispatch."""
    case = SC.a6_case(rows, 70_001, 3, 2, kinds, aggs, seed=rows + len(aggs),
                      dev=dev, empty_last=rows > 1)
    r = SC.run_case(case, timed=False)
    assert r["ok"], r
    before = _launches()
    case["run"]()
    assert _launches()[2] - before[2] == 1


def test_wide_range_queries_on_card_equal_cpu(dev):
    """Aggregates that hand K2 and A6 9 and 17 predicate columns
    (``_torch_ref.wide_plans``: scan, skip-index, index chain), with the
    plan cache on and off, in the loop and at 4 lanes: on the card the
    rows and the engines' accounting of the same runs on the CPU, which
    the CPU tests hold against the reference."""
    from _torch_ref import canon, port_namespace, wide_dataset, wide_plans
    port = port_namespace()
    got = {}
    for name in ("cuda", "cpu"):
        repro_torch.set_device(name)
        ds = {"W": wide_dataset(port)}
        res = []
        for cache in (False, True):
            port.PC.set_enabled(cache)
            for k in (9, 17):
                for plan in wide_plans(port.A, k).values():
                    for mesh in (None, 4):
                        rows, ex = port.run_query(plan, ds, vectorize=True,
                                                  mesh=mesh)
                        st = ex.stats
                        res.append((canon(rows), st.fallback_reasons,
                                    st.rows_fallback,
                                    st.plan_cache_hits + st.plan_cache_misses,
                                    st.spmd_dispatches))
        got[name] = res
    port.PC.set_enabled(True)
    repro_torch.set_device("cuda")
    assert got["cuda"] == got["cpu"]


def test_rungs_on_card_equal_cpu(dev):
    """The fused chain (plan cache on) and the partition runtime at 4
    lanes give, on the card, the rows and the engine accounting of the
    same runs on the CPU, and launch A6, stacked K1 / K2 and the
    exchange."""
    import datetime as dt
    from repro_torch.configs.tinysocial import build_dataverse
    from repro_torch.core import algebra as A
    from repro_torch.storage.query import run_query
    lo, hi = dt.datetime(2014, 2, 1), dt.datetime(2015, 1, 1)
    sel = dict(pred=lambda r: r["timestamp"] >= lo, fields=["timestamp"],
               ranges={"timestamp": (lo, hi)})
    aggs = {"c": ("count", "*"), "s": ("sum", "author-id")}
    plans = [
        (A.select(A.scan("MugshotMessages"), **sel), None),
        (A.aggregate(A.select(A.scan("MugshotMessages"), ranges_exact=True,
                              **sel), aggs), None),
        (A.select(A.scan("MugshotMessages"), **sel), 4),
        (A.aggregate(A.select(A.scan("MugshotMessages"), ranges_exact=True,
                              **sel), aggs), 4),
        (A.select(A.scan("MugshotMessages"), hints=["skip-index"], **sel),
         4),
        (A.aggregate(A.select(A.scan("MugshotMessages"), ranges_exact=True,
                              hints=["skip-index"], **sel), aggs), 4),
        (A.group_by(A.scan("MugshotMessages"), ["author-id"],
                    {"c": ("count", "*")}), 4),
    ]
    out = {}
    SC.reset_launch_counts()
    for name in ("cuda", "cpu"):
        repro_torch.set_device(name)
        _, ds = build_dataverse(400, 6000, num_partitions=4,
                                flush_threshold=100)
        res = []
        for plan, mesh in plans:
            rows, ex = run_query(plan, ds, vectorize=True, mesh=mesh)
            st = ex.stats
            # hits + misses: the fused dispatches (which of the two
            # depends on the shapes seen before, process-wide)
            res.append((sorted(repr(sorted(r.items())) for r in rows),
                        st.rows_fallback,
                        st.plan_cache_hits + st.plan_cache_misses,
                        st.spmd_dispatches, st.spmd_partitions))
        out[name] = res
    repro_torch.set_device("cuda")
    assert out["cuda"] == out["cpu"]
    counts = SC.launch_counts()
    for k in ("fused_index_chain", "range_mask_stacked",
              "filter_aggregate_stacked", "spmd_exchange"):
        assert counts[k] > 0, k


# ---------------------------------------------------------------------------
# the row axis (agg_kernel's grid rows, A6's one-wave mask kernel) and
# A6's stamped flags: rows that do not divide the wave, lengths off the
# 2,048-row chunk, signed zeros and NaN payloads, stamp wraps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [3, 5, 8])
@pytest.mark.parametrize("n", [37, 5000, 3 * 2048, 70_001, 1 << 19])
@pytest.mark.parametrize("preds,aggs", [
    (["ts"], ["id", "f64n"]), (["f64", "code"], ["code", "nan", "ts"])])
def test_rows_walk_stacked_filter_aggregate(dev, rows, n, preds, aggs):
    """Stacked K2 over 3, 5 and 8 rows, n on and off the 2,048-row chunk
    and off 16 (rows past the first lose vector alignment): equal to its
    plain version, and each row bit for bit the loop kernel's row."""
    import numpy as np
    from repro_torch.kernels import columnar_ops as CO
    from repro_torch.kernels import spmd_ops as SO
    case = SC.k2_rows_case(rows, n, preds, aggs, seed=n + 7 * rows, dev=dev)
    r = SC.run_case(case, timed=False)
    assert r["ok"], r
    raw, _mask = SO.filter_aggregate_rows(case["pcols"], case["acols"],
                                          rows, n)
    for i in range(rows):
        pcols = [(x[i], v[i], lo[i], hi[i])
                 for x, v, lo, hi in case["pcols"]]
        acols = [(x[i], v[i], None, None) for x, v in case["acols"]]
        loop = CO.filter_aggregate_cuda(pcols, acols, n, dev).cpu().numpy()
        assert np.array_equal(loop, raw[i]), i


def _one_row(args, r):
    tiers, abo, idx, n_live, preds, aggs, total_p2, live_p2 = args
    return ([[t[r:r + 1] for t in fp] for fp in tiers], abo[r:r + 1],
            idx[r:r + 1], n_live[r:r + 1],
            [(d[r:r + 1], v[r:r + 1], lo[r:r + 1], hi[r:r + 1])
             for d, v, lo, hi in preds],
            [(d[r:r + 1], v[r:r + 1]) for d, v in aggs], total_p2, live_p2)


@pytest.mark.parametrize("rows", [3, 5, 8])
@pytest.mark.parametrize("n_live", [1000, 5000, 70_001, 500_000])
@pytest.mark.parametrize("preds,aggs", [([], []), (["ts"], []),
                                        (["id"], ["id", "f64n"])])
def test_rows_walk_fused_chain(dev, rows, n_live, preds, aggs):
    """A6 over 3, 5 and 8 rows, the last a padding row (n_live 0), in
    mask mode (atomic counts, no fold) and aggregate mode: equal to its
    plain version, the padding row all zero, and each row bit for bit the
    same row dispatched alone.  At n_live 500,000 (256 logical blocks a
    row) a mask-mode block's logical blocks cross a row's end at 5
    rows."""
    import numpy as np
    from repro_torch.kernels import chain_ops as CH
    case = SC.a6_case(rows, n_live, 3, 2, preds, aggs,
                      seed=n_live + 11 * rows, dev=dev, empty_last=True)
    r = SC.run_case(case, timed=False)
    assert r["ok"], r
    raw, mask = CH.fused_chain(*case["args"])
    assert (raw[-1, :3] == 0).all() and not mask[-1].any()
    for i in range(rows):
        raw1, mask1 = CH.fused_chain(*_one_row(case["args"], i))
        assert np.array_equal(raw1[0], raw[i]), i
        assert np.array_equal(mask1[0], mask[i]), i


def _zero_nan_cols(rows, n, seed, dev):
    """Two float64 aggregate columns [rows, n] whose mins and maxes turn on
    the fold order: one of +0.0, -0.0 and 3.0 only (a zero is the min, its
    sign the first met), one with NaNs of three payloads (the first met
    wins), each 90% valid."""
    import numpy as np
    rng = np.random.default_rng(seed)
    zeros = rng.choice(np.array([0.0, -0.0, 3.0]), (rows, n))
    nans = rng.normal(0.0, 1.0, (rows, n))
    hit = rng.random((rows, n)) < 0.002
    payloads = np.array([0x7ff8000000000001, 0x7ff8000000000002,
                         0xfff8000000000003], dtype=np.uint64)
    nans.view(np.uint64)[hit] = rng.choice(payloads, int(hit.sum()))
    return [(torch.from_numpy(x).to(dev),
             torch.from_numpy(rng.random((rows, n)) < 0.9).to(dev))
            for x in (zeros, nans)]


@pytest.mark.parametrize("rows", [3, 8])
@pytest.mark.parametrize("n", [5000, 1 << 19])
def test_stacked_min_max_signed_zeros_nan_payloads(dev, rows, n):
    """Stacked K2's min / max over columns of +0.0 / -0.0 and of NaNs with
    different payloads: each row's raw slots bit for bit the loop
    kernel's on that row."""
    import numpy as np
    from repro_torch.kernels import columnar_ops as CO
    from repro_torch.kernels import spmd_ops as SO
    rng = np.random.default_rng(n + rows)
    ids = torch.from_numpy(rng.integers(0, 1000, (rows, n))).to(dev)
    ok = torch.ones((rows, n), dtype=torch.bool, device=dev)
    pcols = [(ids, ok, np.full(rows, 100, np.int64),
              np.full(rows, 900, np.int64))]
    acols = _zero_nan_cols(rows, n, n + rows, dev)
    raw, _mask = SO.filter_aggregate_rows(pcols, acols, rows, n)
    for i in range(rows):
        loop = CO.filter_aggregate_cuda(
            [(ids[i], ok[i], np.int64(100), np.int64(900))],
            [(x[i], v[i], None, None) for x, v in acols], n,
            dev).cpu().numpy()
        assert np.array_equal(loop, raw[i]), i


@pytest.mark.parametrize("rows", [3, 8])
def test_fused_chain_min_max_signed_zeros_nan_payloads(dev, rows):
    """A6's min / max over +0.0 / -0.0 and NaN payloads: each stacked row's
    raw slots bit for bit the same row dispatched alone."""
    import numpy as np
    from repro_torch.kernels import chain_ops as CH
    a = SC.a6_arrays(rows, 70_001, 3, 1, [], ["f64n", "f64n"], seed=rows,
                     dev=dev)
    aggs = _zero_nan_cols(rows, a["live_p2"], rows, dev)
    args = (a["tiers"], a["abo"], a["idx"], a["n_live"], a["preds"], aggs,
            a["total_p2"], a["live_p2"])
    raw, mask = CH.fused_chain(*args)
    for i in range(rows):
        raw1, mask1 = CH.fused_chain(*_one_row(args, i))
        assert np.array_equal(raw1[0], raw[i]), i
        assert np.array_equal(mask1[0], mask[i]), i


def test_fused_chain_stamps_wrap(dev):
    """300 A6 dispatches on one stream, alternating two inputs whose
    probes flag different slots, through more than 255 stamps of one
    pooled flag buffer: each equals its plain version (a slot an earlier
    dispatch flagged never reads as set), and a stamp wrap zeroes the
    buffer (``chain_cuda.clears``)."""
    import numpy as np
    from repro_torch.kernels import chain_ops as CH
    cases = [SC.a6_case(2, 3000, 2, 2, ["ts"], ["id", "f64n"], seed=s,
                        dev=dev) for s in (1, 2)]
    want = [CH.chain_plain(*c["args"]) for c in cases]
    clears0 = CH.chain_cuda.clears
    got = [CH.chain_cuda(*cases[i % 2]["args"]) for i in range(300)]
    assert CH.chain_cuda.clears - clears0 >= 1
    w = CH.N_COUNTS + 8
    for i, res in enumerate(got):
        raw, mask = CH.unpack(res.cpu().numpy(), 2, w,
                              cases[0]["args"][-1])
        wraw, wmask = want[i % 2]
        assert np.array_equal(mask, wmask), i
        assert SC.raw_compare((raw, mask), (wraw, wmask),
                              [CH.N_COUNTS + 5, CH.N_COUNTS + 6,
                               CH.N_COUNTS + 7]) == 0, i


def test_fused_chain_back_to_back_shapes(dev):
    """A6 dispatches of different shapes (rows, fields, storage sizes,
    mask and aggregate mode) queued back to back on one stream before one
    synchronize, each equal to its plain version."""
    from repro_torch.kernels import chain_ops as CH
    cases = [SC.a6_case(*shape, seed=i, dev=dev)
             for i, shape in enumerate([
                 (4, 5000, 3, 2, ["ts"], ["id", "f64n"]),
                 (1, 70_001, 2, 1, [], []),
                 (3, 1000, 1, 3, [], ["f64n"]),
                 (2, 20_000, 4, 1, ["id"], [])])]
    got = [c["run"]() for c in cases]
    torch.cuda.synchronize()
    for c, res in zip(cases, got):
        assert c["compare"](res, c["plain"]()) == 0, c["label"]


@pytest.mark.parametrize("devs", [2, 4])
def test_mesh_lifecycle_schedules_on_card(dev, devs):
    """The reference's mesh lifecycle schedules
    (tests/test_differential.py: test_differential_mesh_lifecycle_schedules)
    on the card at 2 and 4 lanes: rows and fallback reasons equal the
    card's loop and the same runs on the CPU (which
    tests/test_torch_spmd.py holds against the reference)."""
    from _torch_ref import canon, mesh_lifecycles, port_namespace
    port = port_namespace()
    got = {}
    for name in ("cuda", "cpu"):
        repro_torch.set_device(name)
        res = []

        def check(ds, plan):
            rows_l, ex_l = port.run_query(plan, {"D": ds}, vectorize=True)
            rows_m, ex_m = port.run_query(plan, {"D": ds}, vectorize=True,
                                          mesh=devs)
            assert canon(rows_m) == canon(rows_l)
            assert ex_m.stats.fallback_reasons == ex_l.stats.fallback_reasons
            res.append((canon(rows_m), ex_m.stats.fallback_reasons))
        mesh_lifecycles(port, 20260807 * devs + 11, check)
        got[name] = res
    repro_torch.set_device("cuda")
    assert got["cuda"] == got["cpu"]


# ---------------------------------------------------------------------------
# the reference's 32-slot float64 sum order (the loop K2 at a padded
# length of 32), and stacked K2's second design (rows_agg_kernel)
# ---------------------------------------------------------------------------

def _loose_preds(rng, k, n):
    """``k`` predicate columns of int64, int32 and float64 values (NaN in
    the floats) that keep most rows (tests/test_torch_columnar_ops.py has
    the same, against the reference)."""
    import numpy as np
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
def test_filter_aggregate_32_slots_equal_plain_bits(dev, k, n):
    """K2 on the card at a padded length of 32 under ``k`` predicate
    columns (past 8 folded into slot 7 by one K1 launch, the order still
    that of all ``k``): the wrapper's result equal to the same call on the
    CPU (the plain version, which tests/test_torch_columnar_ops.py holds
    against the reference) by exact repr, one K2 launch a call."""
    import numpy as np
    from repro_torch.kernels import columnar_ops as CO
    for seed in range(4):
        rng = np.random.default_rng(1000 * k + 10 * n + seed)
        preds = _loose_preds(rng, k, n)
        aggs = [(rng.standard_normal(n) * 100.0, rng.random(n) < 0.9),
                (rng.integers(-50, 50, n, dtype=np.int64),
                 np.ones(n, bool)),
                (rng.standard_normal(n) * 1e6, np.ones(n, bool))]
        before = CO.filter_aggregate_cuda.launches
        got = CO.fused_filter_aggregate(preds, aggs, n)
        assert CO.filter_aggregate_cuda.launches == before + 1
        repro_torch.set_device("cpu")
        try:
            want = CO.fused_filter_aggregate(preds, aggs, n)
        finally:
            repro_torch.set_device("cuda")
        assert repr(got) == repr(want), (seed, got, want)


def _k2s_case(dev, rows, n, preds, aggs, seed, empty_last=False):
    """A stacked K2 case whose last row (``empty_last``) no predicate
    keeps."""
    case = SC.k2_rows_case(rows, n, preds, aggs, seed=seed, dev=dev)
    if empty_last:
        for x, v, lo, hi in case["pcols"]:
            v[-1] = False
    return case


@pytest.mark.parametrize("rows", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("n", [16, 592, 1024, 3 * 2048 + 16, 33 * 1024 + 16,
                               16 * 2048, 264 * 2048 + 4096, 1 << 20])
@pytest.mark.parametrize("preds,aggs", [
    (["ts"], ["id", "f64n"]), (["f64", "code"], ["code", "nan", "ts"]),
    (["id"], ["f64n", "nan", "f64n"])])
def test_stacked_second_design_equals_plain(dev, rows, n, preds, aggs):
    """Stacked K2's second design against its plain version bit for bit
    (NaN equal to NaN): rows that do not divide the card's SMs, n off the
    2,048-row chunk, off a group of 32 nodes, a whole group, past 264
    chunks (logical blocks of two), a single node (n <= 1,024) under three
    float64 columns side by side in the node array, the last row empty at
    R > 1; every operand aligned and n a multiple of 16, so no launch
    takes the first design."""
    case = _k2s_case(dev, rows, n, preds, aggs, seed=n + rows,
                     empty_last=rows > 1)
    from repro_torch.kernels import spmd_ops as SO
    first = SO.filter_aggregate_rows_cuda.launches_first
    r = SC.run_case(case, timed=False)
    assert r["ok"] and r["max_abs_err"] == 0.0, r
    assert SO.filter_aggregate_rows_cuda.launches_first == first


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("n", [4096, 1 << 19])
@pytest.mark.parametrize("kinds", [SC.WIDE9, SC.WIDE17])
def test_stacked_second_design_wide_preds(dev, rows, n, kinds):
    """The second design with 9 and 17 predicate columns (one stacked K1
    launch first folds those past 7 into slot 7) and four aggregate
    columns, against its plain version bit for bit."""
    case = _k2s_case(dev, rows, n, kinds, ["id", "f64n", "code", "nan"],
                     seed=n + rows + len(kinds))
    r = SC.run_case(case, timed=False)
    assert r["ok"] and r["max_abs_err"] == 0.0, r


@pytest.mark.parametrize("rows", [3, 8])
@pytest.mark.parametrize("n", [3 * 2048 + 16, 1 << 19])
def test_stacked_second_design_zeros_nan_payloads(dev, rows, n):
    """The second design's min / max over +0.0 / -0.0 and NaNs of three
    payloads: each row's raw slots bit for bit the loop kernel's on that
    row (the same fold order), and the plain version's with NaN equal to
    NaN and the zeros equal as values (which zero torch's min / max
    return is their own)."""
    import math
    import numpy as np
    from repro_torch.kernels import columnar_ops as CO
    from repro_torch.kernels import spmd_ops as SO
    rng = np.random.default_rng(n + rows)
    ids = torch.from_numpy(rng.integers(0, 1000, (rows, n))).to(dev)
    ok = torch.ones((rows, n), dtype=torch.bool, device=dev)
    pcols = [(ids, ok, np.full(rows, 100, np.int64),
              np.full(rows, 900, np.int64))]
    acols = _zero_nan_cols(rows, n, n + rows + 1, dev)
    first = SO.filter_aggregate_rows_cuda.launches_first
    raw, mask = SO.filter_aggregate_rows(pcols, acols, rows, n)
    assert SO.filter_aggregate_rows_cuda.launches_first == first
    praw, pmask = SO.filter_aggregate_rows_plain(pcols, acols, rows, n)
    assert np.array_equal(mask, pmask)
    for i in range(rows):
        loop = CO.filter_aggregate_cuda(
            [(ids[i], ok[i], np.int64(100), np.int64(900))],
            [(x[i], v[i], None, None) for x, v in acols], n,
            dev).cpu().numpy()
        assert np.array_equal(loop, raw[i]), i
        for c in range(raw.shape[1]):
            g, w = raw[i, c], praw[i, c]
            if c in (2, 3, 4, 6, 7, 8):          # the float64 slots
                g, w = (np.asarray([v]).view(np.float64)[0] for v in (g, w))
                assert (math.isnan(g) and math.isnan(w)) or g == w, (i, c)
            else:
                assert g == w, (i, c)


def test_stacked_second_design_back_to_back(dev):
    """300 launches of the second design queued on one stream before one
    synchronize, alternating two shapes whose grids, chunk counts and
    node groups differ: each equal to its plain version, so every launch
    left its row and group tickets at 0 for the next."""
    cases = [_k2s_case(dev, 4, 1 << 16, ["ts"], ["id", "f64n"], seed=1),
             _k2s_case(dev, 3, 33 * 1024 + 16, ["f64", "code"],
                       ["f64n", "code"], seed=2, empty_last=True)]
    want = [c["plain"]() for c in cases]
    got = [cases[i % 2]["run"]() for i in range(300)]
    torch.cuda.synchronize()
    for i, res in enumerate(got):
        assert cases[i % 2]["compare"](res, want[i % 2]) == 0.0, i


# ---------------------------------------------------------------------------
# concurrent threads on PyTorch's one current stream (the serving
# harness's workers): each dispatch equals the same dispatch run serially
# ---------------------------------------------------------------------------

THREADS, REPS = 8, 64


def _concurrently(cases, want):
    """THREADS threads, released by one barrier, each queueing its cases'
    ``run`` REPS times with no synchronize between calls, under a GIL
    switch interval of 1 µs so the threads' Python and C calls interleave
    as finely as they can; then each result's bytes against ``want``.
    Returns the mismatches as (thread, rep, case)."""
    import sys
    import threading
    barrier = threading.Barrier(THREADS)
    got = [[] for _ in range(THREADS)]
    errors = []

    def body(t):
        try:
            barrier.wait()
            for _rep in range(REPS):
                for case in cases[t]:
                    got[t].append(case["run"]())
        except BaseException as e:        # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=body, args=(t,))
               for t in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    torch.cuda.synchronize()
    k = len(cases[0])
    return [(t, i // k, i % k) for t in range(THREADS)
            for i, res in enumerate(got[t])
            if not torch.equal(res.cpu(), want[t][i % k])]


def _serial(case):
    """One serial run of a case, held against its plain version; its
    result on the host."""
    got = case["run"]()
    assert case["compare"](got, case["plain"]()) == 0, case["label"]
    return got.cpu()


def test_concurrent_chain_dispatches_equal_serial(dev):
    """8 threads each dispatch A6 in mask mode and in aggregate mode 64
    times on candidate sets of their own over one storage size, so their
    probes flag overlapping slots of the one pooled flag buffer: 1,024
    dispatches queued with no synchronize between them, four stamp
    wraps.  Each result equals, bit for bit, the same dispatch run
    serially (which equals the plain version), and no launch or clear
    goes uncounted."""
    from repro_torch.kernels import chain_ops as CH
    cases = [[SC.a6_case(2, 3000, 2, 2, ["ts"], aggs, seed=100 * k + t,
                         dev=dev)
              for k, aggs in enumerate(([], ["id", "f64n"]))]
             for t in range(THREADS)]
    want = [[_serial(c) for c in pair] for pair in cases]
    n0, c0 = CH.chain_cuda.launches, CH.chain_cuda.clears
    bad = _concurrently(cases, want)
    assert not bad, (len(bad), bad[:8])
    assert CH.chain_cuda.launches - n0 == THREADS * REPS * 2
    assert CH.chain_cuda.clears - c0 >= THREADS * REPS * 2 // 255


@pytest.mark.parametrize("kernel", ["filter_aggregate",
                                    "filter_aggregate_stacked",
                                    "sorted_intersect"])
def test_concurrent_kernel_dispatches_equal_serial(dev, kernel):
    """K2, stacked K2 and K3 the same way: 8 threads, 64 launches each, on
    inputs of their own; each result equals the serial one bit for bit
    (K2's scratch and tickets, stacked K2's group tickets are pooled per
    stream), and every launch is counted."""
    def make(t):
        if kernel == "filter_aggregate":
            return SC.k2_case(70_001, ["ts"], ["id", "f64n"], seed=t,
                              dev=dev)
        if kernel == "filter_aggregate_stacked":
            return SC.k2_rows_case(4, 1 << 16, ["ts"], ["id", "f64n"],
                                   seed=t, dev=dev)
        return SC.k3_case(20_000, 5_000, seed=t, dev=dev)
    cases = [[make(t)] for t in range(THREADS)]
    want = [[_serial(c) for c in one] for one in cases]
    wrapper = SC.KERNELS[{"filter_aggregate": "fused_filter_aggregate",
                          "filter_aggregate_stacked":
                          "filter_aggregate_stacked",
                          "sorted_intersect": "sorted_intersect_mask"}
                         [kernel]]["wrapper"]
    n0 = wrapper.launches
    bad = _concurrently(cases, want)
    assert not bad, (len(bad), bad[:8])
    assert wrapper.launches - n0 == THREADS * REPS


# ---------------------------------------------------------------------------
# the training path's backward kernels: K7's and K8's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,d", [(1, 16), (3, 96), (300, 512), (37, 8192),
                                 (5, 10001), (4096, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel(dev, N, d, dtype):
    """K7's backward against ``rmsnorm_bwd_plain``: fewer rows than row
    blocks, a d no vector width divides, the train step's [4096, 8192];
    within ``BWD_RTOL`` (float32) or ``BF16_RTOL`` of each gradient's
    largest magnitude, and the same bits on a second launch (no
    atomics: ``run_case`` checks)."""
    r = SC.run_case(SC.k7_bwd_case(N, d, seed=N + d, dev=dev, dtype=dtype),
                    timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("N,d,offset", [
    (300, 8192, "x"), (300, 8192, "g"), (64, 2048, "xg"),
    # multiples of 4 (8 for bfloat16) that are no multiple of the 256
    # threads' vector span
    (37, 2056, ""), (5, 8184, ""), (130, 1032, "")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_vector_route(dev, N, d, offset, dtype):
    """K7's backward around its vector kernel: operands one element off a
    16-byte boundary (they take the first design), and rows whose vectors
    fill the threads' last pass only in part; within ``BWD_RTOL`` or
    ``BF16_RTOL`` of each gradient's largest magnitude, the same bits on a
    second launch."""
    r = SC.run_case(SC.k7_bwd_case(N, d, seed=N + d, dev=dev, dtype=dtype,
                                   offset=offset), timed=False)
    assert r["ok"], r


def _k8_bwd_shape(case, G):
    """(B, H, KV, Sq, Skv, causal, q_offset) of one K8 backward case."""
    H = 2 * G
    return {
        # Sq not a multiple of the 64-row tiles
        "ragged": (2, H, 2, 77, 77, True, 0),
        # queries past an offset over more keys (a decode-like chunk)
        "offset": (1, H, 2, 40, 150, True, 100),
        "full": (2, H, 2, 50, 100, False, 0),
    }[case]


@pytest.mark.parametrize("case", ["ragged", "offset", "full"])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel(dev, case, G, hd, dtype):
    """K8's backward against ``flash_bwd_plain`` (autograd of the oracle):
    every head dim, GQA groups of 1, 4 and 8, ragged tiles, a query
    offset, full attention, float32 and bfloat16; within ``BWD_RTOL``
    (float32) or ``BF16_RTOL`` of each gradient's largest magnitude, and
    the same bits on a second launch."""
    B, H, KV, Sq, Skv, causal, q_offset = _k8_bwd_shape(case, G)
    r = SC.run_case(SC.k8_bwd_case(B, H, KV, Sq, Skv, hd, seed=Sq + hd + G,
                                   dev=dev, causal=causal, q_offset=q_offset,
                                   dtype=dtype), timed=False)
    assert r["ok"], r


@pytest.mark.parametrize("shape", [
    # several 64-key and 32-query tiles (dK/dV), 64-query and 32-key tiles
    # (dQ), causal
    (1, 16, 2, 300, 300, True, 0),
    # one query over 1,000 keys: every key tile, one query tile
    (1, 16, 2, 1, 1000, True, 999),
    # Skv no multiple of either key tile, Sq none of either query tile
    (2, 16, 2, 130, 200, False, 0),
    (1, 8, 1, 150, 219, True, 69)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_tiles(dev, shape, dtype):
    """K8's backward at hd 128, G 8 over many tiles of the float32
    design's four tilings (64 keys by 32 queries for dK/dV, 64 queries by
    32 keys for dQ), ragged edges of each, a query offset; within
    ``BWD_RTOL`` (float32) or ``BF16_RTOL`` of each gradient's largest
    magnitude, the same bits on a second launch."""
    B, H, KV, Sq, Skv, causal, q_offset = shape
    r = SC.run_case(SC.k8_bwd_case(B, H, KV, Sq, Skv, 128, seed=Sq + Skv,
                                   dev=dev, causal=causal, q_offset=q_offset,
                                   dtype=dtype), timed=False)
    assert r["ok"], r


def test_flash_attention_bwd_unaligned_operands(dev):
    """K8's float32 backward handed contiguous views one element off a
    16-byte boundary (its TMA tiles need 16-byte aligned bases): the
    wrapper copies them, and the gradients equal the aligned call's bit
    for bit."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    q, g = (torch.randn(1, 100, 8, 64, device=dev, generator=gen)
            for _ in range(2))
    k, v = (torch.randn(1, 130, 2, 64, device=dev, generator=gen)
            for _ in range(2))
    o, lse = FA.flash_cuda(q, k, v, True, 0, with_lse=True)
    want = FA.flash_bwd_cuda(q, k, v, o, lse, g, True, 0)
    odd = [SC._offset_view(t) for t in (q, k, v, o, g)]
    assert all(t.data_ptr() % 16 != 0 for t in odd)
    got = FA.flash_bwd_cuda(*odd[:4], lse, odd[4], True, 0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("i", range(2))
def test_train_path_shapes(dev, i):
    """The backward kernels at deepseek-67b's train-step shapes."""
    r = SC.run_case(SC.train_cases(dev)[i], timed=False)
    assert r["ok"], r


def test_repair_rmsnorm_has_a_gradient_on_the_card(dev):
    """Through ``model_ops.rmsnorm`` on the card, x and w get the plain
    version's gradient.  (K7's wrapper once returned a tensor its ctypes
    call filled, with no ``grad_fn``: backward stopped at every norm.)"""
    from repro_torch.kernels import model_ops
    from repro_torch.kernels.ref import rmsnorm_ref
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn(2, 64, 512, device=dev, generator=g).requires_grad_()
    w = torch.randn(512, device=dev, generator=g).requires_grad_()
    dy = torch.randn(2, 64, 512, device=dev, generator=g)
    y = model_ops.rmsnorm(x, w)
    assert y.requires_grad, "no gradient through K7"
    got = torch.autograd.grad(y, (x, w), dy)
    want = torch.autograd.grad(rmsnorm_ref(x, w), (x, w), dy)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_repair_flash_backward_runs_no_oracle_on_the_card(dev, monkeypatch):
    """K8's gradient on the card comes from its backward kernels: the
    oracle is made to raise while it runs, and the gradients equal
    autograd of the oracle run afterwards.  (K8's backward once
    recomputed through the oracle for CUDA tensors too, materializing the
    [Sq, Skv] scores of every head.)"""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import model_ops
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    q = torch.randn(2, 96, 8, 64, device=dev, generator=g)
    k = torch.randn(2, 96, 2, 64, device=dev, generator=g)
    v = torch.randn(2, 96, 2, 64, device=dev, generator=g)
    dy = torch.randn(2, 96, 8, 64, device=dev, generator=g)
    want = torch.autograd.grad(
        ref.flash_attention_ref(*(t.requires_grad_() for t in (q, k, v))),
        (q, k, v), dy)
    oracle = ref.flash_attention_ref

    def refuse(*a, **kw):
        raise AssertionError("the oracle ran on the card")
    for mod in (ref, FA, model_ops):
        if getattr(mod, "flash_attention_ref", None) is oracle:
            monkeypatch.setattr(mod, "flash_attention_ref", refuse)
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(model_ops.flash_attention(*qkv), qkv, dy)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
