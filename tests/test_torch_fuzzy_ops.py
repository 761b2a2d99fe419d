"""The fuzzy kernels of the PyTorch port (``repro_torch.kernels.
fuzzy_ops``) held against the reference module on the same numpy inputs:
K4 masks at T = 1 and T > 1, K5 saturated edit distances, K6 and A7
intersection counts, all exactly, in every regime the reference has (its
host shortcuts, its x64 jnp cores, its Pallas kernels in interpret mode);
``fnv1a_hash`` and ``encode_bitsets`` bit for bit; Jaccard similarities
bit-identical in float64.

On the CPU the port's wrappers run the kernels' plain versions; the CUDA
kernels are held against them in test_torch_kernels_gpu.py.  The
reference is imported under a test-side ``jax.experimental.enable_x64``
shim that is removed again when this module's tests end.
"""

import contextlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro_torch  # noqa: E402
from repro_torch.kernels import fuzzy_ops as PF  # noqa: E402


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
def RF():
    with _reference_x64():
        from repro.kernels import fuzzy_ops
        yield fuzzy_ops


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


@pytest.mark.parametrize("threshold", [1, 2, 3, 5])
@pytest.mark.parametrize("sizes", [(1, 1), (40, 25), (1000, 3000),
                                   (5000, 800)])
def test_t_occurrence_matches_reference(RF, threshold, sizes):
    n, m = sizes
    rng = np.random.default_rng(n * 13 + m + threshold)
    positions = rng.integers(0, n, m, dtype=np.int64)
    got = PF.t_occurrence_mask(positions, n, threshold)
    ref = RF.t_occurrence_mask(positions, n, threshold, force_pallas=False)
    assert got.dtype == bool and got.shape == (n,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("threshold", [1, 2])
def test_t_occurrence_segments_equal_concatenation(RF, threshold):
    """Segments of resident posting arrays (slice + row offset) give the
    mask of the concatenated host positions."""
    rng = np.random.default_rng(threshold)
    tiers = [np.sort(rng.integers(0, 300, 500)) for _ in range(4)]
    offs = [0, 300, 600, 900]
    bounds = [(10, 200), (0, 0), (50, 500), (499, 500)]
    segs = [PF.Segment(t, a, b, off)
            for t, (a, b), off in zip(tiers, bounds, offs)]
    flat = np.concatenate([t[a:b] + off
                           for t, (a, b), off in zip(tiers, bounds, offs)])
    got = PF.t_occurrence_mask(segs, 1200, threshold)
    np.testing.assert_array_equal(
        got, RF.t_occurrence_mask(flat, 1200, threshold,
                                  force_pallas=False))


def _gram_postings(names):
    from repro_torch.fuzzy.ngram import GRAM_K, GramPostings
    return GramPostings.from_values(names, GRAM_K)


@pytest.mark.parametrize("spec", [("ed", 1), ("ed", 3), ("jaccard", 0.8)])
def test_t_occurrence_sorted_gram_segments(RF, spec):
    """The ngram probe's segments (``hit_segments``, marked sorted) over
    two tiers give the reference's mask of the concatenated hits."""
    from repro_torch.fuzzy.ngram import GRAM_K, query_grams
    rng = np.random.default_rng(len(spec[0]))
    names = [f"User Number {i}" for i in rng.choice(5000, 600, False)]
    tiers = [_gram_postings(names[:400]), _gram_postings(names[400:])]
    qh, threshold = query_grams(("name", spec[0], "User Number 123",
                                 spec[1]), GRAM_K)
    assert threshold > 1
    segs = tiers[0].hit_segments(qh, 0) + tiers[1].hit_segments(qh, 400)
    assert segs and all(s.sorted for s in segs)
    flat = np.concatenate([s.positions[s.start:s.stop] + s.offset
                           for s in segs])
    got = PF.t_occurrence_mask(segs, 600, threshold)
    np.testing.assert_array_equal(
        got, RF.t_occurrence_mask(flat, 600, threshold, force_pallas=False))


def test_hit_segments_are_sorted_and_only_they_say_so():
    """Every slice ``GramPostings.hit_segments`` returns ascends and is
    marked sorted (memtable values and dictionary-coded columns alike),
    and no other ``Segment`` constructor in the port sets the flag."""
    import ast
    import pathlib
    from repro_torch.columnar.batch import ColumnBatch
    from repro_torch.fuzzy.ngram import GRAM_K, GramPostings, query_grams
    rng = np.random.default_rng(5)
    names = [f"User Number {i}" if i % 7 else None
             for i in rng.choice(3000, 500, False)]
    batch = ColumnBatch.from_rows([{"name": v} if v else {}
                                   for v in names])
    assert batch.columns["name"].kind == "str"
    built = [GramPostings.from_values(names, GRAM_K),
             GramPostings.from_batch(batch, "name", GRAM_K, len(names))]
    qh, _ = query_grams(("name", "ed", "User Number 12", 2), GRAM_K)
    for post in built:
        segs = post.hit_segments(qh, 7)
        assert segs
        for s in segs:
            assert s.sorted
            assert (np.diff(s.positions[s.start:s.stop]) >= 0).all()
    root = pathlib.Path(PF.__file__).resolve().parents[1]
    flagged = []
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = getattr(node.func, "id", None) or \
                    getattr(node.func, "attr", None)
                if name == "Segment" and (
                        len(node.args) > 4
                        or any(k.arg == "sorted" for k in node.keywords)):
                    flagged.append((path.name, fn.name))
    assert sorted(set(flagged)) == [("ngram.py", "hit_segments")]


@pytest.mark.parametrize("case", ["n0", "t0", "m0"])
def test_t_occurrence_short_circuits(RF, case):
    pos = np.array([1, 2, 2], np.int64)
    n, t = 5, 1
    if case == "n0":
        n = 0
    elif case == "t0":
        t = 0
    else:
        pos = pos[:0]
    np.testing.assert_array_equal(
        PF.t_occurrence_mask(pos, n, t),
        RF.t_occurrence_mask(pos, n, t, force_pallas=False))


def test_t_occurrence_matches_pallas_interpret(RF):
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 600, 300, dtype=np.int64)
    for t in (1, 2):
        np.testing.assert_array_equal(
            PF.t_occurrence_mask(pos, 600, t),
            RF.t_occurrence_mask(pos, 600, t, force_pallas=True,
                                 interpret=True))


@pytest.mark.parametrize("tokens", [
    [], [""], ["tpu", "jax", "lsm"], ["héllo wörld", "x" * 70, "a b"],
    ["user%d" % i for i in range(200)]])
def test_fnv1a_bit_identical(RF, tokens):
    got, ref = PF.fnv1a_hash(tokens), RF.fnv1a_hash(tokens)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, ref)


def test_fuzzy_kernels_refuse_until_ported(RF):
    """The fuzzy kernels, once refused here, are ported: the smallest
    call of each equals the reference's."""
    np.testing.assert_array_equal(PF.edit_distances(["tpu"], "tpv", 1),
                                  RF.edit_distances(["tpu"], "tpv", 1,
                                                    force_pallas=False))
    a, b = [np.array([1, 2])], [np.array([2, 3])]
    np.testing.assert_array_equal(
        PF.set_intersect_counts(a, b),
        RF.set_intersect_counts(a, b, force_pallas=False))


# ---------------------------------------------------------------------------
# K5: saturated edit distance
# ---------------------------------------------------------------------------

ALPHABET = list("abcdé中 ")


def _strings(rng, n, max_len):
    return ["".join(rng.choice(ALPHABET, int(k)))
            for k in rng.integers(0, max_len + 1, n)]


ED_QUERIES = ["", "abc", "dé中", "abcdabcdabcd"]


@pytest.mark.parametrize("B", [1, 7, 32])
@pytest.mark.parametrize("query", ED_QUERIES)
def test_edit_distances_match_reference_host_dp(RF, B, query):
    """B <= 32: the reference's host DP.  Empty strings, an empty query,
    d = 0, non-ASCII code points, candidates longer than the query."""
    rng = np.random.default_rng(B)
    strs = _strings(rng, B, 20)
    strs[0] = ""
    for d in (0, 1, 4):
        got = PF.edit_distances(strs, query, d)
        assert got.dtype == np.int64 and got.shape == (B,)
        np.testing.assert_array_equal(
            got, RF.edit_distances(strs, query, d, force_pallas=False))


@pytest.mark.parametrize("d", [0, 2, 40])
def test_edit_distances_match_reference_jnp_core(RF, d):
    """B > 32: the reference's x64 jnp core (one compile per shape)."""
    rng = np.random.default_rng(d + 100)
    strs = _strings(rng, 70, 24) + ["", "abcd" * 9]
    for query in ("", "abcdé中"):
        np.testing.assert_array_equal(
            PF.edit_distances(strs, query, d),
            RF.edit_distances(strs, query, d, force_pallas=False))


def test_edit_distances_match_reference_pallas_interpret(RF):
    rng = np.random.default_rng(7)
    strs = _strings(rng, 7, 9) + [""]
    np.testing.assert_array_equal(
        PF.edit_distances(strs, "bcé", 1),
        RF.edit_distances(strs, "bcé", 1, force_pallas=True,
                          interpret=True))


def test_edit_distances_plain_equals_python_oracle():
    """Long queries and long strings (past the kernel's shared-memory
    row) against the scalar DP, saturated."""
    from repro_torch.core.functions import edit_distance
    rng = np.random.default_rng(3)
    strs = _strings(rng, 40, 90)
    for query in ("a" * 70, "abc中" * 20):
        for d in (0, 5, 10 ** 6):
            assert PF.edit_distances(strs, query, d).tolist() == \
                [min(edit_distance(s, query), d + 1) for s in strs]


def _bit_parallel_ed(s, q, cap):
    """A transcription of csrc/edit_distance.cu's bit-parallel recurrence
    (Myers, in Hyyro's form for the global distance), kept here to settle
    the algorithm on the CPU: one 32-bit word up to m = 32, one 64-bit word
    up to 64, wrapped to the word as the card's integers wrap."""
    m = len(q)
    if m == 0:
        return min(len(s), cap)
    bits = 32 if m <= 32 else 64
    full = (1 << bits) - 1
    peq = {}
    for i, c in enumerate(q):
        peq[c] = peq.get(c, 0) | (1 << i)
    top = 1 << (m - 1)
    pv, mv, score = full, 0, m
    for c in s:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = ((((eq & pv) + pv) & full) ^ pv) | eq
        ph = mv | (~(xh | pv) & full)
        mh = pv & xh
        score += bool(ph & top) - bool(mh & top)
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        pv = mh | (~(xv | ph) & full)
        mv = ph & xv
    return min(score, cap)


@pytest.mark.parametrize("m", [0, 1, 15, 31, 32, 33, 63, 64])
def test_bit_parallel_recurrence_equals_the_dp(RF, m):
    """The bit-parallel recurrence at the word-boundary query lengths
    against the port's plain DP (``ed_plain``) and the reference's jnp
    core, on seeded strings shorter and longer than the query, with
    repeated and non-ASCII code points, at d = 0, 1, 3 and 1000."""
    rng = np.random.default_rng(m + 50)
    query = "".join(rng.choice(ALPHABET, m))
    strs = _strings(rng, 40, 80) + ["", query, query[::-1]]
    lp = PF._pow2_len(max(len(x) for x in strs))
    for d in (0, 1, 3, 1000):
        cap = min(d + 1, lp + m + 1)
        want = [_bit_parallel_ed(x, query, cap) for x in strs]
        assert PF.edit_distances(strs, query, d).tolist() == want
        assert RF.edit_distances(strs, query, d,
                                 force_pallas=False).tolist() == want


# ---------------------------------------------------------------------------
# K6: sorted-set intersection counts
# ---------------------------------------------------------------------------

def _sets(rng, P, max_len, hi):
    return [np.unique(rng.integers(0, hi, int(k), dtype=np.int64))
            for k in rng.integers(0, max_len + 1, P)]


@pytest.mark.parametrize("P", [1, 16, 17, 200])
@pytest.mark.parametrize("hi", [40, 2 ** 40])
def test_set_intersect_counts_match_reference(RF, P, hi):
    """P <= 16: the reference's intersect1d loop; P > 16: its x64 jnp
    core, exact for codes far above 2**24."""
    rng = np.random.default_rng(P + (hi > 100))
    a, b = _sets(rng, P, 12, hi), _sets(rng, P, 9, hi)
    got = PF.set_intersect_counts(a, b)
    assert got.dtype == np.int64 and got.shape == (P,)
    np.testing.assert_array_equal(
        got, RF.set_intersect_counts(a, b, force_pallas=False))


@pytest.mark.parametrize("P", [5, 40])
def test_set_intersect_counts_padded_match_reference(RF, P):
    """The FuzzyJoin layout: sentinel-padded rows of one record matrix
    gathered per pair, a rows masked by their lengths."""
    rng = np.random.default_rng(P)
    recs = _sets(rng, 12, 10, 2 ** 30)
    width = max(len(r) for r in recs)
    mat = np.full((12, width), PF._SENTINEL, dtype=np.int64)
    for i, r in enumerate(recs):
        mat[i, :len(r)] = r
    sizes = np.array([len(r) for r in recs], dtype=np.int64)
    ai, bi = rng.integers(0, 12, P), rng.integers(0, 12, P)
    np.testing.assert_array_equal(
        PF.set_intersect_counts_padded(mat[ai], sizes[ai], mat[bi],
                                       sizes[bi]),
        RF.set_intersect_counts_padded(mat[ai], sizes[ai], mat[bi],
                                       sizes[bi], force_pallas=False))


def test_set_intersect_counts_match_pallas_interpret(RF):
    rng = np.random.default_rng(11)
    a, b = _sets(rng, 8, 6, 30), _sets(rng, 8, 5, 30)
    np.testing.assert_array_equal(
        PF.set_intersect_counts(a, b),
        RF.set_intersect_counts(a, b, force_pallas=True, interpret=True))


# ---------------------------------------------------------------------------
# K6's batches (csrc/set_intersect.cu), transcribed to settle them here
# ---------------------------------------------------------------------------

def _k6_batch(P, s1, s2, threads, items, stage_bytes=32 << 10,
              stage_max=200 << 10, sms=132):
    """``rt_set_intersect``'s choice: (pairs a batch, b rows staged)."""
    staged = 8 * s2 <= stage_max
    B = threads * items // s1 if s1 else threads * items
    if staged and s2:
        B = min(B, stage_bytes // (8 * s2))
    B = min(B, -(-P // (2 * sms)))
    if B >= 2:
        B &= ~1
    return max(B, 1), staged


def _stage_copies(src, n):
    """``stage_span``'s copies of an n-element span that starts ``src``
    elements (8 bytes each) into 16-byte-aligned storage: (first element,
    count) each, the 2-element ones 16-byte copies."""
    head = src & 1
    if n <= head:
        return [(0, 1)] if n == 1 else []
    out = [(0, 1)] if head else []
    out += [(head + 2 * c, 2) for c in range((n - head) >> 1)]
    if (n - head) & 1:
        out.append((n - 1, 1))
    return out


def _k6_batches(a, alens, b, threads=256, items=4, offset=0):
    """A transcription of ``set_intersect_batch_kernel``: batches of B
    pairs, the b span staged by 8- and 16-byte copies into a buffer
    shifted to the span's offset mod 16 bytes (``offset``: the element the
    storage starts at), flat (pair, j) items stepped as the kernel steps
    them, the halving search for the last code <= x, and the segmented
    ballot's runs.  Returns the counts."""
    P, s1 = a.shape
    s2 = b.shape[1]
    B, staged = _k6_batch(P, s1, s2, threads, items)
    w = max(s1, 1)
    q, r = threads // w, threads % w
    af, bf = a.reshape(-1), b.reshape(-1)
    out = np.zeros(P, dtype=np.int64)
    lanes = np.arange(32)
    for p0 in range(0, P, B):
        nb = min(B, P - p0)
        n = nb * s2
        rows = bf[p0 * s2:p0 * s2 + n]
        if staged:
            src = offset + p0 * s2
            shift = src & 1          # the span lands one element in when
            buf = np.full(n + 1, -7, dtype=np.int64)   # src is 8 mod 16
            done = 0
            for e, size in _stage_copies(src, n):
                if size == 2:        # 16 bytes, aligned on both sides
                    assert (src + e) % 2 == 0 and (shift + e) % 2 == 0
                buf[shift + e:shift + e + size] = rows[e:e + size]
                done += size
            assert done == n
            rows = buf[shift:shift + n]
        rows = rows.reshape(nb, s2)
        cnt = np.zeros(nb, dtype=np.int64)
        nitems = nb * s1
        base = 0
        while base < nitems:
            i0 = base + np.arange(threads)
            pair, j = i0 // w, i0 % w
            for k in range(items):
                i = i0 + k * threads
                assert (pair == i // w).all() and (j == i % w).all()
                live = i < nitems
                live[live] = j[live] < alens[p0 + pair[live]]
                x = np.zeros(threads, dtype=np.int64)
                x[live] = af[p0 * s1 + i[live]]
                row = np.where(live, pair, 0)   # a dead item reads row 0
                at = np.zeros(threads, dtype=np.int64)
                width = s2                  # the last code <= x
                while width > 1:
                    half = width >> 1
                    at = np.where(rows[row, at + half] <= x, at + half, at)
                    width -= half
                hit = live & (s2 > 0)
                hit[hit] = rows[row[hit], at[hit]] == x[hit]
                for wp in range(min(threads, max(nitems - i[0], 0) + 31)
                                // 32):   # warps past the items add nothing
                    pr = pair[32 * wp:32 * wp + 32]
                    hits = int((hit[32 * wp:32 * wp + 32] << lanes).sum())
                    start = np.r_[True, pr[1:] != pr[:-1]]
                    starts = int((start << lanes).sum())
                    for lane in np.flatnonzero(start).tolist():
                        later = starts >> (lane + 1) if lane < 31 else 0
                        end = lane + (later & -later).bit_length() \
                            if later else 32
                        run = ((1 << end) - 1) & ~((1 << lane) - 1)
                        c = bin(hits & run).count("1")
                        if c:
                            assert pr[lane] < nb
                            cnt[pr[lane]] += c
                j += r
                pair += q
                wrap = j >= w
                j[wrap] -= w
                pair[wrap] += 1
            base += threads * items
        out[p0:p0 + nb] = cnt
    return out


# (P, S1, S2, threads, items): odd S2 (67, 1), P not a multiple of the
# batch, a rows past one round of items, S1 = 0, b rows too wide to stage
K6_SHAPES = [(501, 67, 67, 256, 4), (999, 33, 1, 256, 4),
             (257, 5, 67, 256, 4), (40, 300, 67, 64, 2), (20, 0, 5, 256, 4),
             (130, 32, 32, 256, 4), (20, 3, 30_000, 256, 4)]


@pytest.mark.parametrize("shape", K6_SHAPES)
@pytest.mark.parametrize("unsorted_a", [False, True])
@pytest.mark.parametrize("lens", ["subset", "edge"])
def test_set_intersect_batches_transcription(RF, shape, unsorted_a, lens):
    """The batches of csrc/set_intersect.cu, transcribed, against the
    plain version and the reference's x64 path on the GPU tests' inputs
    (``selfcheck.k6_arrays``, codes above 2**40): batch spans staged with
    unaligned heads and tails (an even and an odd storage offset), flat
    (pair, j) items over unsorted a rows and lengths of 0 and above S1."""
    import torch
    from repro_torch.kernels import selfcheck as SC
    P, s1, s2, threads, items = shape
    a, alens, b = SC.k6_arrays(P, s1, s2, 1 << 41, P + s2, unsorted_a, lens)
    plain = PF.inter_plain(torch.from_numpy(a), torch.from_numpy(alens),
                           torch.from_numpy(b)).numpy()
    ref = RF.set_intersect_counts_padded(
        a, alens, b, (b != PF._SENTINEL).sum(1), force_pallas=False)
    np.testing.assert_array_equal(plain, ref)
    for offset in (0, 1):
        got = _k6_batches(a, alens, b, threads, items, offset)
        np.testing.assert_array_equal(got, plain)


# ---------------------------------------------------------------------------
# A7: bitset popcount; encode_bitsets; Jaccard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [1, 31, 33, 800, 5000])
def test_encode_bitsets_bit_identical(RF, vocab):
    rng = np.random.default_rng(vocab)
    rows = 9
    sizes = rng.integers(0, min(vocab, 20) + 1, rows)
    seg = np.repeat(np.arange(rows, dtype=np.int64), sizes)
    codes = np.concatenate([rng.choice(vocab, int(k), replace=False)
                            for k in sizes]).astype(np.int64)
    got = PF.encode_bitsets(codes, seg, rows, vocab)
    ref = RF.encode_bitsets(codes, seg, rows, vocab)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("R,W,P", [(1, 1, 1), (5, 3, 11), (300, 32, 1000)])
def test_bitset_intersect_counts_match_reference(RF, R, W, P):
    rng = np.random.default_rng(R + W + P)
    bits = rng.integers(0, 2 ** 32, (R, W), dtype=np.uint64).astype(
        np.uint32)
    bits[0] = 0xFFFFFFFF                        # every bit, sign bit too
    ai, bi = rng.integers(0, R, P), rng.integers(0, R, P)
    got = PF.bitset_intersect_counts(bits, ai, bi)
    assert got.dtype == np.int64 and got.shape == (P,)
    np.testing.assert_array_equal(
        got, RF.bitset_intersect_counts(bits, ai, bi))


def _a7_groups(W, aligned=True):
    """csrc/bitset_intersect.cu's dispatch: (G lanes a pair, words a
    chunk)."""
    if W % 4 == 0 and aligned:
        return 8, 4
    return (1 if W == 1 else 8), 1


def _a7_warps(words, ai, bi, G, cw, resident=3, threads=256):
    """A transcription of ``bitset_intersect_kernel``: one wave of blocks,
    each a contiguous range of whole 32-pair warp runs; a warp loads 32
    index pairs, round q gives group g (lanes g G .. g G + G - 1) pair
    q (32 / G) + g, lane j of the group counts chunks j, j + G, ... of
    ``cw`` words; a reduce-scatter over the group leaves lane j the count
    of pair j (32 / G) + g."""
    R, W = words.shape
    P = ai.shape[0]
    chunks = W // cw
    per_word = words.reshape(R, chunks, cw)
    out = np.full(P, -1, dtype=np.int64)
    runs = -(-P // 32)
    blocks = 132 * resident
    if blocks * (threads // 32) > runs:
        blocks = -(-runs // (threads // 32))
    per_block = -(-runs // max(blocks, 1)) * 32
    PR, lane = 32 // G, np.arange(32)
    g, j = lane // G, lane % G
    for blk in range(max(blocks, 1)):
        begin = blk * per_block
        end = min(P, begin + per_block)
        for w in range(threads // 32):
            for p0 in range(begin + 32 * w, end, threads):
                p = p0 + lane
                ra = np.where(p < end, ai[np.minimum(p, P - 1)], 0)
                rb = np.where(p < end, bi[np.minimum(p, P - 1)], 0)
                c = np.zeros((32, G), dtype=np.int64)
                for q in range(G):
                    x, y = ra[q * PR + g], rb[q * PR + g]      # shuffles
                    for ln in range(32):
                        both = per_word[x[ln], j[ln]::G] & \
                            per_word[y[ln], j[ln]::G]
                        c[ln, q] = int(np.unpackbits(
                            np.ascontiguousarray(both).view(np.uint8)).sum())
                h = G // 2
                while h:
                    up = (j & h) != 0
                    for t in range(h):
                        send = np.where(up, c[:, t], c[:, t + h])
                        keep = np.where(up, c[:, t + h], c[:, t])
                        c[:, t] = keep + send[lane ^ h]
                    h //= 2
                dst = p0 + j * PR + g
                ok = dst < end
                out[dst[ok]] = c[ok, 0]
    return out


@pytest.mark.parametrize("W,aligned", [(1, True), (2, True), (3, True),
                                       (4, True), (8, True), (16, True),
                                       (32, True), (64, True), (100, True),
                                       (32, False)])
def test_bitset_intersect_groups_transcription(RF, W, aligned):
    """A7's lane groups, transcribed, against the plain version and the
    reference on pairs of a run of one record and uniform pairs: every
    group size and chunk, a warp run cut by the block's range and P."""
    rng = np.random.default_rng(W)
    R, P = 40, 300
    bits = rng.integers(0, 2 ** 32, (R, W), dtype=np.uint64).astype(
        np.uint32)
    ai = np.concatenate([np.full(50, 7), rng.integers(0, R, P - 50)])
    bi = rng.integers(0, R, P)
    G, cw = _a7_groups(W, aligned)
    got = _a7_warps(bits, ai, bi, G, cw, resident=1, threads=64)
    want = PF.bitset_intersect_counts(bits, ai, bi)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, RF.bitset_intersect_counts(bits, ai, bi))


def test_popcount_cuda_refuses_2_31_rows():
    """The kernel shuffles row indices as 32-bit: a matrix of 2**31 rows
    or more is refused before anything reaches a device."""
    bits = torch.zeros(1, 1, dtype=torch.int32).expand(2 ** 31, 1)
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        PF.popcount_cuda(bits, idx, idx)


def test_bitset_intersect_counts_refuse_out_of_range_rows():
    bits = np.zeros((4, 2), dtype=np.uint32)
    with pytest.raises(IndexError):
        PF.bitset_intersect_counts(bits, np.array([0, 4]), np.array([1, 1]))


@pytest.mark.parametrize("P", [3, 40])
def test_jaccard_sims_bit_identical(RF, P):
    rng = np.random.default_rng(P)
    a, b = _sets(rng, P, 8, 30), _sets(rng, P, 8, 30)
    a[0], b[0] = a[0][:0], b[0][:0]             # two empty sets -> 1.0
    got = PF.jaccard_sims(a, b)
    ref = RF.jaccard_sims(a, b, force_pallas=False)
    assert got.dtype == np.float64
    assert got.tobytes() == ref.tobytes()
    inter = rng.integers(0, 5, P)
    sa, sb = inter + rng.integers(0, 5, P), inter + rng.integers(0, 5, P)
    assert PF.jaccard_from_counts(inter, sa.astype(float),
                                  sb.astype(float)).tobytes() == \
        RF.jaccard_from_counts(inter, sa.astype(float),
                               sb.astype(float)).tobytes()
