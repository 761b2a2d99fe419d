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
