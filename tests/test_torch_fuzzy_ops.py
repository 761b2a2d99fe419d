"""K4 (``t_occurrence_mask``) and ``fnv1a_hash`` of the PyTorch port
(``repro_torch.kernels.fuzzy_ops``) held against the reference module on
the same numpy inputs: masks exactly at T = 1 and T > 1 (the reference's
host paths and its x64 scatter-count core), hashes bit for bit.

On the CPU the port's wrapper runs K4's plain version; the CUDA kernel is
held against it in test_torch_kernels_gpu.py.  The reference is imported
under a test-side ``jax.experimental.enable_x64`` shim that is removed
again when this module's tests end.
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


def test_fuzzy_kernels_refuse_until_ported():
    with pytest.raises(NotImplementedError, match="fuzzy slice"):
        PF.edit_distances(["tpu"], "tpv", 1)
