"""The PyTorch port's device buffer pool (``repro_torch.kernels.
device_pool``): identity-keyed residency, h2d accounted on first touch
only, eviction at component retirement and when a host array dies.
Runs on the CPU device (the plain-version path); the pool logic is the
same on the card."""

import gc
import types

import numpy as np
import pytest

import repro_torch
from repro_torch import obs
from repro_torch.kernels import columnar_ops as K
from repro_torch.kernels.device_pool import DevicePool, pool


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _h2d(fn):
    k0 = obs.kernel_totals()
    out = fn()
    return out, obs.kernel_totals()[1] - k0[1]


def test_h2d_on_first_touch_only():
    """Operands arrive pow2-padded (``Column.padded``), so the arrays the
    wrapper hands the pool are the caller's own, stable ones."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, 1024, dtype=np.int64)
    v = rng.random(1024) < 0.9
    preds = [(x, v, 10, 50)]
    m1, cold = _h2d(lambda: K.range_mask(preds, 1000))
    m2, warm = _h2d(lambda: K.range_mask(preds, 1000))
    np.testing.assert_array_equal(m1, m2)
    assert cold == x.nbytes + v.nbytes and warm == 0
    _, warm_agg = _h2d(lambda: K.fused_filter_aggregate(
        preds, [(x, v)], 1000))
    assert warm_agg == 0     # same operands, another kernel: still resident


@pytest.mark.parametrize("n", [5, 1024])
def test_get_reports_residency(n):
    p = DevicePool()
    a = np.arange(n, dtype=np.int64)
    t, hit = p.get(a)
    assert not hit and t.dtype.is_floating_point is False
    t2, hit2 = p.get(a)
    assert hit2 and t2 is t
    assert p.resident_bytes() == a.nbytes
    out, missed = p.fetch([a, np.arange(3.0), "not-an-array"])
    assert out[0] is t and len(missed) == 1 and out[2] == "not-an-array"


def test_release_component_frees_buffers():
    p = DevicePool()
    keys = np.arange(64, dtype=np.int64)
    tomb = np.zeros(64, bool)
    post = types.SimpleNamespace(keys=np.arange(4), offsets=np.arange(5),
                                 positions=np.arange(64),
                                 has_value=np.ones(64, bool), _padded=None)
    comp = types.SimpleNamespace(keys=keys, tomb=tomb, batch=None,
                                 sec_postings={"f": post}, gram_postings={})
    other = np.arange(5.0)
    p.fetch([keys, tomb, post.positions, p.padded(other)])
    assert p.entry_count() == 4
    p.release_component(comp)
    assert p.entry_count() == 1       # only the unrelated padded array
    assert p.resident_bytes() == 8 * 8


def test_weakref_finalizer_evicts_dropped_array():
    p = DevicePool()
    a = np.arange(100, dtype=np.float64)
    p.get(a)
    assert p.entry_count() == 1
    del a
    gc.collect()
    assert p.entry_count() == 0 and p.resident_bytes() == 0


def test_padded_memo_is_identity_stable():
    a = np.arange(5, dtype=np.int64)
    pa = pool.padded(a)
    assert pa is pool.padded(a) and pa.shape == (8,) and pa[-1] == 4
    z = pool.padded(a, fill="zero")
    assert z[-1] == 0 and z is pool.padded(a, fill="zero")


def test_lsm_merge_releases_retired_components():
    """Merging retires components; their pooled buffers leave the pool."""
    from repro_torch.core.lsm import LSMIndex, TieredMergePolicy
    ix = LSMIndex(flush_threshold=4, merge_policy=TieredMergePolicy(k=99))
    for i in range(12):
        ix.insert(i, {"id": i, "w": i * 2})
    ix.flush()
    comps = [c for c in ix.components if c.valid]
    before = pool.entry_count()
    pool.fetch([c.keys for c in comps])
    assert pool.entry_count() == before + len(comps)
    ix.merge(comps)
    assert pool.entry_count() <= before + 1
