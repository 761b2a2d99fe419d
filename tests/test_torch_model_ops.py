"""The model-stack kernels of the PyTorch port (K7 rmsnorm, K8 flash
attention, K9 LSM decode attention, ``kernels/model_ops``) held against
the reference on the same numpy inputs: against its oracles
(``repro.kernels.ref``) and against its Pallas kernels run in interpret
mode (``repro.kernels.ops``, ``decode_partial``), on a subset of the
shapes of ``tests/test_kernels.py``, in float32 and bfloat16.

On the CPU the port's wrappers run the kernels' plain versions; the CUDA
kernels are held against those in test_torch_kernels_gpu.py.

Tolerances: float32 2e-5 (the reference's own kernel-vs-oracle bound,
test_kernels.py:27: the same sums in another order); bfloat16 2e-2 for
outputs rounded to bfloat16 (a few units of its 2^-8 precision) and 2e-1
for the un-normalized decode state, as test_kernels.py:107 allows.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.kernels import ops as RO  # noqa: E402
from repro.kernels import ref as RR  # noqa: E402
from repro.kernels.lsm_decode_attention import decode_partial as r_partial  # noqa: E402
from repro_torch.kernels import lsm_decode_attention as LD  # noqa: E402
from repro_torch.kernels import model_ops as PO  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.lsm_decode_attention import decode_partial  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _pair(rng, shape, dtype):
    """The same values for both packages (bf16 rounds to nearest even in
    both)."""
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _jit(fn, *args, **static):
    """Call a reference function under ``jax.jit`` (one compile is far
    cheaper than jax's op-by-op dispatch), ``static`` bound as constants."""
    return jax.jit(lambda *a: fn(*a, **static))(*args)


# ---------------------------------------------------------------------------
# K7 rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 64), (100, 96), (4, 7, 128)])
def test_rmsnorm_matches_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(rng, shape, dtype)
    jw, tw = _pair(rng, shape[-1:], "float32")
    got = PO.rmsnorm(tx, tw)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    _close(got, _jit(RR.rmsnorm_ref, jx, jw), TOL[dtype])
    _close(got, _jit(RO.rmsnorm, jx, jw), TOL[dtype])


# ---------------------------------------------------------------------------
# K8 flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk,dtype", [
    (1, 128, 4, 4, 64, 64, 64, "float32"),        # MHA
    (2, 256, 8, 2, 32, 128, 64, "float32"),       # GQA 4:1
    (2, 256, 8, 2, 32, 128, 64, "bfloat16"),
])
def test_flash_attention_matches_reference(B, S, H, KV, hd, bq, bk, dtype):
    rng = np.random.default_rng(B * S + H)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    ((B, S, H, hd), (B, S, KV, hd),
                                     (B, S, KV, hd)))
    got = PO.flash_attention(tq, tk, tv, True)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    _close(got, _jit(RR.flash_attention_ref, jq, jk, jv, causal=True),
           TOL[dtype])
    _close(got, _jit(lambda q, k, v: RO.flash_attention(q, k, v, True, bq,
                                                        bk), jq, jk, jv),
           TOL[dtype])


@pytest.mark.parametrize("causal,S", [(False, 128), (True, 100)])
def test_flash_attention_noncausal_and_unaligned(causal, S):
    rng = np.random.default_rng(S)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (1, S, 2, 32), "float32")
                                    for _ in range(3))
    got = PO.flash_attention(tq, tk, tv, causal)
    _close(got, _jit(RR.flash_attention_ref, jq, jk, jv, causal=causal),
           2e-5)
    _close(got, _jit(lambda q, k, v: RO.flash_attention(q, k, v, causal, 64,
                                                        64), jq, jk, jv),
           2e-5)


def test_flash_attention_q_offset_and_valid_length():
    """K8's two masks: a query offset (query i at position q_offset + i)
    and a valid key length (keys past it are never seen)."""
    rng = np.random.default_rng(3)
    (jq, tq) = _pair(rng, (2, 8, 4, 16), "float32")
    (jk, tk), (jv, tv) = (_pair(rng, (2, 40, 2, 16), "float32")
                          for _ in range(2))
    got = flash_attention_fwd(tq, tk, tv, True, q_offset=20, kv_len=26)
    want = _jit(RR.flash_attention_ref, jq, jk[:, :26], jv[:, :26],
                causal=True, q_offset=20)
    _close(got, want, 2e-5)


def test_reference_flash_sq_above_skv_padding_fault():
    """The reference's ``ops.flash_attention`` with causal, Sq > Skv and
    Skv not a block multiple lets the zero-padded keys into the softmax
    (the bare ``pass`` at repro/kernels/ops.py:69-72); the port follows the
    oracle.  With Sq < Skv the reference kernel agrees with its oracle."""
    rng = np.random.default_rng(0)
    deviation = {}
    for name, sq, skv in (("sq_above_skv", 40, 24), ("sq_below_skv", 24, 40)):
        jq, tq = _pair(rng, (1, sq, 4, 16), "float32")
        (jk, tk), (jv, tv) = (_pair(rng, (1, skv, 2, 16), "float32")
                              for _ in range(2))
        oracle = _jit(RR.flash_attention_ref, jq, jk, jv, causal=True)
        got = PO.flash_attention(tq, tk, tv, True)
        _close(got, oracle, 2e-5)
        ref_kernel = _jit(lambda q, k, v: RO.flash_attention(
            q, k, v, True, 16, 16), jq, jk, jv)
        deviation[name] = (float(np.abs(_np(ref_kernel) - _np(oracle)).max()),
                           float(np.abs(_np(ref_kernel) - _np(got)).max()))
    # the fault: the padded keys shift the reference kernel's answer
    assert min(deviation["sq_above_skv"]) > 0.05, deviation
    assert max(deviation["sq_below_skv"]) < 2e-5, deviation


def test_flash_attention_grad_matches_oracle_vjp():
    """K8's backward (recomputed through the plain oracle) against
    ``jax.vjp`` of the reference oracle."""
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (1, 64, 2, 16), "float32")
                                    for _ in range(3))
    jg, tg = _pair(rng, (1, 64, 2, 16), "float32")
    want = _jit(lambda q, k, v, g: jax.vjp(
        lambda q, k, v: RR.flash_attention_ref(q, k, v, causal=True),
        q, k, v)[1](g), jq, jk, jv, jg)
    qkv = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = PO.flash_attention(*qkv, True)
    out.backward(tg)
    for t, w in zip(qkv, want):
        _close(t.grad, w, 1e-4)


# ---------------------------------------------------------------------------
# K9 LSM decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,hd,Sc,dtype", [
    (2, 8, 4, 32, 256, "float32"), (2, 8, 4, 32, 256, "bfloat16"),
    (3, 6, 2, 16, 384, "float32")])
def test_decode_partial_matches_reference(B, H, KV, hd, Sc, dtype):
    rng = np.random.default_rng(Sc + H)
    jq, tq = _pair(rng, (B, H, hd), dtype)
    (jk, tk), (jv, tv) = (_pair(rng, (B, Sc, KV, hd), dtype)
                          for _ in range(2))
    vl = Sc - 17
    got = decode_partial(tq, tk, tv, vl)
    tol = 10 * TOL[dtype]
    for g, w, k in zip(got, _jit(RR.decode_partial_ref, jq, jk, jv,
                                 valid_len=vl),
                       _jit(r_partial, jq, jk, jv, valid_len=jnp.int32(vl),
                            block_k=128, interpret=True)):
        assert g.dtype == torch.float32
        _close(g, w, tol)
        _close(g, k, tol)


@pytest.mark.parametrize("vl", [0, 1, 100])
def test_decode_partial_empty_and_partial_components(vl):
    """An empty component (an empty L1 slot) gives acc 0, m NEG_INF,
    l 0, as the reference does; a partial one masks its tail."""
    rng = np.random.default_rng(vl)
    jq, tq = _pair(rng, (2, 4, 16), "float32")
    (jk, tk), (jv, tv) = (_pair(rng, (2, 128, 2, 16), "float32")
                          for _ in range(2))
    got = decode_partial(tq, tk, tv, vl)
    for g, w in zip(got, _jit(RR.decode_partial_ref, jq, jk, jv,
                              valid_len=vl)):
        _close(g, w, 2e-5)
    if vl == 0:
        assert torch.all(got[0] == 0) and torch.all(got[2] == 0)
        assert torch.all(got[1] == PR.NEG_INF)


def test_lsm_merge_equals_flat_attention():
    """Attention over components merged associatively equals flat
    attention over their valid rows (the LSM merge-correctness property),
    in the port and against the reference's oracle."""
    rng = np.random.default_rng(5)
    B, H, KV, hd = 2, 4, 2, 32
    jq, tq = _pair(rng, (B, H, hd), "float32")
    comps, jks, jvs = [], [], []
    for sc, vl in [(128, 128), (128, 40), (256, 200), (64, 0)]:
        (jk, tk), (jv, tv) = (_pair(rng, (B, sc, KV, hd), "float32")
                              for _ in range(2))
        comps.append((tk, tv, vl))
        jks.append(jk[:, :vl])
        jvs.append(jv[:, :vl])
    got = PO.lsm_decode_attention(tq, comps)
    want = _jit(RR.flash_attention_ref, jq[:, None], jnp.concatenate(jks, 1),
                jnp.concatenate(jvs, 1), causal=False)[:, 0]
    _close(got, want, 2e-5)


@pytest.mark.parametrize("n_parts,seed", [(1, 0), (2, 1), (3, 2), (5, 3)])
def test_merge_partials_associative_and_matches_reference(n_parts, seed):
    rng = np.random.default_rng(seed)
    parts = [(rng.normal(size=(2, 3, 8)).astype(np.float32),
              rng.normal(size=(2, 3)).astype(np.float32),
              rng.uniform(0.5, 2.0, size=(2, 3)).astype(np.float32))
             for _ in range(n_parts)]
    tparts = [tuple(map(torch.from_numpy, p)) for p in parts]
    a = PR.merge_partials_ref(tparts)
    _close(a, PR.merge_partials_ref(tparts[::-1]), 1e-5)
    _close(a, RR.merge_partials_ref([tuple(map(jnp.asarray, p))
                                     for p in parts]), 1e-5)


# ---------------------------------------------------------------------------
# K9 and K7 on the card split their work over a thread-block cluster: the
# split rules and the rank-order merge, on the CPU
# ---------------------------------------------------------------------------

def _cluster_merge(parts):
    """The kernel's in-cluster merge of rank states, in rank order: M the
    largest m, acc and l the sums of each rank's scaled by exp(m_r - M);
    ranks with m = NEG_INF (empty ranges) are skipped, so exp(NEG_INF -
    NEG_INF) is never taken."""
    M = torch.stack([m for _, m, _ in parts]).amax(0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for a, m, lr in parts:
        live = m != PR.NEG_INF
        w = torch.where(live, torch.exp(torch.where(live, m - M, 0.0)), 0.0)
        acc = acc + w[..., None] * a
        l = l + w * lr
    return acc, M, l


@pytest.mark.parametrize("vl", [0, 1, 63, 64, 65, 768, 831])
@pytest.mark.parametrize("C", [1, 2, 8])
def test_k9_split_and_merge_match_unsplit(vl, C):
    """The valid rows split into C ranges by the wrapper's rule, each
    range through decode_partial_ref (an empty one is the (0, NEG_INF, 0)
    the kernel keeps for it) and merged in rank order, give the unsplit
    state within 1e-6 of each output's largest magnitude (float32 sums in
    another order; an empty component's NEG_INF max exactly), no NaN."""
    rng = np.random.default_rng(vl * 10 + C)
    B, H, KV, hd, Sc = 2, 16, 2, 16, 832
    q = torch.from_numpy(rng.normal(size=(B, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, Sc, KV, hd))
                             .astype(np.float32)) for _ in range(2))
    ranges = LD.split_ranges(vl, C)
    assert len(ranges) == C and ranges[0][0] == 0 and ranges[-1][1] == vl
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    parts = []
    for lo, hi in ranges:
        if hi == lo:
            parts.append((torch.zeros(B, H, hd),
                          torch.full((B, H), PR.NEG_INF), torch.zeros(B, H)))
        else:
            parts.append(PR.decode_partial_ref(q, k[:, lo:hi], v[:, lo:hi],
                                               hi - lo))
    got = _cluster_merge(parts)
    want = PR.decode_partial_ref(q, k, v, vl)
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()
        live = w.abs() < 1e29
        scale = max(1.0, float(w[live].abs().max()) if live.any() else 0.0)
        assert float((g - w).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("vl,pairs,want,last", [
    (0, 64, 1, (0, 0)),            # an empty L1 slot
    (63, 64, 1, (0, 63)),          # the tail
    (64, 64, 1, (0, 64)),          # a full L1 slot
    (768, 64, 2, (384, 768)),      # the serve path's L2
    (831, 64, 2, (448, 831)),      # its flat cache
    (513, 8, 5, (512, 513)),       # ranks of whole tiles, none empty
    (897, 8, 8, (896, 897)),       # one row past the last boundary
    (1000, 8, 8, (896, 1000)),
    (4096, 600, 1, (0, 4096)),     # one CTA a pair already fills the card
])
def test_k9_cluster_size_rule(vl, pairs, want, last):
    """C is the largest that keeps a 64-row tile a rank, leaves no rank
    empty and lets every pair's cluster be resident (clusters an H100
    holds of K9 at G = 8, hd = 128, float32: 132 of 1 CTA down to 15 of
    8)."""
    resident = {1: 132, 2: 66, 3: 39, 4: 30, 5: 20, 6: 17, 7: 16, 8: 15}
    C = LD.cluster_size(vl, pairs, resident.get)
    assert C == want
    ranges = LD.split_ranges(vl, C)
    assert ranges[-1] == last and all(hi > lo for lo, hi in ranges[:-1])
    assert all(lo % LD.TILE_ROWS == 0 for lo, _ in ranges)


@pytest.mark.parametrize("N,d,dtype,aligned,want", [
    (8, 8192, torch.float32, True, 8),       # a decode step
    (66, 8192, torch.float32, True, 8),      # the threshold
    (67, 8192, torch.float32, True, 1),      # past it
    (4096, 8192, torch.float32, True, 1),    # the prefill
    (8, 8192, torch.bfloat16, True, 8),
    (8, 16, torch.float32, True, 4),         # 4 vectors a row
    (8, 16, torch.bfloat16, True, 2),        # 2 vectors a row
    (8, 96, torch.bfloat16, True, 4),        # 12 vectors a row
    (8, 8196, torch.float32, True, 1),       # 2049 vectors: no even split
    (8, 10001, torch.float32, True, 1),      # not whole vectors
    (8, 8192, torch.float32, False, 1),      # rows not 16-byte aligned
])
def test_k7_cluster_size_rule(N, d, dtype, aligned, want):
    assert RN.cluster_size(N, d, dtype, aligned) == want


@pytest.mark.parametrize("B,H,KV,Sq,want", [
    (8, 64, 8, 512, (8, 16, 2048)),     # the serve prefill, G = 8
    (1, 512, 64, 512, (8, 16, 2048)),   # the same in the fused layout
    (2, 8, 2, 77, (4, 32, 12)),         # G = 4
    (2, 6, 2, 77, (1, 128, 12)),        # G = 3: one head a CTA
    (2, 12, 2, 77, (2, 64, 24)),        # G = 6
    (1, 4, 4, 1, (1, 128, 4)),          # MHA, one query
])
def test_k8_launch_plan_rule(B, H, KV, Sq, want):
    """K8's CTA covers GH heads of a KV head over BQ queries (GH * BQ =
    128 rows, 16 a warp); the plan is a function of the shape alone."""
    from repro_torch.kernels import flash_attention as FA
    assert FA.launch_plan(B, H, KV, Sq) == want
    GH, BQ, _ = want
    assert GH * BQ == 128 and (H // KV) % GH == 0

