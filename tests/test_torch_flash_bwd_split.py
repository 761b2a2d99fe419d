"""The precision scheme of K8's float32 backward on the tensor cores
(``csrc/flash_attention_bwd.cu``: ``flash_bwd_kv_wg_kernel`` and
``flash_bwd_q_wg_kernel``), transcribed in numpy and held against the
reference's backward, ``jax.vjp`` of its oracle
(``repro.kernels.ops._flash_vjp_bwd``).

The transcription follows the kernels' arithmetic: every product operand
split into TF32 hi and lo with the kernels' integer rounding
(``(bits + 0x1000) & 0xffffe000``, ``tf32_wgmma.cuh:tf32``), the three
terms lo.hi, hi.lo, hi.hi of each 8-wide k-step added in that order into a
float32 accumulator, P as exp2 of the scores times scale log2(e) less lse
log2(e), and the kernels' tile walks and sum orders: dK and dV
a CTA of 64 keys over the G query heads in order and, for each, the
32-query tiles that see the key tile; dQ a CTA of 64 queries over the
32-key tiles it sees; each accumulator folded into a float32 total every
``FOLD_TILES`` tiles (the kernels fold every 32, so these small shapes
fold at 4 to walk the same code).  What a tensor core does inside one
k-step (the order and width of its 8-term sum, the rounding of its adds
into the accumulator) is not modelled: numpy's float32 matmul stands for
it.

Tolerance: ``selfcheck.BWD_RTOL`` (1e-4) of each gradient's largest
magnitude, the bound the card's kernel is held to against its plain
version.  The same walk with one TF32 term (hi.hi) misses it, so the
check can fail.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as RO  # noqa: E402
from repro.kernels import ref as RR  # noqa: E402
from repro_torch.kernels.selfcheck import BWD_RTOL  # noqa: E402

KROWS, QTW = 64, 32          # dK/dV: keys a CTA, queries a tile
QROWS, KTW = 64, 32          # dQ: queries a CTA, keys a tile
FOLD_TILES = 4               # the kernels' is 32; small enough to fold here
L2E = np.float32(1.4426950408889634)


def tf32(x: np.ndarray) -> np.ndarray:
    """The kernels' rounding to TF32 (cvt.rna.tf32.f32's, bit for bit)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def mm(a: np.ndarray, b: np.ndarray, terms: int) -> np.ndarray:
    """a [M, K] @ b [K, N] as the kernels' wgmma sequence: k-steps of 8 in
    order, each adding lo.hi, hi.lo, hi.hi (terms 3) or hi.hi (terms 1)
    to a float32 accumulator."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:
            acc += x[:, k0:k0 + 8] @ y[k0:k0 + 8]
    return acc


def _rows(x: np.ndarray, r0: int, n: int) -> np.ndarray:
    """Rows [r0, r0 + n) of x [S, hd], zero past S (the TMA's fill)."""
    out = np.zeros((n, x.shape[1]), np.float32)
    part = x[r0:r0 + n]
    out[:len(part)] = part
    return out


def k8_bwd_transcribed(q, k, v, o, do, lse, causal, q_offset, terms=3):
    """(dq, dk, dv) as the float32 kernels compute them; q, o, do
    [B, Sq, H, hd], k, v [B, Skv, KV, hd], lse [B, H, Sq], all float32."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, np.float32(1.0 / np.sqrt(hd))
    sl2 = np.float64(scale * L2E)            # the kernels' scale log2(e)
    lse2 = (lse * L2E).astype(np.float32)    # and lse log2(e)

    def prob(s, lse_b):
        """ex2(fmaf(s, scale log2(e), -lse log2(e)))"""
        return np.exp2((s * sl2 - lse_b).astype(np.float32))
    dsum = (do * o).sum(-1, dtype=np.float32).transpose(0, 2, 1)  # [B, H, Sq]
    dq, dk, dv = (np.zeros_like(t) for t in (q, k, v))

    def visible(qi, kj):
        ok = (qi[:, None] < Sq) & (kj[None, :] < Skv)
        if causal:
            ok &= kj[None, :] <= q_offset + qi[:, None]
        return ok

    for b in range(B):
        for kh in range(KV):
            for k0 in range(0, Skv, KROWS):          # the dK/dV kernel
                kt = _rows(k[b, :, kh], k0, KROWS)
                vt = _rows(v[b, :, kh], k0, KROWS)
                keys = k0 + np.arange(KROWS)
                i_lo = max(0, k0 - q_offset) if causal else 0
                adk = np.zeros((KROWS, hd), np.float32)
                adv = np.zeros((KROWS, hd), np.float32)
                tdk = np.zeros((KROWS, hd), np.float32)
                tdv = np.zeros((KROWS, hd), np.float32)
                tiles = [(kh * G + gi, q0) for gi in range(G)
                         for q0 in range(i_lo // QTW * QTW, Sq, QTW)]
                for j, (h, q0) in enumerate(tiles):
                    qt = _rows(q[b, :, h], q0, QTW)
                    dot = _rows(do[b, :, h], q0, QTW)
                    qi = q0 + np.arange(QTW)
                    ls = _rows(lse2[b, h][:, None], q0, QTW)[:, 0]
                    ds = _rows(dsum[b, h][:, None], q0, QTW)[:, 0]
                    st = mm(kt, qt.T, terms)                 # S^T
                    pt = np.where(visible(qi, keys).T, prob(st, ls[None, :]),
                                  np.float32(0)).astype(np.float32)
                    dpt = mm(vt, dot.T, terms)               # dP^T
                    dst = pt * (dpt - ds[None, :])
                    adv += mm(pt, dot, terms)
                    adk += mm(dst, qt, terms)
                    if (j + 1) % FOLD_TILES == 0:
                        tdk, tdv = tdk + adk, tdv + adv
                        adk, adv = adk * 0, adv * 0
                n = min(KROWS, Skv - k0)
                dk[b, k0:k0 + n, kh] = ((tdk + adk) * scale)[:n]
                dv[b, k0:k0 + n, kh] = (tdv + adv)[:n]
        for h in range(H):
            kh = h // G
            for q0 in range(0, Sq, QROWS):                   # the dQ kernel
                qt = _rows(q[b, :, h], q0, QROWS)
                dot = _rows(do[b, :, h], q0, QROWS)
                qi = q0 + np.arange(QROWS)
                ls = _rows(lse2[b, h][:, None], q0, QROWS)
                ds = _rows(dsum[b, h][:, None], q0, QROWS)
                last = min(q0 + QROWS, Sq)
                kv_end = min(Skv, q_offset + last) if causal else Skv
                acc = np.zeros((QROWS, hd), np.float32)
                tot = np.zeros((QROWS, hd), np.float32)
                for j, c0 in enumerate(range(0, kv_end, KTW)):
                    kt = _rows(k[b, :, kh], c0, KTW)
                    vt = _rows(v[b, :, kh], c0, KTW)
                    s = mm(qt, kt.T, terms)
                    p = np.where(visible(qi, c0 + np.arange(KTW)),
                                 prob(s, ls), np.float32(0)
                                 ).astype(np.float32)
                    dp = mm(dot, vt.T, terms)
                    acc += mm(p * (dp - ds), kt, terms)
                    if (j + 1) % FOLD_TILES == 0:
                        tot, acc = tot + acc, acc * 0
                n = min(QROWS, Sq - q0)
                dq[b, q0:q0 + n, h] = ((tot + acc) * scale)[:n]
    return dq, dk, dv


def _lse(q, k, causal, q_offset):
    """The forward's row logsumexp of the scaled scores, [B, H, Sq]."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    kk = np.repeat(k.astype(np.float64), G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(hd)
    if causal:
        mask = np.arange(k.shape[1])[None, :] <= (
            q_offset + np.arange(Sq))[:, None]
        s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1))).astype(np.float32)


def _reference(q, k, v, g, causal, q_offset):
    """The reference's backward: its custom VJP at q_offset 0, else
    jax.vjp of the same oracle with the offset."""
    args = tuple(jnp.asarray(t) for t in (q, k, v, g))
    if q_offset == 0:
        fn = jax.jit(lambda q, k, v, g: RO._flash_vjp_bwd(
            causal, None, None, (q, k, v), g))
    else:
        fn = jax.jit(lambda q, k, v, g: jax.vjp(
            lambda q, k, v: RR.flash_attention_ref(
                q, k, v, causal=causal, q_offset=q_offset), q, k, v)[1](g))
    return [np.asarray(x, np.float32) for x in fn(*args)]


CASES = {
    # G = 4, Sq = 77: ragged 32- and 64-row tiles of both kernels
    "causal": (2, 8, 2, 77, 77, 32, True, 0),
    # queries past an offset over more keys
    "offset": (1, 8, 2, 40, 150, 32, True, 100),
    "full": (1, 8, 2, 50, 100, 16, False, 0),
}


def _case(name):
    B, H, KV, Sq, Skv, hd, causal, q_offset = CASES[name]
    rng = np.random.default_rng(Sq + Skv + hd)
    # scores of a few units, as a trained model's: the softmax is peaked
    # enough that a product's rounding shows in the gradients
    q = (2 * rng.standard_normal((B, Sq, H, hd))).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    o = np.asarray(jax.jit(lambda q, k, v: RR.flash_attention_ref(
        q, k, v, causal=causal, q_offset=q_offset))(q, k, v), np.float32)
    lse = _lse(q, k, causal, q_offset)
    want = _reference(q, k, v, g, causal, q_offset)
    return (q, k, v, o, g, lse, causal, q_offset), want


def _rel_errs(got, want):
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_transcription_matches_reference_vjp(name):
    """The kernels' 3xTF32 walk gives dq, dk and dv within BWD_RTOL of
    the reference's backward."""
    args, want = _case(name)
    errs = _rel_errs(k8_bwd_transcribed(*args, terms=3), want)
    assert max(errs) <= BWD_RTOL, dict(zip(("dq", "dk", "dv"), errs))


def test_1xtf32_transcription_misses_the_tolerance():
    """One TF32 term a product (hi.hi) keeps ~3 digits: the same walk
    misses BWD_RTOL, so the check above can fail."""
    args, want = _case("causal")
    errs = _rel_errs(k8_bwd_transcribed(*args, terms=1), want)
    assert max(errs) > BWD_RTOL, dict(zip(("dq", "dk", "dv"), errs))
