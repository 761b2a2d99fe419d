"""On-card checks and timings of the port's kernels against their plain
versions, at the shapes the main path gives them.

``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py`` use this module;
it needs a CUDA device.  Every case builds its inputs from a numpy seed on
the card, runs the kernel and its plain PyTorch version on the same
tensors, and compares them: masks, counts and distances exactly,
float64 sums bit for bit (or both NaN: K2's ``_agg_compare``, whose
mins and maxes are equal values, and rungs 3 and 4's ``raw_compare``,
bit for bit everywhere), and the model
kernels' float32 results within ``MODEL_RTOL`` (bfloat16 outputs within
``BF16_RTOL``) of the largest reference magnitude.

Two times are taken per call, with the L2 cache flushed before each call
(the main path meets its operands cold): ``ms``, the device time of the
kernels the call runs (the union of the CUDA kernel, memset and copy
spans ``torch.profiler`` records, less the flush's own, so launches that
overlap count once), and ``call_ms``, CUDA events
around the Python call, which adds the host's launch overhead.  Where the
profiler records no device time at all, ``ms`` is the CUDA-event time and
the case's ``ms_timer`` reads ``cuda_events``.  The bound
is the least time the card could take: the bytes the function must move
(each input read once, each output written once) over device memory
bandwidth, or its operations over the card's rate for them, whichever is
larger.  Scalar operations count at the non-tensor-core rate; K8, whose
products run on the tensor cores, also states its tensor-core time
(``tc_s``) and keeps the float32 non-tensor bound beside it
(``bound_fp32_ms``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import chain_ops as CH
from . import columnar_ops as CO
from . import flash_attention as FA
from . import fuzzy_ops as FO
from . import lsm_decode_attention as LD
from . import rmsnorm as RN
from . import spmd_ops as SO
from .columnar_ops import _prep_bounds

__all__ = ["KERNELS", "MODEL_RTOL", "BF16_RTOL",
           "launch_counts", "reset_launch_counts", "launch_splits",
           "k1_case", "k2_case",
           "k3_arrays", "k3_case", "k4_case", "k4_path_case", "k5_case",
           "k6_arrays", "k6_case", "K3_CANDS", "K6_LENS",
           "a7_case", "a7_clustered_arrays", "a7_clustered_case",
           "rows_touched",
           "k7_case",
           "k8_case", "k9_case", "main_path_cases", "serve_cases",
           "k7_bwd_case", "k8_bwd_case", "train_cases", "BWD_RTOL",
           "a6_case", "k1_rows_case", "k2_rows_case", "exchange_case",
           "merge_case", "rung_cases", "raw_compare",
           "run_case", "device_ms", "profiler_works", "union_us"]

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth and the FP32 rate outside
# the tensor cores, the rate used for the kernels' scalar integer
# compares, adds and mins
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# dense tensor-core rates (hopper-kernels guide, section 1)
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
# float32 model kernels against their plain versions: the same sums
# (8192-term squares, 128-term dot products, softmax sums over up to 1,088
# keys) in another order move a result by a few 1e-7 of the largest
# magnitude; 1e-5 leaves a wide margin and still catches a wrong mask, a
# wrong head mapping or a lost tile (errors of order 1e-1)
MODEL_RTOL = 1e-5
# bfloat16 outputs: one rounding step (2^-8 relative) either side
BF16_RTOL = 2.0 ** -7
# float32 gradients of the backward kernels against autograd of the plain
# versions: K8's dq, dk, dv sum up to Skv (or G * Sq) products of
# probabilities the kernel recomputes from the forward's logsumexp (the
# plain version normalizes its own softmax), and K7's dw sums N rows in
# another order; both move a gradient by ~1e-6 of its largest magnitude.
# 1e-4 of it leaves that margin 100 times over and still fails a wrong
# mask, a lost tile or a wrong head (errors of order 1e-1)
BWD_RTOL = 1e-4

KERNELS = {
    "range_mask": {
        "source": "src/repro_torch/kernels/csrc/range_mask.cu",
        "replaces": "src/repro/kernels/columnar_ops.py:234",
        "wrapper": CO.range_mask_cuda},
    "fused_filter_aggregate": {
        "source": "src/repro_torch/kernels/csrc/filter_aggregate.cu",
        "replaces": "src/repro/kernels/columnar_ops.py:243",
        "wrapper": CO.filter_aggregate_cuda},
    "sorted_intersect_mask": {
        "source": "src/repro_torch/kernels/csrc/sorted_intersect.cu",
        "replaces": "src/repro/kernels/columnar_ops.py:455",
        "wrapper": CO.sorted_intersect_cuda},
    "t_occurrence_mask": {
        "source": "src/repro_torch/kernels/csrc/t_occurrence.cu",
        "replaces": "src/repro/kernels/fuzzy_ops.py:112",
        "wrapper": FO.tocc_cuda},
    "edit_distances": {
        "source": "src/repro_torch/kernels/csrc/edit_distance.cu",
        "replaces": "src/repro/kernels/fuzzy_ops.py:282",
        "wrapper": FO.ed_cuda},
    "set_intersect_counts": {
        "source": "src/repro_torch/kernels/csrc/set_intersect.cu",
        "replaces": "src/repro/kernels/fuzzy_ops.py:392",
        "wrapper": FO.inter_cuda},
    "bitset_intersect_counts": {
        "source": "src/repro_torch/kernels/csrc/bitset_intersect.cu",
        "replaces": "src/repro/kernels/fuzzy_ops.py:501",
        "wrapper": FO.popcount_cuda},
    "rmsnorm": {
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:19",
        "wrapper": RN.rmsnorm_cuda},
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "wrapper": FA.flash_cuda},
    "lsm_decode_attention": {
        "source": "src/repro_torch/kernels/csrc/lsm_decode_attention.cu",
        "replaces": "src/repro/kernels/lsm_decode_attention.py:32",
        "wrapper": LD.decode_partial_cuda},
    # the training path's backward kernels: XLA's autodiff of the plain
    # rms_norm there, and the Pallas kernel's custom VJP (the oracle's)
    "rmsnorm_bwd": {
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/models/layers.py:164",
        "wrapper": RN.rmsnorm_bwd_cuda},
    "flash_attention_bwd": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:86",
        "wrapper": FA.flash_bwd_cuda},
    # the query path's rungs 3 and 4: jit cores of the reference, each one
    # launch there (no pallas_call)
    "fused_index_chain": {
        "source": "src/repro_torch/kernels/csrc/fused_chain.cu",
        "replaces": "src/repro/columnar/plancache.py:116",
        "wrapper": CH.chain_cuda},
    "range_mask_stacked": {
        "source": "src/repro_torch/kernels/csrc/range_mask.cu",
        "replaces": "src/repro/runtime/spmd.py:333",
        "wrapper": SO.range_mask_rows_cuda},
    "filter_aggregate_stacked": {
        "source": "src/repro_torch/kernels/csrc/filter_aggregate.cu",
        "replaces": "src/repro/runtime/spmd.py:357",
        "wrapper": SO.filter_aggregate_rows_cuda},
    "spmd_exchange": {
        "source": "src/repro_torch/kernels/csrc/spmd_ops.cu",
        "replaces": "src/repro/runtime/spmd.py:568",
        "wrapper": SO.exchange_cuda},
    "spmd_merge": {
        "source": "src/repro_torch/kernels/csrc/spmd_ops.cu",
        "replaces": "src/repro/runtime/spmd.py:678",
        "wrapper": SO.merge_cuda},
}


# counters kept beside ``launches``: K4's launches at T = 1 and by its
# sorted row-tile kernel (the rest are T > 1 by the scatter kernel),
# A6's dispatches that zeroed its pooled flags first (a memset before the
# scatter and the second pass), and stacked K2's launches that took its
# first design (operands not all 16-byte aligned, or n not a multiple of
# 16)
SPLIT_COUNTERS = {"t_occurrence_mask": ("launches_t1", "launches_sorted"),
                  "fused_index_chain": ("clears",),
                  "filter_aggregate_stacked": ("launches_first",)}


def launch_counts() -> Dict[str, int]:
    return {k: v["wrapper"].launches for k, v in KERNELS.items()}


def launch_splits() -> Dict[str, Dict[str, int]]:
    """K4's launches split by threshold and route: {"T=1": .., "T>1
    sorted": .., "T>1 scatter": ..}."""
    w = KERNELS["t_occurrence_mask"]["wrapper"]
    return {"t_occurrence_mask": {
        "T=1": w.launches_t1, "T>1 sorted": w.launches_sorted,
        "T>1 scatter": w.launches - w.launches_t1 - w.launches_sorted}}


def _counters() -> Dict[Tuple[str, str], int]:
    out = {(k, "launches"): v["wrapper"].launches for k, v in KERNELS.items()}
    for k, attrs in SPLIT_COUNTERS.items():
        for attr in attrs:
            out[(k, attr)] = getattr(KERNELS[k]["wrapper"], attr)
    return out


def _set_counters(values: Dict[Tuple[str, str], int]) -> None:
    for (k, attr), n in values.items():
        setattr(KERNELS[k]["wrapper"], attr, n)


def reset_launch_counts() -> None:
    _set_counters(dict.fromkeys(_counters(), 0))


# ---------------------------------------------------------------------------
# cases: inputs from a numpy seed, on the card
# ---------------------------------------------------------------------------

def _view(x: np.ndarray, skip: int, dev: torch.device) -> torch.Tensor:
    """``x`` on the card as a view that starts ``skip`` elements into
    its storage (0: the tensor itself)."""
    if not skip:
        return torch.from_numpy(x).to(dev)
    return torch.from_numpy(np.concatenate([x[:skip], x])).to(dev)[skip:]


def _columns(rng: np.random.Generator, n: int, kinds: List[str],
             bounds: bool, dev: torch.device,
             offset: Tuple[int, int] = (0, 0)) -> list:
    """TinySocial-like columns: int64 epoch-microsecond timestamps (far
    beyond 2**24), int64 ids, float64 with NaN (or without: "f64n"; or
    every third row NaN, every other row valid: "nan"), int32 dictionary
    codes, and int64 counts of which a predicate keeps ~98% ("loose", no
    upper bound: many of them ANDed still keep rows).  ``offset`` (data elements, validity
    bytes): each column's data and validity are views that start that far
    into their storage."""
    cols = []
    for kind in kinds:
        valid = rng.random(n) < 0.95
        if kind == "ts":
            x = 1_388_534_400_000_000 + rng.integers(
                0, 120 * 86_400_000_000, n, dtype=np.int64)
            lo, hi = 1_391_212_800_000_000, 1_396_000_000_000_000
        elif kind == "id":
            x = rng.integers(0, 200_000, n, dtype=np.int64)
            lo, hi = 1_000, 150_000
        elif kind in ("f64", "f64n", "nan"):   # "f64n": no NaN
            x = rng.normal(1e3, 3e2, n)
            if kind == "f64":
                x[rng.random(n) < 0.01] = np.nan
            elif kind == "nan":     # every third row NaN, valid or not
                x[::3] = np.nan
                valid[::2] = True
                valid[1::2] = False
            lo, hi = 900.0, None
        elif kind == "loose":
            x = rng.integers(0, 1000, n, dtype=np.int64)
            valid = rng.random(n) < 0.995
            lo, hi = 10, None
        else:                                  # "code": int32 dictionary
            x = rng.integers(0, 50, n).astype(np.int32)
            lo, hi = 5, 40
        blo, bhi = _prep_bounds(x, lo, hi) if bounds else (None, None)
        cols.append((_view(x, offset[0], dev), _view(valid, offset[1], dev),
                     blo, bhi))
    return cols


def _col_bytes(cols: list, n: int) -> int:
    return sum(c[0].element_size() * n + n for c in cols)


def k1_case(n: int, kinds: List[str], seed: int, dev: torch.device,
            offset: Tuple[int, int] = (0, 0)) -> Dict[str, Any]:
    """K1 over ``kinds`` columns (``_columns``); ``offset``: views that
    start (data elements, validity bytes) into their storage."""
    rng = np.random.default_rng(seed)
    cols = _columns(rng, n, kinds, True, dev, offset)
    label = f"n={n} K={len(cols)} {','.join(kinds)}" \
        + (f" views offset {offset}" if any(offset) else "")
    return {"kernel": "range_mask", "label": label,
            "run": lambda: CO.range_mask_cuda(cols, n),
            "plain": lambda: CO.range_mask_plain(cols, n),
            "library": None,
            "compare": _mask_compare,
            "bytes": _col_bytes(cols, n) + n,
            "ops": 2 * len(cols) * n}


def _same_value(a: Any, b: Any, zero_sign: bool) -> bool:
    """Python scalars equal, or both NaN; ``zero_sign``: a float's sign
    of zero too (bit for bit but a NaN's payload)."""
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b and (not zero_sign or math.copysign(1.0, a)
                           == math.copysign(1.0, b))
    return a == b


def _agg_compare(got: torch.Tensor, ref: tuple, acols: list) -> float:
    """0.0 when K2's raw row decodes to its plain version's result: the
    counts exactly, every sum bit for bit or both NaN (the
    float64 sums fold in the reference's order on both), every min and
    max equal or both NaN (which zero torch's min / max return is their
    own); inf otherwise."""
    total, per_col = CO.decode_aggregate(got.cpu().numpy(), acols)
    rtotal, rper = ref
    if total != rtotal:
        return math.inf
    for (s, mn, mx, c), (rs, rmn, rmx, rc) in zip(per_col, rper):
        if c != rc or not _same_value(s, rs, True):
            return math.inf
        if c and not (_same_value(mn, rmn, False)
                      and _same_value(mx, rmx, False)):
            return math.inf
    return 0.0


def k2_case(n: int, pred_kinds: List[str], agg_kinds: List[str], seed: int,
            dev: torch.device) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    pcols = _columns(rng, n, pred_kinds, True, dev)
    acols = _columns(rng, n, agg_kinds, False, dev)
    u = CO.sum32_unroll(n, len(pcols))
    return {"kernel": "fused_filter_aggregate",
            "label": f"n={n} K={len(pcols)} M={len(acols)}"
            + (f" (the reference's 32-slot sum order, U={u})" if u else ""),
            "run": lambda: CO.filter_aggregate_cuda(pcols, acols, n, dev),
            "plain": lambda: CO.filter_aggregate_plain(pcols, acols, n, dev),
            "library": None,
            "compare": lambda got, ref: _agg_compare(got, ref, acols),
            "pcols": pcols, "acols": acols,
            "bytes": _col_bytes(pcols, n) + _col_bytes(acols, n)
            + 8 * (1 + 4 * len(acols)),
            "ops": (2 * len(pcols) + 4 * len(acols)) * n}


def _mask_compare(got: torch.Tensor, ref: torch.Tensor) -> float:
    return 0.0 if torch.equal(got, ref) else 1.0


def _edge_pad(x: np.ndarray) -> np.ndarray:
    """``x`` padded to a power of two by repeating its last element, as
    ``device_pool.padded(x, "edge")`` pads K3's operands."""
    np2 = 1 << max(0, int(x.shape[0]) - 1).bit_length()
    return np.concatenate([x, np.full(np2 - x.shape[0], x[-1], x.dtype)])


K3_CANDS = ("subset", "wide", "gaps", "shuffled")


def k3_arrays(n: int, m: int, seed: int, dtype: Any = np.int64,
              cands: str = "subset", pad: bool = False
              ) -> Tuple[np.ndarray, int, np.ndarray]:
    """(keys, n, cands) for K3: ``n`` sorted distinct keys and about
    ``m`` sorted candidates.  ``cands`` picks their shape:

    - ``"subset"``: the merge shape, ``m`` of the keys (every component key
      is in the union, as in sorted_merge_take);
    - ``"wide"``: the PK-bitmap shape, candidates drawn over the keys'
      range independently of them, so few are keys and a tile's window is
      ``m / n`` times the tile;
    - ``"gaps"``: candidates only in two narrow stretches, so most tiles
      hold none of them and some lie past every candidate;
    - ``"shuffled"``: the ``"wide"`` candidates, the keys out of order
      (outside K3's contract; the kernel searches such keys from global
      memory and stays exact).

    ``pad`` repeats each array's last element to a power of two, as the
    device pool does (duplicates at both arrays' ends)."""
    rng = np.random.default_rng(seed)
    if cands == "subset":
        keys = np.unique(rng.integers(0, 4 * n, 2 * n, dtype=np.int64))[:n]
        n = int(keys.shape[0])
        cs = np.sort(rng.choice(keys, m, replace=False))
    elif cands in ("wide", "shuffled"):
        span = 2 * max(n, m)
        keys = np.unique(rng.integers(0, span, n, dtype=np.int64))
        cs = np.unique(rng.integers(0, span, m, dtype=np.int64))
    elif cands == "gaps":
        keys = np.unique(rng.integers(0, 8 * n, n, dtype=np.int64))
        mid = keys[(keys >= 2 * n) & (keys < 3 * n)]
        cs = np.unique(np.concatenate([
            rng.choice(mid if mid.size else keys[:1], m // 2),
            rng.integers(5 * n, 5 * n + max(1, n // 8), m - m // 2)]))
    else:
        raise ValueError(f"k3_arrays: cands must be one of {K3_CANDS}")
    keys, cs = keys.astype(dtype), cs.astype(dtype)
    if cands == "shuffled":
        rng.shuffle(keys)
    n = int(keys.shape[0])
    if pad:
        keys, cs = _edge_pad(keys), _edge_pad(cs)
    return keys, n, cs


def k3_case(n: int, m: int, seed: int, dev: torch.device,
            dtype: torch.dtype = torch.int64, cands: str = "subset",
            pad: bool = False) -> Dict[str, Any]:
    """K3 on ``k3_arrays``' inputs; the defaults give the merge shape
    (``n`` union keys, one component's ``m`` keys)."""
    keys_np, n, cands_np = k3_arrays(
        n, m, seed, np.float64 if dtype == torch.float64 else np.int64,
        cands, pad)
    keys = torch.from_numpy(keys_np).to(dev)
    cands_t = torch.from_numpy(cands_np).to(dev)
    n_out, m = int(keys.shape[0]), int(cands_t.shape[0])
    label = f"n={n} m={m}" + (f" n_out={n_out}" if n_out != n else "") \
        + (f" {cands}" if cands != "subset" else "")
    return {"kernel": "sorted_intersect_mask", "label": label,
            "run": lambda: CO.sorted_intersect_cuda(keys, n, cands_t),
            "plain": lambda: CO.sorted_intersect_plain(keys, n, cands_t),
            "library": lambda: torch.isin(keys, cands_t),
            "compare": _mask_compare,
            "bytes": 8 * n_out + 8 * m + n_out,
            "ops": n * max(1, math.ceil(math.log2(max(m, 2))))}


def dev_segments(parts: List[Tuple[np.ndarray, int, int, int]],
                 dev: torch.device, sorted_: bool) -> List[Any]:
    """K4 device segments from (host positions, start, stop, offset), as
    ``t_occurrence_mask`` makes them: slices of one device copy of each
    host array."""
    copies: Dict[int, torch.Tensor] = {}
    out = []
    for pos, a, b, off in parts:
        if id(pos) not in copies:
            copies[id(pos)] = torch.from_numpy(pos).to(dev)
        out.append(FO.DevSeg(copies[id(pos)], a, b - a, off, sorted_,
                             int(pos[a]) if b > a else 0,
                             int(pos[b - 1]) if b > a else 0))
    return out


def _k4(segs: List[Any], n: int, n_out: int, threshold: int, label: str
        ) -> Dict[str, Any]:
    flat = torch.cat([s.pos[s.start:s.start + s.count] + s.offset
                      for s in segs])
    keep = flat[(flat >= 0) & (flat < n)]
    m = int(flat.shape[0])
    route = "sorted" if threshold > 1 and all(s.sorted for s in segs) \
        else "scatter"
    return {"kernel": "t_occurrence_mask",
            "label": f"{label} n={n} m={m} segments={len(segs)} "
                     f"T={threshold} {route}",
            "run": lambda: FO.tocc_cuda(segs, n, n_out, threshold),
            "plain": lambda: FO.tocc_plain(segs, n, n_out, threshold),
            "library": lambda: torch.bincount(keep, minlength=n) >= threshold,
            "compare": _mask_compare,
            "bytes": 8 * m + n_out,
            "ops": m}


def k4_case(n: int, m: int, threshold: int, seed: int, dev: torch.device,
            tiers: int = 4, sorted_: bool = False) -> Dict[str, Any]:
    """``m`` posting positions over ``n`` rows in ``tiers`` segments of
    resident arrays, each sorted over its own ``n // tiers`` rows (row
    offsets as in the storage concat); ``sorted_`` marks them so."""
    rng = np.random.default_rng(seed)
    per = n // tiers
    parts = []
    for t in range(tiers):
        pos = np.sort(rng.integers(0, per, m // tiers, dtype=np.int64))
        parts.append((pos, 0, int(pos.shape[0]), t * per))
    return _k4(dev_segments(parts, dev, sorted_), n, n, threshold, "tiers")


PATH_USERS = 50_000          # one users partition of chip_smoke.py's 200k
PATH_QUERY = "User Number 123"


@functools.lru_cache(maxsize=1)
def path_user_names(seed: int) -> Tuple[str, ...]:
    """One users partition of chip_smoke.py's 200,000: 50,000 distinct
    "User Number NNNNN" names, as TinySocial's generator names users."""
    rng = np.random.default_rng(seed)
    return tuple(f"User Number {i}"
                 for i in rng.choice(200_000, PATH_USERS, replace=False))


@functools.lru_cache(maxsize=1)
def _path_postings(seed: int) -> Any:
    from ..fuzzy.ngram import GRAM_K, GramPostings
    return GramPostings.from_values(list(path_user_names(seed)), GRAM_K)


def path_gram_segments(seed: int, d: int
                       ) -> Tuple[List[Tuple[np.ndarray, int, int, int]],
                                  int]:
    """The ngram probe's K4 operands for one users partition: the names'
    gram postings, built as a flushed component builds them, and the
    segments ``hit_segments`` gives for the table-3 query at edit distance
    ``d``; with its threshold T (13 at d = 1, 7 at d = 3)."""
    from ..fuzzy.ngram import GRAM_K, query_grams
    qh, threshold = query_grams(("name", "ed", PATH_QUERY, d), GRAM_K)
    return [(s.positions, s.start, s.stop, s.offset)
            for s in _path_postings(seed).hit_segments(qh, 0)], threshold


def k4_path_case(d: int, seed: int, dev: torch.device) -> Dict[str, Any]:
    """K4 as ``Dataset.ngram_candidate_mask`` calls it on one users
    partition: n = 50,000 rows (n_out 65,536), one sorted segment per
    query gram over all rows, at most one hit a row a segment."""
    parts, threshold = path_gram_segments(seed, d)
    n = PATH_USERS
    return _k4(dev_segments(parts, dev, True), n, FO._pow2_len(n),
               threshold, f"ngram d={d}")


# per DP cell (queries past 64 characters): min(up, left) + 1, a
# compare-add on the diagonal, two mins
ED_OPS_PER_CELL = 6
# per candidate character and 32-bit word of the bit-parallel column: the
# Peq lookup, the 13 logic and add steps of the recurrence, the two
# last-row tests and the distance update
ED_OPS_PER_CHAR_WORD = 20


def k5_case(strings: List[str], query: str, d: int, dev: torch.device
            ) -> Dict[str, Any]:
    """K5 over ``strings`` (padded as ``edit_distances`` pads them)."""
    bp = FO._pow2_len(len(strings))
    mat, lens = FO._char_matrix(strings, bp)
    qc, _ = FO._code_points([query])
    m = int(qc.shape[0])
    q = np.zeros(max(m, 1), dtype=np.int32)
    q[:m] = qc
    cap = min(d + 1, mat.shape[1] + m + 1)
    cand, lt = torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)
    qt = torch.from_numpy(q).to(dev)
    chars = int(np.minimum(lens, mat.shape[1]).sum())
    ops = ED_OPS_PER_CELL * chars * m if m > FO._ED_BITS else \
        ED_OPS_PER_CHAR_WORD * chars * max(1, -(-m // 32))
    return {"kernel": "edit_distances",
            "label": f"B={bp} L={mat.shape[1]} m={m} d={d}",
            "run": lambda: FO.ed_cuda(cand, lt, qt, m, cap),
            "plain": lambda: FO.ed_plain(cand, lt, qt, m, cap),
            "library": None,
            "compare": _mask_compare,
            "bytes": 4 * int(lens.sum()) + 8 * bp + 4 * m + 8 * bp,
            "ops": ops}


def _random_strings(rng: np.random.Generator, B: int, L: int,
                    alphabet: str = "User Nmb0123456789é\u4e2d") -> List[str]:
    lens = rng.integers(0, L + 1, B)
    return ["".join(rng.choice(list(alphabet), int(n))) for n in lens]


K6_LENS = ("subset", "edge")


def k6_arrays(P: int, s1: int, s2: int, vocab: int, seed: int,
              unsorted_a: bool = False, lens: str = "subset"
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(a, alens, b) for K6: ``P`` pairs of sorted distinct code sets
    drawn from ``vocab`` codes (int64; above 2**24 when ``vocab`` is), a
    rows masked by their lengths, b rows padded with the int64 sentinel.
    ``unsorted_a`` shuffles each a row's live prefix; ``lens="edge"``
    sets every third length to 0 and every third (from the second) above
    ``s1``, which makes the row's zero fill live."""
    rng = np.random.default_rng(seed)
    S = s1 + s2
    # one sorted distinct code run per pair; a and b keep random subsets
    # of it (so they overlap), packed to the left in order
    step = max(2, vocab // S)
    run = np.cumsum(rng.integers(1, step, (P, S)), axis=1) \
        + rng.integers(0, vocab, (P, 1))

    def subset(width: int, fill: int) -> Tuple[np.ndarray, np.ndarray]:
        keep = rng.random((P, S)) < rng.random((P, 1))
        order = np.argsort(~keep, axis=1, kind="stable")
        mat = np.take_along_axis(run, order, axis=1)[:, :width].copy()
        lens_ = np.minimum(keep.sum(1), width).astype(np.int64)
        mat[np.arange(width)[None, :] >= lens_[:, None]] = fill
        return mat, lens_
    a, alens = subset(s1, 0)
    b, _ = subset(s2, FO._SENTINEL)
    if unsorted_a:
        for p in range(P):
            rng.shuffle(a[p, :alens[p]])
    if lens == "edge":
        alens[0::3] = 0
        alens[1::3] = s1 + 5
    elif lens != "subset":
        raise ValueError(f"k6_arrays: lens must be one of {K6_LENS}")
    return a, alens, b


def k6_case(P: int, s1: int, s2: int, vocab: int, seed: int,
            dev: torch.device, unsorted_a: bool = False,
            lens: str = "subset", offset: bool = False) -> Dict[str, Any]:
    """K6 on ``k6_arrays``' inputs; ``offset`` hands the kernel views
    that start one row into their storage (8 bytes off 16 where the row
    width is odd)."""
    a, alens, b = k6_arrays(P, s1, s2, vocab, seed, unsorted_a, lens)

    def put(x: np.ndarray) -> torch.Tensor:
        if not offset:
            return torch.from_numpy(x).to(dev)
        return torch.from_numpy(np.concatenate([x[:1], x])).to(dev)[1:]
    at, bt, lt = put(a), put(b), put(alens)
    live = int(np.minimum(alens, s1).sum())

    def library():
        pos = torch.searchsorted(bt, at)
        hit = bt.gather(1, pos.clamp(max=s2 - 1)) == at
        return (hit & (torch.arange(s1, device=dev)[None, :]
                       < lt[:, None])).sum(1)
    label = f"P={P} S1={s1} S2={s2} vocab={vocab}" \
        + (" unsorted a" if unsorted_a else "") \
        + (f" lens {lens}" if lens != "subset" else "") \
        + (" offset views" if offset else "")
    return {"kernel": "set_intersect_counts", "label": label,
            "run": lambda: FO.inter_cuda(at, lt, bt),
            "plain": lambda: FO.inter_plain(at, lt, bt),
            "library": library,
            "compare": _mask_compare,
            "bytes": 8 * live + 8 * P * s2 + 8 * P + 8 * P,
            "ops": live * max(1, math.ceil(math.log2(max(s2, 2))))}


def _a7(words: np.ndarray, ai: np.ndarray, bi: np.ndarray, label: str,
        dev: torch.device) -> Dict[str, Any]:
    """A7 over an [R, W] uint32 matrix (carried as int32) and pair rows.
    The bound reads each row that a pair names once (not the matrix's
    padding rows), the indices and the counts."""
    R, W = words.shape
    P = int(ai.shape[0])
    bits = torch.from_numpy(words.view(np.int32)).to(dev)
    at, bt = torch.from_numpy(ai).to(dev), torch.from_numpy(bi).to(dev)
    return {"kernel": "bitset_intersect_counts",
            "label": f"R={R} W={W} P={P}{label}",
            "run": lambda: FO.popcount_cuda(bits, at, bt),
            "plain": lambda: FO.popcount_plain(bits, at, bt),
            "library": None,
            "compare": _mask_compare,
            "bytes": 4 * W * rows_touched(ai, bi) + 16 * P + 8 * P,
            "ops": 3 * W * P}


def rows_touched(ai: np.ndarray, bi: np.ndarray) -> int:
    """Distinct record rows that the pairs (ai, bi) name."""
    return int(np.unique(np.concatenate([ai, bi])).shape[0])


def a7_case(R: int, W: int, P: int, density: float, seed: int,
            dev: torch.device, one_row: bool = False) -> Dict[str, Any]:
    """``P`` pairs drawn uniformly over an [R, W] bitset matrix with
    ``density`` of its bits set; ``one_row``: every pair is (R // 2,
    R // 2)."""
    rng = np.random.default_rng(seed)
    words = np.zeros((R, W), dtype=np.uint32)
    for bit in range(32):
        on = rng.random((R, W)) < density
        words |= on.astype(np.uint32) << np.uint32(bit)
    if one_row:
        ai = bi = np.full(P, R // 2, dtype=np.int64)
    else:
        ai, bi = rng.integers(0, R, P), rng.integers(0, R, P)
    return _a7(words, ai, bi, " one row" if one_row else "", dev)


@functools.lru_cache(maxsize=4)
def a7_clustered_arrays(records: int, seed: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The clustered FuzzyJoin's operands as its candidate order gives
    them, without the LSH: clusters of 100 records over an 800-token
    vocabulary, each record its cluster's 60 base tokens less 5 plus 3
    random ones (``chip_smoke.clustered_records``); every pair of a
    cluster (a < b) is a candidate, sorted by ``str`` as ``FuzzyJoin.run``
    sorts them, so a record's pairs come in a run and its partners lie in
    its cluster.  Rows pad to a power of two, as the pool pads them."""
    rng = np.random.default_rng(seed)
    vocab, seg, codes = 800, [], []
    for c in range(records // 100):
        base = rng.choice(vocab, 60, replace=False)
        for r in range(100):
            keep = rng.choice(base, 55, replace=False)
            toks = np.union1d(keep, rng.choice(vocab, 3, replace=False))
            codes.append(toks)
            seg.append(np.full(toks.shape[0], c * 100 + r))
    R = records // 100 * 100
    words = FO.encode_bitsets(np.concatenate(codes).astype(np.int64),
                              np.concatenate(seg), R, vocab)
    rp = 1 << (R - 1).bit_length()
    words = np.concatenate(
        [words, np.zeros((rp - R, words.shape[1]), np.uint32)])
    pairs = sorted(((a, b) for c in range(0, R, 100)
                    for a in range(c, c + 100) for b in range(a + 1, c + 100)),
                   key=str)
    ab = np.array(pairs, dtype=np.int64)
    return (words, np.ascontiguousarray(ab[:, 0]),
            np.ascontiguousarray(ab[:, 1]))


def a7_clustered_case(records: int, seed: int, dev: torch.device
                      ) -> Dict[str, Any]:
    words, ai, bi = a7_clustered_arrays(records, seed)
    return _a7(words, ai, bi, f" clustered ({records} records)", dev)


def main_path_cases(dev: torch.device, seed: int = 0) -> List[Dict]:
    """The kernels at the shapes the main path gives them: a TinySocial
    messages partition of 2**19 rows (2M messages over 4 partitions) with
    K = 2 predicates and M = 2 aggregates; a tiered merge of four 2**16
    flushes into a 2**18-key union; a quarter-range index probe of 2**17
    positions over the partition, at T = 1 and T = 3.  The fuzzy phase's
    shapes: K4 counting 2**20 gram hits over a users partition (2**16
    rows) in 16 segments at T = 13 (each segment 4,096 rows with ~16 hits
    a row; kept for comparison with earlier runs), and as the ngram probe
    gives it (``k4_path_case``: 50,000 rows, the table-3 query's 16 gram
    segments, T = 13 at d = 1 and 7 at d = 3); K5 verifying one users
    partition's 50,000 distinct names (2**16 padded, L = 32) against the
    15-character table-3 query at d = 3; K6 scoring 2**7 candidate names' gram sets (S1 = 32)
    against a query's (S2 = 32), and a wide-vocabulary
    FuzzyJoin's 2**17 record pairs of width 67; A7 the clustered
    FuzzyJoin's live pairs in its candidate order (``a7_clustered_case``:
    173,250 pairs over 4,096 records of W = 32 words), and 2**18 pairs
    drawn uniformly over the same matrix shape (kept for comparison with
    earlier runs).  K1 runs first at the columnar path's own shape (the
    skip-index select's one int64 timestamp range), then at K = 2.  K2
    also runs at a padded length of 32 under 3 predicate columns that keep
    most rows (a small gathered batch: the reference's 32-slot sum order,
    ``columnar_ops.sum32_unroll``)."""
    n = 1 << 19
    names = list(path_user_names(seed + 5))
    return [k1_case(n, ["ts"], seed, dev),
            k1_case(n, ["ts", "id"], seed, dev),
            k2_case(n, ["ts", "id"], ["id", "f64"], seed + 1, dev),
            k3_case(1 << 18, 1 << 16, seed + 2, dev),
            k4_case(n, 1 << 17, 1, seed + 3, dev),
            k4_case(n, 1 << 19, 3, seed + 4, dev),
            k5_case(names, PATH_QUERY, 3, dev),
            k4_case(1 << 16, 1 << 20, 13, seed + 9, dev, tiers=16,
                    sorted_=True),
            k4_path_case(1, seed + 5, dev),
            k4_path_case(3, seed + 5, dev),
            k6_case(1 << 7, 32, 32, 1 << 20, seed + 6, dev),
            k6_case(1 << 17, 67, 67, 1 << 16, seed + 7, dev),
            a7_clustered_case(3500, seed + 8, dev),
            a7_case(1 << 12, 32, 1 << 18, 60 / 800, seed + 8, dev),
            k2_case(32, ["loose"] * 3, ["f64n", "id"], seed + 10, dev)]


# ---------------------------------------------------------------------------
# rungs 3 and 4 of the query path: A6, stacked K1 / K2, exchange, merges
# (raw int64 results: counts and int slots exact, float64 slots bit-equal
# or both NaN)
# ---------------------------------------------------------------------------

def raw_compare(got: Tuple[np.ndarray, np.ndarray],
                ref: Tuple[np.ndarray, np.ndarray],
                floats: List[int]) -> float:
    """0.0 when two (raw [R, W] int64, mask [R, n]) results agree: the
    masks and every integer slot exactly, the float64 slots (columns
    ``floats`` of raw) bit for bit or both NaN; inf otherwise."""
    graw, gmask = got
    rraw, rmask = ref
    if graw.shape != rraw.shape or not np.array_equal(gmask, rmask):
        return math.inf
    ints = [c for c in range(graw.shape[1]) if c not in floats]
    if not np.array_equal(graw[:, ints], rraw[:, ints]):
        return math.inf
    for c in floats:
        g = graw[:, c].view(np.float64)
        r = rraw[:, c].view(np.float64)
        same = (graw[:, c] == rraw[:, c]) | (np.isnan(g) & np.isnan(r))
        if not same.all():
            return math.inf
    return 0.0


def _float_slots(n_counts: int, kinds: List[str]) -> List[int]:
    return [n_counts + 4 * j + f for j, k in enumerate(kinds)
            if k in ("f64", "f64n", "nan") for f in (1, 2, 3)]


def _stacked_columns(rng: np.random.Generator, rows: int, n: int,
                     kinds: List[str], bounds: bool, dev: torch.device
                     ) -> list:
    """``_columns`` stacked over ``rows`` rows ([R, n] tensors), each row
    with its own bounds (lo / hi moved by the row index) as [R] arrays."""
    cols = []
    per = [_columns(rng, n, kinds, bounds, torch.device("cpu"))
           for _ in range(rows)]
    for j in range(len(kinds)):
        x = torch.stack([per[r][j][0] for r in range(rows)]).to(dev)
        v = torch.stack([per[r][j][1] for r in range(rows)]).to(dev)
        if not bounds:
            cols.append((x, v))
            continue
        lo = np.asarray([per[r][j][2] for r in range(rows)])
        hi = np.asarray([per[r][j][3] for r in range(rows)])
        if lo.dtype.kind == "f":
            lo = lo + 50.0 * np.arange(rows)
        elif hi[0] < np.iinfo(hi.dtype).max:
            span = (hi[0] - lo[0]) // 8
            lo = lo + span * np.arange(rows, dtype=lo.dtype)
        cols.append((x, v, lo, hi))
    return cols


def _col_bytes_rows(cols: list, rows: int, n: int) -> int:
    return sum((c[0].element_size() + 1) * rows * n for c in cols)


def k1_rows_case(rows: int, n: int, kinds: List[str], seed: int,
                 dev: torch.device) -> Dict[str, Any]:
    """Stacked K1 over ``rows`` rows of ``n`` lanes, each row's bounds its
    own."""
    rng = np.random.default_rng(seed)
    cols = _stacked_columns(rng, rows, n, kinds, True, dev)
    return {"kernel": "range_mask_stacked",
            "label": f"R={rows} n={n} K={len(cols)} {','.join(kinds)}",
            "run": lambda: SO.range_mask_rows_cuda(cols, rows, n),
            "plain": lambda: SO.range_mask_rows_plain(cols, rows, n),
            "library": None, "compare": _mask_compare, "cols": cols,
            "bytes": _col_bytes_rows(cols, rows, n) + rows * n,
            "ops": 2 * len(cols) * rows * n}


def k2_rows_case(rows: int, n: int, pred_kinds: List[str],
                 agg_kinds: List[str], seed: int, dev: torch.device
                 ) -> Dict[str, Any]:
    """Stacked K2 over ``rows`` rows: each row's mask, count and column
    scalars (float64 sums in tree_sum's order, compared bit for bit)."""
    rng = np.random.default_rng(seed)
    pcols = _stacked_columns(rng, rows, n, pred_kinds, True, dev)
    acols = _stacked_columns(rng, rows, n, agg_kinds, False, dev)
    floats = _float_slots(1, agg_kinds)
    return {"kernel": "filter_aggregate_stacked",
            "label": f"R={rows} n={n} K={len(pcols)} M={len(acols)}",
            "run": lambda: SO.filter_aggregate_rows_cuda(pcols, acols, rows,
                                                         n),
            "plain": lambda: SO.filter_aggregate_rows_plain(pcols, acols,
                                                            rows, n),
            "library": None,
            "compare": lambda got, ref: raw_compare(
                CH.unpack(got.cpu().numpy(), rows, 1 + 4 * len(acols), n),
                ref, floats),
            "pcols": pcols, "acols": acols,
            "bytes": _col_bytes_rows(pcols, rows, n)
            + _col_bytes_rows(acols, rows, n) + rows * n
            + 8 * rows * (1 + 4 * len(acols)),
            "ops": (2 * len(pcols) + 4 * len(acols)) * rows * n}


def a6_arrays(rows: int, n_live: int, tiers: int, fields: int,
              pred_kinds: List[str], agg_kinds: List[str], seed: int,
              dev: torch.device, select: float = 0.5,
              empty_last: bool = False, pos_dtype: Any = np.int64
              ) -> Dict[str, Any]:
    """A6's operands as a partition of a storage concat holds them: each
    row's concat of ``tiers`` components, each component's postings a
    permutation of its slots (an index's positions in key order), the
    probe's slice [a, b) ``select`` of each, the live selection
    ``n_live`` sorted slots (about 0.9 of the concat), padded to a pow2
    ``live_p2`` with zeros; ``empty_last``: the last row is a padding row
    (n_live 0, zero-width slices); ``pos_dtype``: the postings' dtype."""
    rng = np.random.default_rng(seed)
    total = -(-int(n_live / 0.9) // tiers) * tiers
    total_p2 = 1 << (total - 1).bit_length()
    live_p2 = 1 << (n_live - 1).bit_length()
    per = total // tiers
    tier_t = []
    abo = np.zeros((rows, fields * tiers, 3), np.int64)
    for f in range(fields):
        fp = []
        for t in range(tiers):
            w = 1 << (per - 1).bit_length()
            st = np.zeros((rows, w), pos_dtype)
            for r in range(rows):
                st[r, :per] = rng.permutation(per)
                a = int(rng.integers(0, max(1, int(per * (1 - select)))))
                b = min(per, a + int(per * select))
                if empty_last and r == rows - 1:
                    a = b = 0
                abo[r, f * tiers + t] = (a, b, t * per)
            fp.append(torch.from_numpy(st).to(dev))
        tier_t.append(fp)
    idx = np.zeros((rows, live_p2), np.int64)
    nl = np.zeros(rows, np.int64)
    for r in range(rows):
        if empty_last and r == rows - 1:
            continue
        nl[r] = n_live
        idx[r, :n_live] = np.sort(rng.choice(total, n_live, replace=False))
    pcols = _stacked_columns(rng, rows, live_p2, pred_kinds, True, dev)
    acols = _stacked_columns(rng, rows, live_p2, agg_kinds, False, dev)
    in_slice = int(np.clip(abo[:, :, 1] - abo[:, :, 0], 0, None).sum())
    return {"tiers": tier_t, "abo": abo,
            "idx": torch.from_numpy(idx).to(dev), "n_live": nl,
            "preds": pcols, "aggs": acols, "total_p2": total_p2,
            "live_p2": live_p2, "in_slice": in_slice}


def a6_case(rows: int, n_live: int, tiers: int, fields: int,
            pred_kinds: List[str], agg_kinds: List[str], seed: int,
            dev: torch.device, empty_last: bool = False,
            pos_dtype: Any = np.int64) -> Dict[str, Any]:
    """A6 in mask mode (no aggregate columns) or aggregate mode."""
    a = a6_arrays(rows, n_live, tiers, fields, pred_kinds, agg_kinds, seed,
                  dev, empty_last=empty_last, pos_dtype=pos_dtype)
    args = (a["tiers"], a["abo"], a["idx"], a["n_live"], a["preds"],
            a["aggs"], a["total_p2"], a["live_p2"])
    floats = _float_slots(CH.N_COUNTS, agg_kinds)
    lanes = rows * a["live_p2"]
    mode = "aggregate" if agg_kinds else "mask"
    return {"kernel": "fused_index_chain",
            "label": (f"{mode} R={rows} n_live={n_live} live_p2="
                      f"{a['live_p2']} total_p2={a['total_p2']} fields="
                      f"{fields} tiers={tiers} K={len(pred_kinds)} "
                      f"M={len(agg_kinds)}"
                      + (" last row empty" if empty_last else "")),
            "run": lambda: CH.chain_cuda(*args),
            "plain": lambda: CH.chain_plain(*args),
            "library": None,
            "compare": lambda got, ref: raw_compare(
                CH.unpack(got.cpu().numpy(), rows,
                          CH.N_COUNTS + 4 * len(agg_kinds), a["live_p2"]),
                ref, floats),
            "args": args,
            # in-slice positions, the live index, the columns, the mask
            # and the scalars
            "bytes": np.dtype(pos_dtype).itemsize * a["in_slice"]
            + 8 * lanes
            + _col_bytes_rows(a["preds"], rows, a["live_p2"])
            + _col_bytes_rows(a["aggs"], rows, a["live_p2"]) + lanes
            + 8 * rows * (CH.N_COUNTS + 4 * len(agg_kinds)),
            "ops": a["in_slice"] + lanes * (fields + 2 * len(pred_kinds)
                                            + 4 * len(agg_kinds))}


def exchange_compare(got: torch.Tensor, ref: torch.Tensor,
                     lay: "SO.ExchangeLayout") -> float:
    """0.0 when two received buffers agree byte for byte in the counts and
    in every column's data and validity (the padding between them is
    never written), inf otherwise."""
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    gc, gcols = SO.received(g, lay)
    rc, rcols = SO.received(r, lay)
    same = np.array_equal(gc, rc) and all(
        a.tobytes() == b.tobytes()
        for ga, ra in zip(gcols, rcols) for a, b in zip(ga, ra))
    return 0.0 if same else math.inf


def exchange_arrays(seed: int, p: int = 4, users: int = 200_000,
                    per: int = 500_000) -> Tuple[list, List[int]]:
    """grouped_topk's exchange at ``chip_smoke.py``'s scale: each of ``p``
    messages partitions' ``per`` author-ids drawn uniformly over ``users``
    (tinysocial.gen_messages) and grouped, its partial groups (author-id,
    count; int64, every row valid): ~183,600 rows a partition at the
    defaults.  Returns (each column's (data, validity) a source, rows a
    source)."""
    rng = np.random.default_rng(seed)
    cols: list = [[], []]
    rows = []
    for _ in range(p):
        ids, cnt = np.unique(rng.integers(0, users, per), return_counts=True)
        ok = np.ones(ids.shape[0], bool)
        cols[0].append((ids.astype(np.int64), ok))
        cols[1].append((cnt.astype(np.int64), ok))
        rows.append(int(ids.shape[0]))
    return cols, rows


def exchange_case(seed: int, dev: torch.device, p: int = 4
                  ) -> Dict[str, Any]:
    """The exchange of grouped_topk's partial groups (``exchange_arrays``),
    the key (author-id) hashed on the card: the send buffer staged and
    uploaded once, then the kernel's three launches against the plain
    version, byte for byte.  The yardstick: one stable ``torch.argsort``
    of the partition ids and an ``index_select`` a column region."""
    cols, rows = exchange_arrays(seed, p)
    stage, lay = SO.stage_exchange(cols, rows, 0, p)
    send = stage.to(dev, non_blocking=True)
    pid = torch.from_numpy(_hash_pids(cols[0], p)).to(dev)
    area = send[lay.head:lay.head + lay.out_area]
    regions = [(area[d:d + lay.n * dt.itemsize].view(
        torch.int64 if dt.itemsize == 8 else torch.uint8),
        area[v:v + lay.n]) for dt, d, v in lay.cols]

    def library():
        order = torch.argsort(pid, stable=True)
        return [t.index_select(0, order) for r in regions for t in r]
    col_bytes = sum((dt.itemsize + 1) * lay.n for dt, _d, _v in lay.cols)
    return {"kernel": "spmd_exchange",
            "label": f"p={p} rows={lay.n} ({', '.join(map(str, rows))}) "
                     f"columns={len(lay.cols)} key hashed on the card",
            "run": lambda: SO.exchange_cuda(send, lay),
            "plain": lambda: SO.exchange_plain(send, lay),
            "library": library,
            "compare": lambda got, ref: exchange_compare(got, ref, lay),
            # every column read and written once (the hashed key is one
            # of them; host partition ids would add their int32 read) and
            # the counts
            "bytes": 2 * col_bytes + 8 * p * p
            + (4 * lay.n if lay.key_kind == SO.XK_PID else 0), "ops": 0}


def _hash_pids(keys: List[Tuple[np.ndarray, np.ndarray]], p: int
                 ) -> np.ndarray:
    """The partition ids of the sources' int64 keys, back to back
    (storage/dataset.hash_partition_array's hash)."""
    k = np.concatenate([d for d, _v in keys]).astype(np.uint64)
    h = (k * np.uint64(11400714819323198485)) >> np.uint64(40)
    return (h % np.uint64(p)).astype(np.int64)


def merge_case(rows: int, m: int, op: str, seed: int, dev: torch.device,
               dtype: Any = np.float64) -> Dict[str, Any]:
    """A merge of [rows, m] partials (a NaN in one column of floats)."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        x = rng.standard_normal((rows, m)).astype(dtype) * 1e3
        x[rows // 2, m // 2] = np.nan
    else:
        x = rng.integers(-10**12, 10**12, (rows, m)).astype(dtype)
    t = torch.from_numpy(x).to(dev)
    lib = {"sum": lambda: torch.sum(t, 0), "min": lambda: torch.amin(t, 0),
           "max": lambda: torch.amax(t, 0)}[op]

    def compare(got, ref):
        g, r = got.cpu().numpy(), ref.cpu().numpy()
        return 0.0 if np.array_equal(g, r, equal_nan=g.dtype.kind == "f") \
            else math.inf
    return {"kernel": "spmd_merge",
            "label": f"{op} [{rows}, {m}] {np.dtype(dtype).name}",
            "run": lambda: SO.merge_cuda(t, op),
            "plain": lambda: SO.merge_plain(t, op),
            "library": lib, "compare": compare,
            "bytes": x.nbytes + x.nbytes // rows, "ops": x.size}


def rung_cases(dev: torch.device, seed: int = 0) -> List[Dict]:
    """Rungs 3 and 4 at the main path's shapes: one messages partition of
    chip_smoke.py's 2,000,000 over 4 partitions is ~2**19 live lanes over
    4 flushed components; A6 in mask mode (the index range scan: one
    field, no validate range) and aggregate mode (an int64 and a float64
    column) at R = 1 and R = 4, with a padding row; stacked K1 and K2 at
    R = 4 (the skip-index select and the exact-range aggregate); the
    exchange of grouped_topk's partial groups at p = 4 (~734,000 rows,
    two int64 columns); a merge of 4 partitions' partials."""
    n = 500_000
    return [a6_case(1, n, 4, 1, [], [], seed + 30, dev),
            a6_case(4, n, 4, 1, [], [], seed + 31, dev),
            a6_case(1, n, 4, 1, [], ["id", "f64n"], seed + 32, dev),
            a6_case(4, n, 4, 1, ["ts"], ["id", "f64n"], seed + 33, dev,
                    empty_last=True),
            k1_rows_case(4, 1 << 19, ["ts"], seed + 34, dev),
            k2_rows_case(4, 1 << 19, ["ts"], ["id", "f64n"], seed + 35,
                         dev),
            exchange_case(seed + 36, dev),
            merge_case(4, 1 << 10, "sum", seed + 37, dev)]


# predicate columns past the kernels' 8 slots: predicates 7, 8, ... ANDed
# by K1 (stacked K1 on a row axis) into slot 7's validity first
WIDE9 = ["ts", "id", "loose", "f64", "code", "loose", "loose", "nan",
         "loose"]
WIDE17 = WIDE9 + ["loose", "ts", "loose", "code", "loose", "loose", "f64n",
                  "loose"]


def wide_pred_cases(dev: torch.device, seed: int = 0) -> List[Dict]:
    """K2, stacked K2 and A6 with 9 and 17 predicate columns (validate
    ranges for A6) at the rung cases' shapes: K2 at n = 2**19 with an
    int64 and a float64 aggregate, stacked K2 at R = 4, A6 in aggregate
    mode at R = 1 (9) and in mask mode at R = 4 with a padding row
    (17)."""
    n = 1 << 19
    return [k2_case(n, WIDE9, ["id", "f64n"], seed + 40, dev),
            k2_case(n, WIDE17, ["id", "f64n"], seed + 41, dev),
            k2_rows_case(4, n, WIDE9, ["id", "f64n"], seed + 42, dev),
            k2_rows_case(4, n, WIDE17, ["id", "f64n"], seed + 43, dev),
            a6_case(1, 500_000, 4, 1, WIDE9, ["id", "f64n"], seed + 44, dev),
            a6_case(4, 500_000, 4, 1, WIDE17, [], seed + 45, dev,
                    empty_last=True)]


# ---------------------------------------------------------------------------
# model-stack cases (K7-K9): float results within a relative tolerance
# ---------------------------------------------------------------------------

def _parts(x: Any) -> Tuple[torch.Tensor, ...]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _float_check(rtol: float) -> Callable[[Any, Any], Tuple[float, bool]]:
    """(max abs error, ok): each output within ``rtol`` of the largest
    magnitude of its reference (entries at NEG_INF, an empty component's
    max, must match exactly and set no scale)."""
    def check(got: Any, ref: Any) -> Tuple[float, bool]:
        err, ok = 0.0, True
        for g, r in zip(_parts(got), _parts(ref)):
            g, r = g.float(), r.float()
            if g.shape != r.shape:
                return math.inf, False
            e = float((g - r).abs().max()) if r.numel() else 0.0
            live = r.abs() < 1e29
            scale = max(1.0, float(r[live].abs().max()) if live.any()
                        else 0.0)
            ok = ok and e <= rtol * scale      # False for a NaN error
            err = max(err, e)
        return err, ok
    return check


def _randn(rng: np.random.Generator, shape: Tuple[int, ...],
           dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dev).to(dtype)


def _rtol(dtype: torch.dtype) -> float:
    return BF16_RTOL if dtype == torch.bfloat16 else MODEL_RTOL


def k7_case(N: int, d: int, seed: int, dev: torch.device,
            dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """K7 over x [N, d] in ``dtype`` with float32 weights."""
    rng = np.random.default_rng(seed)
    x = _randn(rng, (N, d), dtype, dev)
    w = _randn(rng, (d,), torch.float32, dev)
    return {"kernel": "rmsnorm", "label": f"x [{N}, {d}] {dtype}",
            "run": lambda: RN.rmsnorm_cuda(x, w),
            "plain": lambda: RN.rmsnorm_plain(x, w),
            "library": lambda: torch.nn.functional.rms_norm(
                x, (d,), w.to(dtype), eps=1e-5),
            "check": _float_check(_rtol(dtype)),
            "cluster": RN.cluster_size(N, d, dtype),
            "bytes": 2 * x.numel() * x.element_size() + 4 * d,
            "ops": 4 * N * d}


def k8_case(B: int, H: int, KV: int, Sq: int, Skv: int, hd: int, seed: int,
            dev: torch.device, causal: bool = True, q_offset: int = 0,
            kv_len: Optional[int] = None, fused: bool = False,
            dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """K8 in the model layout (q [B, Sq, H, hd], k/v [B, Skv, KV, hd]) or,
    with ``fused``, the Pallas kernel's q [B*H, Sq, hd], k/v [B*KV, Skv,
    hd] (handed to the kernel as B = 1 views, no copy)."""
    rng = np.random.default_rng(seed)
    n = Skv if kv_len is None else kv_len
    if fused:
        qf = _randn(rng, (B * H, Sq, hd), dtype, dev)
        kf, vf = (_randn(rng, (B * KV, Skv, hd), dtype, dev)
                  for _ in range(2))
        q, k, v = FA.fused_layout(qf, kf, vf)
        label = (f"fused q [{B * H}, {Sq}, {hd}] k/v [{B * KV}, {Skv}, "
                 f"{hd}]")

        def library():   # [N, heads, S, hd]; GQA maps h -> h // G too
            return torch.nn.functional.scaled_dot_product_attention(
                qf[None], kf[None, :, :n], vf[None, :, :n],
                is_causal=causal and q_offset == 0 and Sq == n,
                enable_gqa=True)
    else:
        q = _randn(rng, (B, Sq, H, hd), dtype, dev)
        k, v = (_randn(rng, (B, Skv, KV, hd), dtype, dev) for _ in range(2))
        label = f"q [{B}, {Sq}, {H}, {hd}] k/v [{B}, {Skv}, {KV}, {hd}]"
        library = None
    label += (f" {'causal' if causal else 'full'} q_offset={q_offset} "
              f"kv_len={n} {dtype}")
    # (query, key) pairs the masks leave visible: the work this run needs
    vis = sum(min(n, q_offset + i + 1) if causal else n for i in range(Sq))
    esz = q.element_size()
    flops = 4 * B * H * hd * vis         # half in S = QK^T, half in PV
    # the products as the kernel runs them on the tensor cores: float32 as
    # 3xTF32 (three TF32 products each); bfloat16 S in one bf16 product and
    # PV as two TF32 products (P split, V exact)
    tc_s = (3 * flops / TF32_FLOPS_PER_S if dtype == torch.float32 else
            flops / 2 / BF16_FLOPS_PER_S + flops / TF32_FLOPS_PER_S)
    return {"kernel": "flash_attention", "label": label,
            "run": lambda: FA.flash_cuda(q, k, v, causal, q_offset, n),
            "plain": lambda: FA.flash_plain(q, k, v, causal, q_offset, n),
            "library": library,
            "check": _float_check(_rtol(dtype)),
            "bytes": esz * (2 * B * Sq * H * hd + 2 * B * n * KV * hd),
            "ops": flops, "tc_s": tc_s}


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous view one element into a larger
    buffer: not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def k7_bwd_case(N: int, d: int, seed: int, dev: torch.device,
                dtype: torch.dtype = torch.float32,
                offset: str = "") -> Dict[str, Any]:
    """K7's backward over x, g [N, d] in ``dtype`` with float32 weights;
    the library call is autograd's backward of ``F.rms_norm``.  ``offset``
    names the operands ("x", "g" or both) handed over one element off a
    16-byte boundary."""
    rng = np.random.default_rng(seed)
    x = _randn(rng, (N, d), dtype, dev)
    w = _randn(rng, (d,), torch.float32, dev)
    g = _randn(rng, (N, d), dtype, dev)
    if "x" in offset:
        x = _offset_view(x)
    if "g" in offset:
        g = _offset_view(g)
    xl = x.detach().requires_grad_(True)
    wl = w.detach().to(dtype).requires_grad_(True)
    yl = torch.nn.functional.rms_norm(xl, (d,), wl, eps=1e-5)
    return {"kernel": "rmsnorm_bwd",
            "label": f"x, g [{N}, {d}] {dtype}"
                     + (f" {offset} offset" if offset else ""),
            "run": lambda: RN.rmsnorm_bwd_cuda(x, w, g),
            "plain": lambda: RN.rmsnorm_bwd_plain(x, w, g),
            "library": lambda: torch.autograd.grad(yl, (xl, wl), g,
                                                   retain_graph=True),
            "check": _float_check(BF16_RTOL if dtype == torch.bfloat16
                                  else BWD_RTOL),
            # x and g read, dx written once; w and dw
            "bytes": 3 * x.numel() * x.element_size() + 8 * d,
            "ops": 8 * N * d}


def k8_bwd_case(B: int, H: int, KV: int, Sq: int, Skv: int, hd: int,
                seed: int, dev: torch.device, causal: bool = True,
                q_offset: int = 0, dtype: torch.dtype = torch.float32,
                library: bool = False) -> Dict[str, Any]:
    """K8's backward in the model layout (q, g [B, Sq, H, hd], k/v
    [B, Skv, KV, hd]) given K8's forward output and row logsumexp;
    ``library``: time autograd's backward of ``scaled_dot_product_attention``
    (``enable_gqa``) on the same inputs."""
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, Sq, H, hd), dtype, dev)
    k, v = (_randn(rng, (B, Skv, KV, hd), dtype, dev) for _ in range(2))
    g = _randn(rng, (B, Sq, H, hd), dtype, dev)
    counts = _counters()
    o, lse = FA.flash_cuda(q, k, v, causal, q_offset, with_lse=True)
    _set_counters(counts)                # setting up is not a launch
    lib_fn = None
    if library:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal and q_offset == 0 and Sq == Skv,
            enable_gqa=True)
        gt = g.transpose(1, 2)

        def lib_fn():
            return torch.autograd.grad(ot, (qt, kt, vt), gt,
                                       retain_graph=True)
    vis = sum(min(Skv, q_offset + i + 1) if causal else Skv
              for i in range(Sq))
    flops = 10 * B * H * hd * vis        # S again, dP, dV, dK, dQ
    esz = q.element_size()
    return {"kernel": "flash_attention_bwd",
            "label": (f"q [{B}, {Sq}, {H}, {hd}] k/v [{B}, {Skv}, {KV}, "
                      f"{hd}] {'causal' if causal else 'full'} "
                      f"q_offset={q_offset} {dtype}"),
            "run": lambda: FA.flash_bwd_cuda(q, k, v, o, lse, g, causal,
                                             q_offset),
            "plain": lambda: FA.flash_bwd_plain(q, k, v, g, causal,
                                                q_offset),
            "library": lib_fn,
            "check": _float_check(BF16_RTOL if dtype == torch.bfloat16
                                  else BWD_RTOL),
            # q, k, v, o, g and lse read; dq, dk, dv written
            "bytes": esz * (4 * B * Sq * H * hd + 4 * B * Skv * KV * hd)
            + 4 * B * H * Sq,
            "ops": flops,
            # at float32 accuracy on the tensor cores: 3xTF32, as K8's
            "tc_s": (3 * flops / TF32_FLOPS_PER_S if dtype == torch.float32
                     else flops / BF16_FLOPS_PER_S)}


def train_cases(dev: torch.device, seed: int = 0, batch: int = 2,
                seq: int = 2048) -> List[Dict]:
    """The backward kernels at the shapes deepseek-67b's train step gives
    them for ``batch`` sequences of ``seq`` tokens: K7's over the
    [batch * seq, 8192] activations, K8's over q [batch, seq, 64, 128],
    k/v [batch, seq, 8, 128], causal, float32."""
    return [k7_bwd_case(batch * seq, 8192, seed + 30, dev),
            k8_bwd_case(batch, 64, 8, seq, seq, 128, seed + 31, dev,
                        library=True)]


def k9_case(B: int, H: int, KV: int, hd: int, Sc: int, valid_len: int,
            seed: int, dev: torch.device, name: str = "",
            dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """K9 over one component k/v [B, Sc, KV, hd] with ``valid_len`` valid
    rows, q [B, H, hd]."""
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, H, hd), torch.float32, dev)
    k, v = (_randn(rng, (B, Sc, KV, hd), dtype, dev) for _ in range(2))
    n = max(0, min(valid_len, Sc))
    return {"kernel": "lsm_decode_attention",
            "label": (f"{name} k/v [{B}, {Sc}, {KV}, {hd}] valid_len={n} "
                      f"{dtype}").strip(),
            "run": lambda: LD.decode_partial_cuda(q, k, v, n),
            "plain": lambda: LD.decode_partial_plain(q, k, v, n),
            "library": None,
            "check": _float_check(MODEL_RTOL),
            "cluster": LD.launch_plan(n, B * KV, RN.DTYPES[dtype], hd,
                                      H // KV)[0],
            "bytes": 4 * q.numel() + 2 * B * n * KV * hd * k.element_size()
            + 4 * (B * H * hd + 2 * B * H),
            "ops": 4 * B * H * hd * n}


def serve_cases(dev: torch.device, seed: int = 0, batch: int = 8,
                prompt: int = 512, gen: int = 320, tail_cap: int = 64,
                l1_comps: int = 4) -> List[Dict]:
    """K7-K9 at the shapes deepseek-67b's serve path gives them
    (d_model 8192, 64 heads, 8 KV heads, head_dim 128) for ``batch``
    requests of ``prompt`` tokens and ``gen`` generated ones: K7 over the
    prefill's [batch * prompt, 8192] activations and a decode step's
    [batch, 8192]; K8 over the prefill in the Pallas kernel's fused layout
    (q [batch * 64, prompt, 128], k/v [batch * 8, prompt, 128]); K9 over
    the last tiered step's L2 (prompt plus one merged ring valid, of the
    cache_config_for capacity), a full and an empty L1 slot and the
    tail, and the flat cache's last step."""
    d, H, KV, hd = 8192, 64, 8, 128
    steps = gen - 1
    flushes = (steps - 1) // tail_cap
    merges = flushes // l1_comps
    max_len = prompt + gen
    l2_cap = -(-max_len // tail_cap) * tail_cap + l1_comps * tail_cap
    l2_valid = prompt + merges * l1_comps * tail_cap
    tail_valid = steps - flushes * tail_cap
    return [k7_case(batch * prompt, d, seed + 20, dev),
            k7_case(batch, d, seed + 21, dev),
            k8_case(batch, H, KV, prompt, prompt, hd, seed + 22, dev,
                    fused=True),
            k9_case(batch, H, KV, hd, l2_cap, l2_valid, seed + 23, dev, "L2"),
            k9_case(batch, H, KV, hd, tail_cap, tail_cap, seed + 24, dev,
                    "L1 full"),
            k9_case(batch, H, KV, hd, tail_cap, 0, seed + 25, dev,
                    "L1 empty"),
            k9_case(batch, H, KV, hd, tail_cap, tail_valid, seed + 26, dev,
                    "tail"),
            k9_case(batch, H, KV, hd, max_len, max_len - 1, seed + 27, dev,
                    "flat")]


# ---------------------------------------------------------------------------
# running one case
# ---------------------------------------------------------------------------

_FLUSH: List[Optional[torch.Tensor]] = [None]


def _flush() -> None:
    """Evict the 50 MB L2 cache (write a 256 MB buffer)."""
    if _FLUSH[0] is None:
        _FLUSH[0] = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    _FLUSH[0].zero_()


# whether torch.profiler sees the card: CUPTI records nothing where another
# tracer holds it or its library is missing; then times come from CUDA
# events alone (None until the first probe)
_PROFILER: List[Optional[bool]] = [None]
_FLUSH_RANGE = "selfcheck.flush"


def union_us(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) spans (µs): work that overlaps
    on the device (a programmatic dependent launch starts before the
    launch it depends on ends) counts once."""
    total, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def _profiled_us(fn: Callable[[], Any], iters: int, flush: bool = False
                 ) -> Tuple[float, float]:
    """Device µs of the kernels, memsets and copies ``fn`` runs over
    ``iters`` calls (the union of their spans on the device's timeline),
    recorded by ``torch.profiler`` (CUPTI), and of the L2 flushes made
    before each call when ``flush``.  Each flush runs in a named range,
    which the profiler also records on the device's timeline: the work
    inside those spans is the flushes' own and is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CUDA]
    if flush:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(iters):
            if flush:
                with record_function(_FLUSH_RANGE):
                    _flush()
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    fl = [(e.time_range.start, e.time_range.end) for e in dev
          if e.name == _FLUSH_RANGE]
    work = [(e.time_range.start, e.time_range.end) for e in dev
            if e.name != _FLUSH_RANGE and not any(
                a <= e.time_range.start and e.time_range.end <= b
                for a, b in fl)]
    return union_us(work), sum(b - a for a, b in fl)


def profiler_works() -> bool:
    """True when ``torch.profiler`` records the L2 flush's device time."""
    if _PROFILER[0] is None:
        _PROFILER[0] = _profiled_us(_flush, 1)[0] > 0
    return bool(_PROFILER[0])


def device_ms(fn: Callable[[], Any], iters: int = 1) -> Optional[float]:
    """Device time of ``fn``'s CUDA work per call: kernel, memset and
    memcpy durations recorded by ``torch.profiler`` (CUPTI); 0 when
    ``fn`` ran nothing on the device, None when the profiler cannot see
    the device."""
    if not profiler_works():
        return None
    return _profiled_us(fn, iters)[0] / 1e3 / iters


def _time_ms(fn: Callable[[], Any], iters: int, warmup: int = 2
             ) -> Dict[str, Any]:
    """Per call, L2 flushed before each: device time (profiler, the
    flushes' own time subtracted) and CUDA-event time around the call.
    Where the profiler records nothing, ``ms`` is the CUDA-event time and
    ``timer`` says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        _flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    call = sum(s.elapsed_time(e) for s, e in pairs) / iters
    if profiler_works():
        dev, flushes = _profiled_us(fn, iters, flush=True)
        if dev > 0 and flushes > 0:
            return {"ms": dev / 1e3 / iters, "call_ms": call,
                    "timer": "profiler"}
    return {"ms": call, "call_ms": call, "timer": "cuda_events"}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal tensors, NaN equal to NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def run_case(case: Dict[str, Any], iters: int = 20, timed: bool = True
             ) -> Dict[str, Any]:
    """Check the kernel against its plain version on the same inputs,
    then (``timed``) time kernel, plain version and library call."""
    counts0 = _counters()
    got = case["run"]()
    torch.cuda.synchronize()
    ref = case["plain"]()
    if "check" in case:
        err, ok = case["check"](got, ref)
    else:
        err = case["compare"](got, ref)
        ok = err == 0.0
    again = case["run"]()                 # the kernel is deterministic
    torch.cuda.synchronize()
    stable = all(_same(a, b) for a, b in zip(_parts(got), _parts(again)))
    mem_s = case["bytes"] / HBM_BYTES_PER_S
    ops_s = case.get("tc_s", case["ops"] / SCALAR_OPS_PER_S)
    out = {"kernel": case["kernel"], "label": case["label"],
           "max_abs_err": err, "ok": bool(ok and stable),
           "bound_ms": 1e3 * max(mem_s, ops_s),
           "bound_by": "bytes" if mem_s >= ops_s else "operations"}
    if "tc_s" in case:          # K8: the float32 non-tensor bound beside it
        out["bound_fp32_ms"] = 1e3 * max(
            mem_s, case["ops"] / SCALAR_OPS_PER_S)
    if "cluster" in case:                 # K7, K9: CTAs a cluster
        out["cluster"] = case["cluster"]
    if timed:
        t = _time_ms(case["run"], iters)
        out["ms"], out["call_ms"] = t["ms"], t["call_ms"]
        out["ms_timer"] = t["timer"]
        t = _time_ms(case["plain"], max(3, iters // 4))
        out["plain_ms"], out["plain_call_ms"] = t["ms"], t["call_ms"]
        out["library_ms"] = out["library_call_ms"] = None
        if case["library"] is not None:
            t = _time_ms(case["library"], iters)
            out["library_ms"], out["library_call_ms"] = t["ms"], t["call_ms"]
    # checking and timing launches are not main-path launches
    _set_counters(counts0)
    return out
