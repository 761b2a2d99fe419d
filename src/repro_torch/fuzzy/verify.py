"""Batched fuzzy-candidate verification (the VERIFY stage).

Replaces the per-pair python loops on both fuzzy paths:

  * ``verify_mask`` refines an ngram-candidate position bitmap over a
    partition's ColumnBatch.  String columns are dictionary-coded, so
    verification runs once per *distinct* candidate value — banded DP
    (``kernels/fuzzy_ops.edit_distances``) for edit distance, the
    sorted-set intersection kernel for gram-set Jaccard — and the
    per-row answer is a code-indexed lookup.
  * ``jaccard_pair_sims`` verifies FuzzyJoin candidate pairs: token sets
    are encoded against one shared sorted dictionary and the batched
    intersection kernel scores every pair in one pass.

Decisions match the scalar oracles exactly: the DP's <= d decision is
exact (saturation only caps values beyond the band), and Jaccard
divides exact integer counts in float64 — the same arithmetic as
``len(a & b) / len(a | b)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Set, Tuple

import numpy as np

from ..core.functions import gram_tokens
from ..kernels import fuzzy_ops as F
from .ngram import FuzzySpec

__all__ = ["verify_values", "verify_mask", "encode_token_sets",
           "jaccard_pair_sims"]


def _jaccard_values(values: Sequence[str], target: str, t: float,
                    k: int) -> np.ndarray:
    """Gram-set Jaccard of each value vs the target, decided on exact
    gram *strings* (dictionary coding — hashes never touch the verify
    stage, so collisions cannot flip a decision)."""
    coded = encode_token_sets([set(gram_tokens(v, k)) for v in values]
                              + [set(gram_tokens(target, k))])
    sims = F.jaccard_sims(coded[:-1], [coded[-1]] * len(values))
    return sims >= t


def verify_values(values: Sequence[str], spec: FuzzySpec, k: int
                  ) -> np.ndarray:
    """Bool per distinct candidate string: does it satisfy the fuzzy
    predicate?  One batched kernel call for the whole value set."""
    if not values:
        return np.zeros(0, dtype=bool)
    _fld, kind, target, param = spec[:4]
    if kind == "ed":
        return np.asarray(F.edit_distances(values, target, int(param))
                          <= int(param))
    return _jaccard_values(values, target, float(param), k)


def verify_mask(batch: Any, mask: np.ndarray, spec: FuzzySpec, k: int
                ) -> np.ndarray:
    """Refine a candidate position bitmap: keep only positions whose
    field value passes the batched verifier.  Dictionary-coded columns
    verify per distinct code; ``obj`` columns (open-type drift) verify
    per distinct string via a host dictionary; non-string values never
    match (the predicate contract)."""
    fld = spec[0]
    out = np.zeros(mask.shape[0], dtype=bool)
    if not mask.any():
        return out
    col = batch.columns.get(fld)
    if col is None:
        return out
    pos = np.nonzero(mask)[0]
    if col.kind == "str":
        vals = col.values or []
        valid = col.valid[pos]
        if not valid.any():
            return out
        cpos = pos[valid]
        codes = col.data[cpos].astype(np.int64)
        used = np.unique(codes)
        ok_used = verify_values([vals[c] for c in used.tolist()], spec, k)
        lut = np.zeros(max(len(vals), 1), dtype=bool)
        lut[used] = ok_used
        out[cpos[lut[codes]]] = True
        return out
    # obj column: distinct-string verification through a host dictionary
    raw = [col.data[p] if col.valid[p] else None for p in pos.tolist()]
    distinct = sorted({v for v in raw if isinstance(v, str)})
    if not distinct:
        return out
    ok = dict(zip(distinct, verify_values(distinct, spec, k).tolist()))
    for p, v in zip(pos.tolist(), raw):
        if isinstance(v, str) and ok[v]:
            out[p] = True
    return out


def encode_token_sets(token_sets: Sequence[Set[str]]
                      ) -> List[np.ndarray]:
    """Dictionary-code token sets against one shared vocabulary (codes
    assigned first-seen — any bijection preserves intersections): each
    set becomes a sorted distinct int64 code array, ready for the
    batched intersection kernel."""
    vocab: Dict[str, int] = {}
    out: List[np.ndarray] = []
    for s in token_sets:
        if s:
            arr = np.fromiter((vocab.setdefault(t, len(vocab))
                               for t in s), np.int64, count=len(s))
            arr.sort()
        else:
            arr = np.zeros(0, dtype=np.int64)
        out.append(arr)
    return out


def _pair_indices(pairs: Sequence[Tuple[Any, Any]]):
    """(distinct record ids, left row index per pair, right row index per
    pair).  Uniform scalar ids (the common case) dedup and index through
    numpy; anything else falls back to a python dictionary."""
    import itertools
    P = len(pairs)
    try:
        # one float64 pass, then an exactness gate: non-integral ids,
        # or ids beyond float64's exact-integer range, take the generic
        # dictionary path instead of being silently truncated
        flatf = np.fromiter(itertools.chain.from_iterable(pairs),
                            np.float64, count=2 * P).reshape(P, 2)
        if not (np.abs(flatf) < 2.0 ** 53).all():   # also rejects inf/nan
            raise TypeError("pair ids beyond exact-int float range")
        flat = flatf.astype(np.int64)
        if not (flat == flatf).all():               # non-integral ids
            raise TypeError("non-integral pair ids")
        uniq = np.unique(flat)
        pos = np.searchsorted(uniq, flat)
        return list(uniq.tolist()), \
            np.ascontiguousarray(pos[:, 0]), np.ascontiguousarray(pos[:, 1])
    except (TypeError, ValueError, OverflowError):
        ids = sorted({r for p in pairs for r in p}, key=str)
        id_pos = {rid: i for i, rid in enumerate(ids)}
        ai = np.fromiter((id_pos[a] for a, _ in pairs), np.int64,
                         count=len(pairs))
        bi = np.fromiter((id_pos[b] for _, b in pairs), np.int64,
                         count=len(pairs))
        return ids, ai, bi


def jaccard_pair_sims(pairs: Sequence[Tuple[Any, Any]],
                      toks: Dict[Any, Set[str]]) -> np.ndarray:
    """Exact float64 Jaccard per candidate pair (the FuzzyJoin verify
    stage): each record is dictionary-coded *once*, every candidate pair
    gathers its two encoded rows by index, and one batched intersection
    pass scores them all — per-pair work is a fancy-index, not python
    set algebra.  Small vocabularies (the common dedup case) ride the
    bitset/popcount kernel — a record is a few uint32 words; larger ones
    fall back to the sentinel-padded sorted-codes kernel."""
    if not pairs:
        return np.zeros(0, dtype=np.float64)
    ids, ai, bi = _pair_indices(pairs)
    R = len(ids)
    sizes = np.fromiter((len(toks[r]) for r in ids), np.int64, count=R)
    total = int(sizes.sum())
    vocab: Dict[str, int] = {}
    codes = np.fromiter((vocab.setdefault(t, len(vocab))
                         for r in ids for t in toks[r]),
                        np.int64, count=total)
    seg = np.repeat(np.arange(R, dtype=np.int64), sizes)
    if len(vocab) <= (1 << 15):
        bits = F.encode_bitsets(codes, seg, R, len(vocab))
        inter = F.bitset_intersect_counts(bits, ai, bi)
    else:
        # wide vocabulary: sorted-code rows in one sentinel-padded matrix
        order = np.lexsort((codes, seg))
        codes_sorted = codes[order]
        offs = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(sizes, out=offs[1:])
        width = max(int(sizes.max()) if R else 0, 1)
        mat = np.full((R, width), F._SENTINEL, dtype=np.int64)
        mat[seg, np.arange(total) - np.repeat(offs[:-1], sizes)] = \
            codes_sorted
        inter = F.set_intersect_counts_padded(
            mat[ai], sizes[ai], mat[bi], sizes[bi])
    return F.jaccard_from_counts(inter, sizes[ai].astype(np.float64),
                                 sizes[bi].astype(np.float64))
