"""ngram(k) postings: the columnar secondary-index structure behind the
fuzzy query paths (the ``"ngram"`` index kind ``core/rewriter`` reserved).

Ngram postings are not an LSMIndex of (key, pk) pairs: each *primary*
component carries a ``GramPostings`` per indexed field, built at
flush/merge alongside the component's ColumnBatch (and from the batch's
string dictionary, not by re-tokenizing rows).  This per-component
derived-columnar-data calculus now covers every secondary kind — the
btree/rtree/keyword structures are the same pattern generalized
(``columnar/postings.FieldPostings``, which also hosts the shared CSR
builders this module uses).  The structure is a columnar CSR:

  grams      sorted distinct uint64 FNV-1a gram hashes
  offsets    int64 [G+1] segment bounds into ``positions``
  positions  int64 component-local row positions, one entry per
             (distinct gram, row) pair
  has_value  bool bitmap: row holds an indexable string at all (the
             T <= 0 fallback candidate set)

Candidate generation is T-occurrence: a query's gram-hit posting
segments (slices of each component's immutable ``positions`` array, so
resident postings ship nothing to the device) go to one count kernel
(K4, ``kernels/fuzzy_ops.t_occurrence_mask``), which keeps positions
with >= T hits.  The thresholds are the classic lower bounds, adjusted for
hashing so collisions can only add false positives (verification removes
them), never false negatives:

  edit distance d    T = |H(set G(q))| - k*d      (an edit destroys at
                     most k gram occurrences, hence at most k distinct
                     gram types)
  jaccard >= t       T = ceil(t * |set G(q)|) - (|set G(q)| - |H(...)|)
                     (J >= t implies |A∩B| >= t*|A∪B| >= t*|A|; the
                     subtrahend discounts in-query hash collisions)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..columnar.postings import csr_from_pairs, segment_gather
from ..core.functions import (edit_distance_check, gram_tokens,
                              similarity_jaccard_check)
from ..kernels.fuzzy_ops import Segment, fnv1a_hash

__all__ = ["GRAM_K", "GramPostings", "FuzzySpec", "spec_gram_length",
           "value_gram_hashes", "query_grams", "fuzzy_predicate"]

GRAM_K = 3                      # default gram length (AsterixDB's ngram(3))

# (field, kind, target, param[, k]): kind "ed" ->
# edit_distance_check(value, target, param); kind "jaccard" ->
# similarity_jaccard_check over gram_tokens(value, k) vs
# gram_tokens(target, k) at threshold param.  The optional 5th element
# pins the gram length the *predicate* is defined over (default GRAM_K);
# the index's own gram length only shapes the candidate postings.
FuzzySpec = Tuple[str, str, str, Any]


def spec_gram_length(spec: FuzzySpec) -> int:
    """The gram length the spec's predicate semantics are defined over."""
    return int(spec[4]) if len(spec) > 4 else GRAM_K

_EMPTY_U64 = np.zeros(0, dtype=np.uint64)
_EMPTY_I64 = np.zeros(0, dtype=np.int64)


def value_gram_hashes(s: str, k: int) -> np.ndarray:
    """Sorted distinct gram hashes of one string (set semantics: the
    T-occurrence bounds above are stated over distinct grams)."""
    return np.unique(fnv1a_hash(gram_tokens(s, k)))


# CSR segment expansion and assembly are shared with the generalized
# secondary postings (columnar/postings.py): one copy of the pattern for
# ngram, btree, rtree and keyword structures.
_segment_gather = segment_gather


@dataclass
class GramPostings:
    """Per-component columnar CSR gram postings (immutable, like the
    component batch it sits beside)."""

    k: int
    grams: np.ndarray       # sorted distinct uint64 hashes
    offsets: np.ndarray     # int64 [G+1]
    positions: np.ndarray   # int64 row positions, grouped by gram
    has_value: np.ndarray   # bool [n_rows]
    n_rows: int
    @classmethod
    def _empty(cls, k: int, has_value: np.ndarray) -> "GramPostings":
        return cls(k, _EMPTY_U64, np.zeros(1, dtype=np.int64), _EMPTY_I64,
                   has_value, int(has_value.shape[0]))

    @classmethod
    def _from_pairs(cls, k: int, all_h: np.ndarray, all_pos: np.ndarray,
                    has_value: np.ndarray) -> "GramPostings":
        n = int(has_value.shape[0])
        if all_h.shape[0] == 0:
            return cls._empty(k, has_value)
        grams, offsets, positions = csr_from_pairs(all_h, all_pos)
        return cls(k, grams, offsets, positions, has_value, n)

    @classmethod
    def from_values(cls, vals: Sequence[Any], k: int) -> "GramPostings":
        """Build from python values (memtable rows, obj-kind columns):
        tokenization runs once per *distinct* string via a host cache;
        CSR assembly is pure numpy."""
        n = len(vals)
        cache: Dict[str, np.ndarray] = {}
        per_row: List[np.ndarray] = []
        has = np.zeros(n, dtype=bool)
        for i, v in enumerate(vals):
            if isinstance(v, str):
                hs = cache.get(v)
                if hs is None:
                    cache[v] = hs = value_gram_hashes(v, k)
                per_row.append(hs)
                has[i] = True
            else:
                per_row.append(_EMPTY_U64)
        counts = np.fromiter((h.shape[0] for h in per_row), np.int64,
                             count=n)
        if n == 0 or counts.sum() == 0:
            return cls._empty(k, has)
        all_h = np.concatenate(per_row)
        all_pos = np.repeat(np.arange(n, dtype=np.int64), counts)
        return cls._from_pairs(k, all_h, all_pos, has)

    @classmethod
    def from_column(cls, col: Any, k: int) -> "GramPostings":
        """Build from a dictionary-coded string column: grams are hashed
        once per dictionary value and expanded to rows by gathering code
        segments — no per-row tokenization."""
        if col.kind != "str":
            return cls.from_values(
                [v if isinstance(v, str) else None for v in col.decode()],
                k)
        n = len(col)
        vals = col.values or []
        per_val = [value_gram_hashes(v, k) for v in vals]
        vcounts = np.fromiter((h.shape[0] for h in per_val), np.int64,
                              count=len(vals))
        voffs = np.zeros(len(vals) + 1, dtype=np.int64)
        np.cumsum(vcounts, out=voffs[1:])
        flat = np.concatenate(per_val) if per_val else _EMPTY_U64
        has = col.valid.copy()
        pos = np.nonzero(col.valid)[0].astype(np.int64)
        if pos.shape[0] == 0:
            return cls._empty(k, has)
        codes = col.data[pos].astype(np.int64)
        counts = vcounts[codes]
        if int(counts.sum()) == 0:
            return cls._empty(k, has)
        return cls._from_pairs(k, _segment_gather(flat, voffs[codes],
                                                  counts),
                               np.repeat(pos, counts), has)

    @classmethod
    def from_batch(cls, batch: Any, fld: str, k: int, n_rows: int
                   ) -> "GramPostings":
        col = batch.columns.get(fld)
        if col is None:
            return cls._empty(k, np.zeros(n_rows, dtype=bool))
        return cls.from_column(col, k)

    def _found(self, query_hashes: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(start, stop) into ``positions`` of each query gram present in
        this component."""
        if self.grams.shape[0] == 0 or query_hashes.shape[0] == 0:
            return _EMPTY_I64, _EMPTY_I64
        lo = np.searchsorted(self.grams, query_hashes, side="left")
        hi = np.searchsorted(self.grams, query_hashes, side="right")
        g = lo[hi > lo]
        return self.offsets[g], self.offsets[g + 1]

    def hit_positions(self, query_hashes: np.ndarray) -> np.ndarray:
        """Concatenated posting segments of the query grams present in
        this component: one int64 position per (query gram, row) hit,
        assembled by vectorized segment gathering (no python lists)."""
        starts, stops = self._found(query_hashes)
        if not starts.shape[0]:
            return _EMPTY_I64
        return _segment_gather(self.positions, starts, stops - starts)

    def hit_segments(self, query_hashes: np.ndarray, offset: int
                     ) -> List[Segment]:
        """The same hits as ``hit_positions`` (shifted by ``offset``), as
        one K4 :class:`Segment` per query gram found: slices of this
        postings' own immutable ``positions`` array, so the device pool
        keeps it resident and a warm probe ships no positions.  Each slice
        ascends (``csr_from_pairs`` groups by a stable sort of row-ordered
        pairs), so it is marked ``sorted``."""
        starts, stops = self._found(query_hashes)
        return [Segment(self.positions, a, b, offset, sorted=True)
                for a, b in zip(starts.tolist(), stops.tolist())]


def query_grams(spec: FuzzySpec, index_k: int) -> Tuple[np.ndarray, int]:
    """(sorted distinct query gram hashes, T-occurrence threshold) for a
    fuzzy spec against an ngram(``index_k``) index.  T <= 0 means the
    index cannot prune: every row with an indexable value is a candidate
    (the caller's ``has_value`` path).  Edit distance bounds hold for any
    gram length; a Jaccard spec whose own gram length differs from the
    index's gets no pruning (the bound would not be sound), only the
    batched verify."""
    _fld, kind, target, param = spec[:4]
    if kind == "jaccard" and spec_gram_length(spec) != index_k:
        return np.zeros(0, dtype=np.uint64), 0
    grams = sorted(set(gram_tokens(target, index_k)))
    qh = np.unique(fnv1a_hash(grams))
    if kind == "ed":
        return qh, int(qh.shape[0]) - index_k * int(param)
    if kind == "jaccard":
        deficit = len(grams) - int(qh.shape[0])
        return qh, int(math.ceil(float(param) * len(grams) - 1e-9)) - deficit
    raise ValueError(f"unknown fuzzy predicate kind {kind!r}")


def fuzzy_predicate(spec: FuzzySpec) -> Callable:
    """The row-engine oracle for a fuzzy spec — exactly the predicate the
    batched verification kernels reproduce, so plans can pass
    ``pred=fuzzy_predicate(spec), fuzzy=spec`` and both engines agree.
    Jaccard gram length comes from the spec (5th element, default
    GRAM_K).  Non-string / absent values never match."""
    fld, kind, target, param = spec[:4]
    if kind == "ed":
        return lambda r: isinstance(r.get(fld), str) \
            and edit_distance_check(r[fld], target, param)
    if kind == "jaccard":
        k = spec_gram_length(spec)
        tg = gram_tokens(target, k)
        return lambda r: isinstance(r.get(fld), str) \
            and similarity_jaccard_check(gram_tokens(r[fld], k), tg, param)
    raise ValueError(f"unknown fuzzy predicate kind {kind!r}")
