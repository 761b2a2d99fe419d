"""Fuzzy joins: Jaccard set-similarity self-join (paper Q13) as a partitioned
MinHash-LSH pipeline, used for near-duplicate detection of training docs.

The paper supports "ad hoc parallel fuzzy joins as well as indexed fuzzy
joins" [23].  We implement the parallel form:

  1. per record: token set -> MinHash signature (k hashes);
  2. LSH banding: records sharing any band hash land in the same bucket —
     this is the MToNHashPartition exchange keyed on band hashes, i.e. the
     candidate-pair generation is a *hash repartition*, exactly the
     paper's parallel set-similarity join skeleton;
  3. verify: exact Jaccard within each bucket, batched — candidate pairs'
     token sets are dictionary-coded and scored by the vectorized set-
     intersection kernel in one pass (post-validation — the same
     validate-after-index discipline as §4.4; ``batch_verify=False``
     keeps the per-pair python loop addressable for benchmarking).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Iterable, List, Sequence, Set, Tuple

import numpy as np

__all__ = ["minhash_signature", "jaccard", "FuzzyJoin"]

_MERSENNE = (1 << 61) - 1


def _hash_family(k: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _MERSENNE, k, dtype=np.int64)
    b = rng.integers(0, _MERSENNE, k, dtype=np.int64)
    return a, b


def _token_hash(tok: str) -> int:
    """Scalar FNV-1a-64 mod the Mersenne prime (the oracle the vectorized
    ``kernels.fuzzy_ops.fnv1a_hash`` path must match bit-for-bit)."""
    h = 14695981039346656037
    for byte in tok.encode():
        h = ((h ^ byte) * 1099511628211) % (1 << 64)
    return h % _MERSENNE


def _token_hashes(tokens: Sequence[str]) -> np.ndarray:
    """Vectorized token hashing: one numpy FNV pass over a padded byte
    matrix (shared with the ngram index's gram hashing) instead of the
    per-token python byte loop."""
    from ..kernels.fuzzy_ops import fnv1a_hash
    h = fnv1a_hash(tokens) % np.uint64(_MERSENNE)
    return h.astype(np.int64)


def minhash_signature(tokens: Iterable[str], k: int = 32, seed: int = 0
                      ) -> np.ndarray:
    a, b = _hash_family(k, seed)
    hs = _token_hashes(sorted(set(tokens)))
    if hs.size == 0:
        return np.full(k, _MERSENNE, dtype=np.int64)
    # (a*h + b) mod p for all k functions x all tokens
    vals = (a[:, None] * hs[None, :] + b[:, None]) % _MERSENNE
    return vals.min(axis=1)


def jaccard(s1: Set[str], s2: Set[str]) -> float:
    if not s1 and not s2:
        return 1.0
    return len(s1 & s2) / len(s1 | s2)


@dataclass
class FuzzyJoin:
    """Self-join: find all pairs with Jaccard(tokens) >= threshold."""

    threshold: float = 0.3
    num_hashes: int = 32
    bands: int = 8
    seed: int = 0
    batch_verify: bool = True   # False: legacy per-pair python verify

    def __post_init__(self):
        assert self.num_hashes % self.bands == 0
        self.rows_per_band = self.num_hashes // self.bands

    def band_keys(self, sig: np.ndarray) -> List[Tuple[int, int]]:
        r = self.rows_per_band
        return [(bi, hash(tuple(sig[bi * r:(bi + 1) * r].tolist())))
                for bi in range(self.bands)]

    def verify(self, candidates: Sequence[Tuple[Any, Any]],
               toks: Dict[Any, Set[str]]) -> List[Tuple[Any, Any, float]]:
        """Stage 3 (post-validation): exact Jaccard over the candidate
        pairs.  Batched by default — one shared token dictionary, one
        vectorized set-intersection pass over every pair (fuzzy/verify) —
        with the per-pair python loop kept for comparison."""
        candidates = list(candidates)
        if self.batch_verify:
            from ..fuzzy.verify import jaccard_pair_sims
            sims = jaccard_pair_sims(candidates, toks)
            return [(a, b, float(j))
                    for (a, b), j in zip(candidates, sims.tolist())
                    if j >= self.threshold]
        pairs = []
        for a, b in candidates:
            j = jaccard(toks[a], toks[b])
            if j >= self.threshold:
                pairs.append((a, b, j))
        return pairs

    def run(self, records: Sequence[Tuple[Any, Set[str]]],
            num_partitions: int = 4
            ) -> Tuple[List[Tuple[Any, Any, float]], Dict[str, int]]:
        """records: (id, token_set).  Returns (pairs, stats)."""
        sigs = {rid: minhash_signature(toks, self.num_hashes, self.seed)
                for rid, toks in records}
        toks = dict(records)
        # stage 2: hash repartition on band keys (candidate generation)
        buckets: Dict[Tuple[int, int], List[Any]] = {}
        for rid, sig in sigs.items():
            for key in self.band_keys(sig):
                buckets.setdefault(key, []).append(rid)
        candidates: Set[Tuple[Any, Any]] = set()
        for key, rids in buckets.items():
            for a, b in itertools.combinations(sorted(rids, key=str), 2):
                candidates.add((a, b))
        # stage 3: verify (post-validation), batched by default
        pairs = self.verify(sorted(candidates, key=str), toks)
        stats = {"records": len(records), "buckets": len(buckets),
                 "candidates": len(candidates), "pairs": len(pairs)}
        return pairs, stats

    def brute_force(self, records: Sequence[Tuple[Any, Set[str]]]
                    ) -> List[Tuple[Any, Any, float]]:
        """Oracle for tests (recall measurement)."""
        out = []
        for (a, ta), (b, tb) in itertools.combinations(records, 2):
            j = jaccard(ta, tb)
            if j >= self.threshold:
                key = (a, b) if str(a) <= str(b) else (b, a)
                out.append((key[0], key[1], j))
        return out
