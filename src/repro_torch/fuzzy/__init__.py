"""Fuzzy query subsystem (paper §2.1/§5: "support for fuzzy ... types and
queries", the ngram(k) index kind and T-occurrence candidate generation).

  ngram.py   — GramPostings: per-LSM-component columnar CSR postings
               (sorted gram-hash dictionary + offsets + row positions),
               query planning (gram hashing, T-occurrence thresholds),
               and the scalar oracle predicates
  verify.py  — batched candidate verification: banded edit-distance DP
               and dictionary-coded Jaccard over whole candidate sets

The counting, DP and set-intersection hot paths live in
``kernels/fuzzy_ops.py``: hand-written CUDA kernels (K4, K5, K6 and the
bitset popcount) for CUDA operands, their plain PyTorch versions for CPU
operands, with the dispatch pattern of ``kernels/columnar_ops.py``.
"""

from .ngram import (GRAM_K, FuzzySpec, GramPostings, fuzzy_predicate,
                    query_grams, spec_gram_length, value_gram_hashes)
from .verify import (encode_token_sets, jaccard_pair_sims, verify_mask,
                     verify_values)

__all__ = ["GRAM_K", "FuzzySpec", "GramPostings", "fuzzy_predicate",
           "query_grams", "spec_gram_length", "value_gram_hashes",
           "encode_token_sets", "jaccard_pair_sims", "verify_mask",
           "verify_values"]
