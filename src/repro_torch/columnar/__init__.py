"""Columnar vectorized query engine (after Alkowaileet & Carey's columnar
formats for schemaless LSM document stores, PAPERS.md).

Bridges the ADM record world (core/adm, storage/) onto dense arrays the
jax/Pallas substrate can chew on:

  schema.py    — column-kind inference from a RecordType + observed open
                 fields (schemaless records still get columns)
  batch.py     — ColumnBatch: dense arrays + validity bitmaps + a sorted
                 string dictionary per column
  operators.py — vectorized physical operators over batches (filter,
                 project, aggregate, group, sort/top-k, hash join,
                 hash repartitioning)
  lower.py     — lowers supported PhysicalOp subplans to columnar
                 pipelines for storage/query.Executor(vectorize=True)

The predicate/reduction hot path lives in kernels/columnar_ops.py
(fused Pallas kernels on TPU, jnp fallback elsewhere).
"""

from .batch import Column, ColumnBatch
from .schema import ColumnSchema, infer_kind, unify_kinds

__all__ = ["Column", "ColumnBatch", "ColumnSchema", "infer_kind",
           "unify_kinds"]
