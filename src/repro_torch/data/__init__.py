"""Data pipelines on top of the engine: ``feeds`` (continuous ingestion
with joints, cursors and replay) and ``dedup`` (MinHash-LSH fuzzy
self-join)."""
