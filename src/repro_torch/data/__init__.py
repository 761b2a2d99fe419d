"""Data pipelines on top of the engine: ``dedup`` (MinHash-LSH fuzzy self-join)."""
