"""Partitioned datasets, the query executor, and state carried over from
the reference package (``carry``)."""
