"""Partition runtime (rung 4): stacked launches over the partition lanes
of one device; see ``spmd``."""
