"""Partition runtime (rung 4 is not ported yet; see ``spmd``)."""
