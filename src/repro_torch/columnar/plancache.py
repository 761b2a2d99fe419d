"""Plan-shape accounting for the fused Figure-6 chain (rung 3): the part
the port has so far.

The reference compiles each secondary-index chain (probe -> bitmap AND ->
live gather -> filter / aggregate) into one cached jit dispatch
(``repro/columnar/plancache.py``, core A6).  That rung is not ported yet:
:func:`compile_chain` returns None, exactly as the reference does after
``set_enabled(False)``, so every chain runs the per-operator columnar
path, whose kernels (K1-K4) this package does port.  :func:`totals` and
:func:`empty_partition_agg` are kept so ``ExecStats`` and
``columnar/lower.py`` read them as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from .batch import ColumnBatch

__all__ = ["PlanCache", "plan_cache", "set_enabled", "totals",
           "compile_chain", "empty_partition_agg"]


class PlanCache:
    """Fused-chain plan accounting: no chain fuses yet, so hits and
    misses stay 0."""

    def __init__(self) -> None:
        self.enabled = True

    def totals(self) -> Tuple[int, int]:
        return 0, 0


plan_cache = PlanCache()


def set_enabled(v: bool) -> None:
    """Kept for parity with the reference; the fused chain is not ported,
    so the per-operator path runs either way."""
    plan_cache.enabled = bool(v)


def totals() -> Tuple[int, int]:
    return plan_cache.totals()


def compile_chain(ds: Any, **_kwargs: Any) -> None:
    """The fused chain (rung 3, core A6) is not ported yet: no chain
    fuses, and ``columnar/lower`` runs the per-operator path."""
    return None


def empty_partition_agg(aggs: Dict[str, Tuple[str, str]]) -> Dict[str, Any]:
    """The partial-aggregate row of an empty partition (what the legacy
    LOCAL_AGG computes for short-circuited / padding partitions)."""
    from . import operators as O
    row, _ = O.aggregate_batch(ColumnBatch({}, 0), aggs, partial=True)
    return row
