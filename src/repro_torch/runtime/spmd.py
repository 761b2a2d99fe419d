"""Mesh-parallel partition runtime (rung 4): the part the port has so far.

The reference runs every partition's chain, scan or aggregate as one
``shard_map`` dispatch over a partition mesh (``repro/runtime/spmd.py``).
That rung is not ported yet, and no mesh is ever active in the port:
:func:`active_mesh` is None and the batched entry points return None, as
the reference's do without a mesh, so ``columnar/lower`` keeps its
per-partition loop.  ``storage/query.run_query`` refuses a ``mesh``
argument instead of ignoring it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["active_mesh", "dispatch_totals", "batched_range_masks",
           "batched_select_aggregate", "exchange_batches"]


def active_mesh() -> None:
    return None


def dispatch_totals() -> Tuple[int, int]:
    """(spmd dispatches, partitions covered) — ExecStats diffs these per
    query; without a mesh both stay 0."""
    return (0, 0)


def batched_range_masks(batches: Sequence[Any],
                        ranges: Dict[str, Tuple[Any, Any]]
                        ) -> Optional[List[Optional[Any]]]:
    return None


def batched_select_aggregate(batches: Sequence[Any],
                             ranges: Dict[str, Tuple[Any, Any]],
                             aggs: Dict[str, Tuple[str, str]]
                             ) -> Optional[List[Optional[Tuple]]]:
    return None


def exchange_batches(cparts: Sequence[Any], keys: Sequence[str], p: int
                     ) -> Optional[Tuple[List[Any], int]]:
    return None
