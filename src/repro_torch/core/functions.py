"""Advanced-type functions (paper Table 1): text similarity, spatial, and
temporal-binning primitives used by the fuzzy/spatial/temporal query paths.
"""

from __future__ import annotations

import datetime as _dt
import math
import re
from typing import Iterable, List, Sequence, Set, Tuple

__all__ = [
    "edit_distance", "edit_distance_check", "word_tokens",
    "similarity_jaccard", "similarity_jaccard_check", "gram_tokens",
    "spatial_distance", "spatial_intersect_circle", "spatial_cell",
    "interval_bin",
]


# -- text ---------------------------------------------------------------------

def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (banded DP not needed at these lengths)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def edit_distance_check(a: str, b: str, d: int) -> bool:
    """Early-exit check (paper: edit-distance-check): length filter first."""
    if abs(len(a) - len(b)) > d:
        return False
    return edit_distance(a, b) <= d


_WORD_RE = re.compile(r"[a-z0-9]+")


def word_tokens(s: str) -> List[str]:
    return _WORD_RE.findall(s.lower())


def gram_tokens(s: str, k: int = 3) -> List[str]:
    """ngram(k) tokens (the paper's fuzzy-search index unit)."""
    padded = f"{'#' * (k - 1)}{s.lower()}{'#' * (k - 1)}"
    return [padded[i:i + k] for i in range(len(padded) - k + 1)]


def similarity_jaccard(a: Iterable, b: Iterable) -> float:
    sa, sb = set(a), set(b)
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / len(sa | sb)


def similarity_jaccard_check(a: Iterable, b: Iterable, t: float) -> bool:
    return similarity_jaccard(a, b) >= t


# -- spatial ------------------------------------------------------------------

def spatial_distance(p1: Sequence[float], p2: Sequence[float]) -> float:
    return math.hypot(p1[0] - p2[0], p1[1] - p2[1])


def spatial_intersect_circle(p: Sequence[float], center: Sequence[float],
                             radius: float) -> bool:
    return spatial_distance(p, center) <= radius


def spatial_cell(p: Sequence[float], cell: float) -> Tuple[int, int]:
    """Grid cell of a point — the unit of the grid-bucketed 'rtree' index."""
    return (math.floor(p[0] / cell), math.floor(p[1] / cell))


def cells_covering_circle(center: Sequence[float], radius: float,
                          cell: float) -> List[Tuple[int, int]]:
    x0, y0 = spatial_cell((center[0] - radius, center[1] - radius), cell)
    x1, y1 = spatial_cell((center[0] + radius, center[1] + radius), cell)
    return [(x, y) for x in range(x0, x1 + 1) for y in range(y0, y1 + 1)]


# -- temporal -----------------------------------------------------------------

def interval_bin(t: _dt.datetime, origin: _dt.datetime,
                 width: _dt.timedelta) -> _dt.datetime:
    """paper Table 1 interval-bin: the bin start containing ``t`` (used for
    the time-windowed aggregation the third pilot needed)."""
    n = (t - origin) // width
    return origin + n * width
