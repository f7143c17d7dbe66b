"""Unions of device intervals and the gaps between them."""

from __future__ import annotations

from typing import Iterable, List, Tuple


def union(intervals: Iterable[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(merged: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] outside the disjoint sorted `merged`."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
