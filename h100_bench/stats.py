"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def rate(amounts: list[float], start: float, ends: list[float]) -> float:
    """Work per second over whole requests: the sum of ``amounts``, each a
    request that completed at the matching entry of ``ends``, over the time
    from ``start`` to the last completion."""
    if not amounts:
        raise ValueError('no request completed')
    return sum(amounts) / (max(ends) - start)


def percentile(samples: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``samples`` (the least
    sample with at least ``q`` per cent of the samples at or below it)."""
    if not samples:
        raise ValueError('no samples')
    ordered = sorted(samples)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]

