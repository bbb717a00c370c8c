"""The split over keys that the cluster kernels (the paged and the
beam-decode attention) launch with, from what the card holds."""
from __future__ import annotations

from typing import Callable

MAX_SPLITS = 16   # CTAs per cluster: 8 are portable, 16 where the card allows it


def one_wave_split(clusters: int, most: int, capacity: Callable[[int], int]) -> int:
    """The largest split, at most MAX_SPLITS and at most `most`, whose
    `clusters` clusters the card holds all at once: `capacity(splits)` is
    how many clusters of `splits` CTAs it holds. A second wave of clusters
    costs more than the split saves."""
    splits = max(1, min(MAX_SPLITS, most))
    while splits > 1 and clusters > capacity(splits):
        splits -= 1
    return splits
