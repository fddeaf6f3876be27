"""The benchmark's arithmetic: rates over a window, percentiles over
every request, and unions of time intervals. Frozen with the benchmark,
so that what a metric means does not move with the program."""

import math
import statistics


def percentile(values, q):
    """The nearest-rank ``q``-th percentile: the smallest value that at
    least ``q`` % of ``values`` do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def spread(values):
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles``' exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge(intervals):
    """Sorted, disjoint ``(start, end)`` intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def union_length(intervals, lo, hi):
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))


def gaps(intervals, lo, hi):
    """The parts of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
