"""Browsing: the 95th percentile (nearest rank) of the latency of every
window request of the run, in ms."""

from portbench import stats


def read(run):
    return stats.percentile(run.latencies_ms, 95)
