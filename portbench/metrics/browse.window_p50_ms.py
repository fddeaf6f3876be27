"""The median latency of the window requests of the traced run, in ms:
steadier than the tail, and moved by the same path."""

import statistics


def read(run):
    return statistics.median(run.latencies_ms)
