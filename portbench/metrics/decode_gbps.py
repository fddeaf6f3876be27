"""Bulk reads: decoded GB of every call of the window, over the time from
the window's start to the last call's completion."""


def read(run):
    return run.bytes / 1e9 / run.span_s
