"""Compressing a recording, in a traced run: raw MB of every
``compress()`` call of the window, over the time from the window's start
to the last completion."""


def read(run):
    return run.bytes / 1e6 / run.span_s
