"""The device's idle share of the traced window, in %: the time in which
no kernel, copy or fill ran on it (``portbench.devtrace``)."""


def read(run):
    return run.trace.idle_pct() if run.trace else None
