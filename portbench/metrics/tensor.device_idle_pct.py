"""A decode onto the card: the device's idle share of the traced window,
in % (``read.device_idle_pct`` of a bulk read into host memory)."""


def read(run):
    return run.trace.idle_pct() if run.trace else None
