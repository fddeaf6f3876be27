"""A rig's merged read: the device's idle share of the traced window, in
% (``read.device_idle_pct`` of a bulk read of one probe)."""


def read(run):
    return run.trace.idle_pct() if run.trace else None
