"""A rig's merged read: the device's idle time in the traced window that
no program span covers, in % of its idle time
(``read.unspanned_idle_pct`` of a bulk read of one probe)."""

from portbench import progspans


def read(run):
    return progspans.unspanned_idle_pct(run)
