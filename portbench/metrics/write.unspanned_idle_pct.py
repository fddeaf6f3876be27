"""The device's idle time in the traced window that no program span
covers, in % of its idle time: no span of the program's was open in any
thread, the Writer's included (``portbench.progspans``; the harness's call
span does not count)."""

from portbench import progspans


def read(run):
    return progspans.unspanned_idle_pct(run)
