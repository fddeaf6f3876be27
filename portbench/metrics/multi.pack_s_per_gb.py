"""A rig's merged read: seconds of the program's ``decode.pack`` spans
per decoded GB (``read.pack_s_per_gb`` of a bulk read of one probe)."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.pack')
