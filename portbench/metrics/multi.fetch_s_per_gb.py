"""A rig's merged read: seconds of the program's ``decode.fetch`` spans
(the word-count audit, a batch's first wait for the device) per decoded
GB (``read.fetch_s_per_gb`` of a bulk read of one probe)."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.fetch')
