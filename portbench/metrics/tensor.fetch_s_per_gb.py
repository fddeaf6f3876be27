"""A decode onto the card: seconds of the program's ``decode.fetch``
spans (the word-count audit, the call's one wait for the device) per
decoded GB (``read.fetch_s_per_gb`` of a bulk read into host memory)."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.fetch')
