"""A decode onto the card: seconds of the program's ``decode.parse``
spans (each chunk's payload read and parsed, the headers peeked) per
decoded GB (``read.parse_s_per_gb`` of a bulk read into host memory)."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.parse')
