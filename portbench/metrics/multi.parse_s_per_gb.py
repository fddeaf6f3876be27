"""A rig's merged read: seconds of the program's ``decode.parse`` spans
(each probe's chunk read and parsed, each batch judged) per decoded GB
(``read.parse_s_per_gb`` of a bulk read of one probe)."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.parse')
