"""A rig's merged read: seconds of the program's ``decode.to_host`` spans
(each batch's staged fetch into host memory) per decoded GB
(``read.to_host_s_per_gb`` of a bulk read of one probe)."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.to_host')
