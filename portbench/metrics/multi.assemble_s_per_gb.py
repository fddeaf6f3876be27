"""A rig's merged read: seconds of the program's ``decode.assemble`` spans
(the probes' arrays allocated and each fetched batch's rows copied into
them) per decoded GB (``read.assemble_s_per_gb`` of a bulk read of one
probe)."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.assemble')
