"""Bytes the decode copied between host and device, both ways (the
program's ``transfer.h2d_bytes`` and ``transfer.d2h_bytes`` counters),
per decoded byte."""

from portbench import progspans


def read(run):
    return progspans.transfer_bytes_per_byte(run)
