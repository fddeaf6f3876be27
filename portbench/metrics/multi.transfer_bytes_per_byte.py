"""A rig's merged read: bytes the program copied between host and device,
both ways (its ``transfer.h2d_bytes`` and ``transfer.d2h_bytes``
counters), per decoded byte (``read.transfer_bytes_per_byte`` of a bulk
read of one probe)."""

from portbench import progspans


def read(run):
    return progspans.transfer_bytes_per_byte(run)
