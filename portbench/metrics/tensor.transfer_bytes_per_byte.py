"""A decode onto the card: bytes the program copied between host and
device, both ways (its ``transfer.h2d_bytes`` and ``transfer.d2h_bytes``
counters), per decoded byte (``read.transfer_bytes_per_byte`` of a bulk
read into host memory)."""

from portbench import progspans


def read(run):
    return progspans.transfer_bytes_per_byte(run)
