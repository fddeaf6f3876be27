"""A rig's merged read: the decode kernels' share of their roofline, in
%, as ``read.kernels_roofline`` reads a bulk read of one probe: the
least time of the window's decodes (each compressed payload byte read
once, each decoded byte written once, at the card's memory bandwidth:
``portbench.roofline``) over the device time of every kernel that ran
in the window."""

from portbench import roofline


def read(run):
    kernel_s = run.trace.kernel_s() if run.trace else 0.0
    if kernel_s <= 0:
        return None
    return 100.0 * roofline.decode_least_s(run.coded_bytes,
                                           run.bytes) / kernel_s
