"""A rig's merged read: seconds of the program's ``decode.upload`` spans
(the staged batch copied to the device, inside ``decode.pack``) per
decoded GB (``read.upload_s_per_gb`` of a bulk read of one probe)."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.upload')
