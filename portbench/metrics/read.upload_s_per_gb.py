"""The decode's upload: seconds of the program's ``decode.upload`` spans
(the staged batch copied to the device, inside ``decode.pack``) per
decoded GB."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.upload')
