"""The encode's upload: seconds of the program's ``write.upload`` spans
(each batch copied to the device) per raw GB compressed."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'write.upload')
