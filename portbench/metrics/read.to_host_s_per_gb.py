"""The bulk read's fetch: seconds of the program's ``decode.to_host``
spans (each decoded batch copied to host memory, the wait for its last
kernel included) per decoded GB."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.to_host')
