"""The bulk read's assembly: seconds of the program's ``decode.assemble``
spans (the result allocated and each fetched batch copied into it) per
decoded GB."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.assemble')
