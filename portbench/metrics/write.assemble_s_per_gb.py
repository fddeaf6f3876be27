"""The encode's container assembly: seconds of the program's
``write.assemble`` spans per raw GB compressed."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'write.assemble')
