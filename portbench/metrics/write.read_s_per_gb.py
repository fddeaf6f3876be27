"""The Writer's chunk reads: seconds of the program's ``write.read`` spans
(the memmapped chunks sliced and paged in) per raw GB compressed."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'write.read')
