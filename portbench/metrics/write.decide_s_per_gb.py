"""The encode's host decisions: seconds of the program's ``write.decide``
spans (histograms fetched, plane modes and tables decided, symbols
gathered and K6's inputs staged) per raw GB compressed."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'write.decide')
