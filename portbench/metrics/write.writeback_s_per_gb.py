"""The Writer's write-back: seconds of the program's ``write.writeback``
spans (the ordered writes of each batch's containers, on the calling
thread) per raw GB compressed."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'write.writeback')
