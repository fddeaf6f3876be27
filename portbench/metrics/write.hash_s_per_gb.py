"""The Writer's hashing: seconds of the program's ``write.hash`` spans
(the SHA1s of the raw and the compressed bytes, on the hasher threads,
summed over both) per raw GB compressed."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'write.hash')
