"""The decode's parse: seconds of the program's ``decode.parse`` spans
(each chunk's payload read and parsed, the headers peeked) per decoded
GB."""

from portbench import progspans


def read(run):
    return progspans.span_s_per_gb(run, 'decode.parse')
