"""Bytes that ``decompress_multi``'s merged path copied from a batch's
host block into the probes' arrays (the program's counter
``decode.multi_recopied_bytes``), per decoded byte of the window's
calls: 1 where every call's range takes several batches, 0 where each is
one batch or each probe's rows are fetched straight into its array; None
where the program does not count them."""

from portbench import progspans

RECOPIED = 'decode.multi_recopied_bytes'


def read(run):
    trace = progspans.program()
    if trace is None or not run.bytes:
        return None
    counters = trace.counter_stats()
    if RECOPIED not in counters:
        return None
    return counters[RECOPIED] / run.bytes
