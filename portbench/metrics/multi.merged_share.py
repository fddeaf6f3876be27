"""``decompress_multi``'s merged share, in %: readers x chunks of the
window's calls that returned merged arrays (the program's counter
``decode.multi_merged_chunks``) over those and the ones that ended in
the per-reader fallback (``decode.multi_fallback_chunks``); None where
the program counts neither."""

from portbench import progspans

MERGED = 'decode.multi_merged_chunks'
FALLBACK = 'decode.multi_fallback_chunks'


def read(run):
    trace = progspans.program()
    if trace is None:
        return None
    counters = trace.counter_stats()
    merged, fallback = counters.get(MERGED, 0), counters.get(FALLBACK, 0)
    if merged + fallback <= 0:
        return None
    return 100.0 * merged / (merged + fallback)
