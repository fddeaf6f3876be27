"""The program's own spans and counters, with its spans on the device
trace's clock.

The program (``mtscomp_tpu_torch.utils.trace``) keeps an event for every
span it closed while tracing was on, in every thread, on
``time.perf_counter_ns``'s clock (``span_events()``), and counters of
what it moved between host and device (``counter_stats()``). The
profiler records a ``record_function`` only on the thread that started
it, so the spans of the program's worker threads are missing from the
device trace; they are placed here instead. The harness's call spans
exist on both clocks: as ``portbench.<call>`` events in the trace
(``devtrace.Trace.spans``) and as ``perf_counter`` times in
``Run.calls``. The offset between the clocks is the median, over the
window's calls, of a call span's start in the trace minus its start in
``Run.calls``.

``run.py`` resets the program's stats when the window starts and turns
tracing off when it ends, before its check, so what is read here holds
exactly the window. A program without span events or counters gives
None, and so does every reader built on them.
"""

import copy
import statistics

from . import devtrace, stats

#: Counters of the bytes the program copied between host and device.
TRANSFERS = ('transfer.h2d_bytes', 'transfer.d2h_bytes')


def program():
    """The program's tracing module, or None where it keeps no span
    events or counters."""
    try:
        from mtscomp_tpu_torch.utils import trace
    except ImportError:
        return None
    if not (hasattr(trace, 'span_events')
            and hasattr(trace, 'counter_stats')):
        return None
    return trace


def span_s_per_gb(run, name):
    """Seconds of the program's spans ``name`` (every thread's, as
    ``phase_stats()`` sums them) per GB of the window's calls; None
    where none opened."""
    if not run.spans or name not in run.spans:
        return None
    return run.spans[name][1] / (run.bytes / 1e9)


def transfer_bytes_per_byte(run):
    """Bytes the program copied between host and device (both ways) per
    byte of the window's calls; None where it counted none."""
    trace = program()
    if trace is None or not run.bytes:
        return None
    counters = trace.counter_stats()
    if not any(k in counters for k in TRANSFERS):
        return None
    return sum(counters.get(k, 0) for k in TRANSFERS) / run.bytes


def clock_offset(run):
    """Seconds to add to a ``perf_counter`` time to place it on the
    trace's clock; None where the trace and ``Run.calls`` do not hold
    the same calls."""
    if not run.trace or not run.calls:
        return None
    starts = sorted(s for s, _, n in run.trace.spans
                    if n.startswith(devtrace.CALL_SPAN))
    if len(starts) != len(run.calls):
        return None
    return statistics.median(t - c[0] for t, c in zip(starts, run.calls))


def mapped_spans(run, events=None):
    """``(start, end, name, thread name)`` of every program span on the
    trace's clock, in seconds; None where the program keeps no events or
    the clocks cannot be matched."""
    if events is None:
        trace = program()
        if trace is None:
            return None
        events = trace.span_events()
    offset = clock_offset(run)
    if offset is None:
        return None
    return [(e.start_ns * 1e-9 + offset, e.end_ns * 1e-9 + offset, e.name,
             e.thread_name) for e in events]


def _device_idle(tr):
    return stats.gaps([(s, e) for s, e, _, _ in tr.device], tr.lo, tr.hi)


def _overlap(a, b):
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def unspanned_idle_pct(run, events=None):
    """Share of the window's device idle time in which no program span
    was open in any thread, in % (the harness's call span does not
    count); None where the trace holds no device operation or the
    program's spans cannot be placed."""
    tr = run.trace
    if not tr or not tr.device or tr.window_s <= 0:
        return None
    spans = mapped_spans(run, events)
    if spans is None:
        return None
    idle = _device_idle(tr)
    idle_s = sum(e - s for s, e in idle)
    if idle_s <= 0:
        return None
    covered = _overlap(idle, stats.merge([(s, e) for s, e, _, _ in spans]))
    return 100.0 * (idle_s - covered) / idle_s


def thread_group(name):
    """A thread's name without a pool's worker number (``mts-hasher_1``
    -> ``mts-hasher``)."""
    base, _, num = name.rpartition('_')
    return base if base and num.isdigit() else name


def idle_by_thread(run, events=None, top=10):
    """``{thread: [[span, seconds]]}``: for each thread that opened a
    program span (a pool's workers together), the device's idle time in
    the window summed by the innermost program span open in that thread,
    ``'(no span)'`` where none was; None where the spans cannot be
    placed. The breakdown of where the idle time went, for the notes."""
    tr = run.trace
    spans = mapped_spans(run, events) if tr and tr.device else None
    if spans is None:
        return None
    out = {}
    for group in sorted({thread_group(t) for _, _, _, t in spans}):
        view = copy.copy(tr)
        view.spans = [(s, e, n) for s, e, n, t in spans
                      if thread_group(t) == group]
        out[group] = view.idle_gaps(top)
    return out
