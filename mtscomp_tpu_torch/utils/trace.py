"""Phase tracing: named spans over codec phases, and counters.

Each phase is a context manager that (a) logs its duration at the trace
level, (b) opens a ``torch.profiler.record_function`` so the work shows
up named in a ``torch.profiler`` trace (CPU or CUDA), (c) feeds an
in-process aggregator queryable via :func:`phase_stats`, and (d) keeps
one event (:class:`SpanEvent`) queryable via :func:`span_events`: its
name, start and end on ``time.perf_counter_ns``'s clock, its thread,
the span it opened under and the request it belongs to. Enable with
``MTSCOMP_TRACE=1`` or :func:`enable_tracing`.

A request is one call of a public entry point (``Reader.to_array``,
``Reader.to_tensor``, ``Reader.__getitem__``, ``Writer.write``), scoped
by :func:`request_scope`; calls nested in it keep its id. The current
request and span live in a ``contextvars`` variable, so work submitted
to a thread pool through ``contextvars.copy_context().run`` keeps them.
The profiler records a ``record_function`` only on the thread that
started it; the events record every thread, on a clock a trace can be
mapped onto.

:func:`count` adds to named counters (:func:`counter_stats`), kept apart
from the phases.

The durations are host-clock times. Kernels are launched asynchronously,
so a phase that ends on device work reads the time to *launch* it unless
the code inside the phase ends in a copy to the host; nothing here adds
a ``synchronize``, with tracing on or off. Off, :func:`phase` returns one
shared no-op context and :func:`count` returns at once: nothing is
recorded.
"""

import collections
import contextlib
import contextvars
import functools
import itertools
import os
import threading
import time
from collections import defaultdict

from .misc import logger

TRACE = 5  # sub-DEBUG level of the phase records
#: Most span events kept between resets; later ones are counted in the
#: counter ``trace.dropped_events`` instead.
MAX_EVENTS = 1_000_000

#: One closed span: ``start_ns``/``end_ns`` from ``time.perf_counter_ns``;
#: ``thread`` the ``threading.get_ident`` of the thread that ran it,
#: ``thread_name`` its name; ``span`` its id, ``parent`` the id of the
#: span it opened under (0: none), ``request`` the id of the request
#: scope it ran in (0: none).
SpanEvent = collections.namedtuple(
    'SpanEvent', 'name start_ns end_ns thread thread_name span parent '
    'request')

_enabled = os.environ.get('MTSCOMP_TRACE', '') not in ('', '0')
_lock = threading.Lock()
_stats = defaultdict(lambda: [0, 0.0])      # name -> [count, seconds]
_counters = defaultdict(int)                # name -> total
_events = []
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
#: (request id, id of the innermost open span) of the running context.
_current = contextvars.ContextVar('mtscomp_trace', default=(0, 0))
_NOOP = contextlib.nullcontext()


def enable_tracing(on=True):
    global _enabled
    _enabled = bool(on)
    if _enabled and logger.getEffectiveLevel() > TRACE:
        # Phase durations log at the sub-DEBUG trace level; tracing is
        # an explicit opt-in, so make those records pass the logger.
        logger.setLevel(TRACE)


if _enabled and logger.getEffectiveLevel() > TRACE:
    logger.setLevel(TRACE)


def reset_stats():
    """Clear the phases, the span events and the counters."""
    with _lock:
        _stats.clear()
        _counters.clear()
        _events.clear()


def phase_stats():
    """{phase: (count, total_seconds)} accumulated since reset."""
    with _lock:
        return {k: tuple(v) for k, v in _stats.items()}


def span_events():
    """The :class:`SpanEvent` of every span closed since reset (at most
    :data:`MAX_EVENTS`), in the order they closed."""
    with _lock:
        return list(_events)


def counter_stats():
    """{counter: total} accumulated since reset."""
    with _lock:
        return dict(_counters)


def count(name, n=1):
    """Add ``n`` to counter ``name`` (no-op unless tracing is enabled)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] += n


def request_scope(fn):
    """Decorate a public entry point: each call that is not already
    inside a request runs as a new request, numbered from 1, while
    tracing is enabled."""
    @functools.wraps(fn)
    def scoped(*args, **kwargs):
        if not _enabled or _current.get()[0]:
            return fn(*args, **kwargs)
        token = _current.set((next(_request_ids), 0))
        try:
            return fn(*args, **kwargs)
        finally:
            _current.reset(token)
    return scoped


class _Span:
    """One open phase; see :func:`phase`."""

    __slots__ = ('name', 'record', 'token', 'span', 'parent', 'request',
                 't0')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from torch.profiler import record_function
        self.request, self.parent = _current.get()
        self.span = next(_span_ids)
        self.token = _current.set((self.request, self.span))
        self.t0 = time.perf_counter_ns()
        self.record = record_function(self.name)
        self.record.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.record.__exit__(*exc)
        finally:
            t1 = time.perf_counter_ns()
            _current.reset(self.token)
            dt = (t1 - self.t0) * 1e-9
            thread = threading.current_thread()
            with _lock:
                s = _stats[self.name]
                s[0] += 1
                s[1] += dt
                if len(_events) < MAX_EVENTS:
                    _events.append(SpanEvent(
                        self.name, self.t0, t1, thread.ident, thread.name,
                        self.span, self.parent, self.request))
                else:
                    _counters['trace.dropped_events'] += 1
            logger.log(TRACE, "phase %s: %.3f ms", self.name, dt * 1e3)
        return False


def phase(name):
    """Trace one phase (the shared no-op unless tracing is enabled)."""
    return _Span(name) if _enabled else _NOOP
