"""Phase tracing: named spans over codec phases.

Each phase is a context manager that (a) logs its duration at the trace
level, (b) opens a ``torch.profiler.record_function`` so the work shows
up named in a ``torch.profiler`` trace (CPU or CUDA), and (c) feeds an
in-process aggregator queryable via :func:`phase_stats`. Enable with
``MTSCOMP_TRACE=1`` or :func:`enable_tracing`.

The durations are host-clock times. Kernels are launched asynchronously,
so a phase that ends on device work reads the time to *launch* it unless
the code inside the phase ends in a copy to the host; nothing here adds
a ``synchronize``, with tracing on or off.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict

from .misc import logger

TRACE = 5  # sub-DEBUG level of the phase records

_enabled = os.environ.get('MTSCOMP_TRACE', '') not in ('', '0')
_lock = threading.Lock()
_stats = defaultdict(lambda: [0, 0.0])      # name -> [count, seconds]


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
    with _lock:
        _stats.clear()


def phase_stats():
    """{phase: (count, total_seconds)} accumulated since reset."""
    with _lock:
        return {k: tuple(v) for k, v in _stats.items()}


@contextlib.contextmanager
def phase(name):
    """Trace one phase (no-op unless tracing is enabled)."""
    if not _enabled:
        yield
        return
    from torch.profiler import record_function
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats[name]
            s[0] += 1
            s[1] += dt
        logger.log(TRACE, "phase %s: %.3f ms", name, dt * 1e3)
