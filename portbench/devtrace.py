"""The device trace of a traced run, and what the per-layer metrics read
from it.

``torch.profiler`` records the measured window (host operations, the
program's ``record_function`` spans and, on a card, every kernel, copy
and fill through CUPTI), and its Chrome trace is reduced here to three
lists on one clock: device operations, host spans, and the window, which
runs from the start of the harness's first call span to the end of its
last (the host and device times of a Chrome trace share a base).
"""

import contextlib
import heapq
import json
from collections import defaultdict

from . import stats

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
#: Prefix of the spans the harness opens around each timed call.
CALL_SPAN = 'portbench.'


@contextlib.contextmanager
def profiled(path, device):
    """Profile the body; write its Chrome trace to ``path`` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(path))


class Trace:
    """Device operations and host spans of a Chrome trace, in seconds."""

    def __init__(self, events):
        self.device = []        # (start, end, name, category)
        self.spans = []         # (start, end, name)
        for ev in events:
            if ev.get('ph') != 'X' or 'dur' not in ev:
                continue
            s = float(ev['ts']) * 1e-6
            e = s + float(ev['dur']) * 1e-6
            cat = ev.get('cat', '')
            if cat in DEVICE_CATEGORIES:
                self.device.append((s, e, ev.get('name', '?'), cat))
            elif cat == 'user_annotation':
                self.spans.append((s, e, ev.get('name', '?')))
        calls = [(s, e) for s, e, n in self.spans if n.startswith(CALL_SPAN)]
        self.lo = min((s for s, _ in calls), default=0.0)
        self.hi = max((e for _, e in calls), default=0.0)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            data = json.load(f)
        return cls(data['traceEvents'] if isinstance(data, dict) else data)

    @property
    def window_s(self):
        return self.hi - self.lo

    @property
    def busy_s(self):
        """Seconds of the window in which an operation ran on the device."""
        return stats.union_length([(s, e) for s, e, _, _ in self.device],
                                  self.lo, self.hi)

    def idle_pct(self):
        """Share of the window in which no kernel, copy or fill ran, in %;
        None where the trace holds no device operation."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_s(self):
        """Seconds of kernels inside the window (summed, not merged)."""
        return sum(e - s for s, e, _, c in self._in_window() if c == 'kernel')

    def _in_window(self):
        return [(max(s, self.lo), min(e, self.hi), n, c)
                for s, e, n, c in self.device
                if min(e, self.hi) > max(s, self.lo)]

    def device_ops(self, top=10):
        """``[[name, seconds]]`` of the device operations that took most
        time in the window, summed by name."""
        by = defaultdict(float)
        for s, e, n, _ in self._in_window():
            by[n] += e - s
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """``[[host span, seconds]]``: the device's idle time in the window,
        summed by the host span opened last while it lasted; ``'(no
        span)'`` where none was open. The profiler records the spans of
        the thread that started it, so work in the program's own threads
        (the Writer's batches) shows as the span around the call."""
        if not self.device:
            return []
        idle = stats.gaps([(s, e) for s, e, _, _ in self.device],
                          self.lo, self.hi)
        points = []
        for i, (s, e, _) in enumerate(self.spans):
            points += [(s, 1, i), (e, 0, i)]
        for s, e in idle:
            points += [(s, 3, -1), (e, 2, -1)]
        points.sort()
        by = defaultdict(float)
        open_, closed, in_gap, prev = [], set(), False, None
        for t, kind, i in points:
            if in_gap and prev is not None and t > prev:
                while open_ and open_[0][2] in closed:
                    heapq.heappop(open_)
                name = self.spans[open_[0][2]][2] if open_ else '(no span)'
                by[name] += t - prev
            if kind == 1:
                # The innermost: the latest start, the earliest end on a tie.
                heapq.heappush(open_, (-self.spans[i][0], self.spans[i][1], i))
            elif kind == 0:
                closed.add(i)
            else:
                in_gap = kind == 3
            prev = t
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]
