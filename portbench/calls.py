"""The general traffic generator: the calls a user makes on a recording,
driven from a traffic file's parameters.

A traffic file (``portbench/traffic/<name>.json``) names its ``call``
and the length of the recording (``recording_s``); a window read adds
``window_s`` and ``scroll_share``. Each call kind below does its set-up
(the recording encoded through the program), warms up the shapes its
calls use, makes one call at a time in a closed loop, keeps a sample of
the answers drawn from the seed, and judges them after the window
against the source with the plain reference (:mod:`portbench.reference`).

- ``to_array``, ``to_tensor``: a fresh ``Reader`` on the file and one
  bulk decode of all of it into host memory or onto the device;
- ``compress``: ``compress()`` of the raw file to one output path,
  removed before each call;
- ``window``: ``Reader[i0:i1]`` on one open reader, in blocks of
  requests of which ``scroll_share`` start where the last window ended
  and the rest start anywhere in the file, uniformly.

``control`` stands a lossy codec in the program's place: every decoded
sample, or every sample compressed, loses its lowest bit. It breaks the
configuration's guarantee, so its runs must come out not correct.
"""

import hashlib
import os

import numpy as np

from .reference import decode as ref_decode
from .reference import samples_wrong

#: Requests a window-read block holds; every block has the same shares.
BLOCK = 64
#: Answers of each call kind kept for the check (a sample drawn from the
#: seed over every call of the window).
KEEP = 2
WINDOWS_KEPT = 48


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``
    (Algorithm R): :meth:`slot` says where the next item goes."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen = k, rng, 0

    def slot(self):
        """The slot (0 to k-1) the next item takes, or None."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


def lossy(a):
    """``a`` with the lowest bit of every sample cleared (the control)."""
    return a & np.array(-2).astype(a.dtype)


class Kind:
    """One call kind on one recording. ``src`` is the recording,
    ``files`` the working directory, ``mt`` the program's package."""

    def __init__(self, mt, config, traffic, src, files, device, seed,
                 control):
        self.mt, self.config, self.traffic = mt, config, traffic
        self.src, self.files, self.device = src, files, device
        self.control = control
        # Apart, so that the requests do not depend on the sample drawn.
        self.requests = np.random.default_rng([seed, 1])
        self.sample = np.random.default_rng([seed, 2])
        self.raw = os.path.join(files, 'recording.bin')
        self.cbin = os.path.join(files, 'recording.cbin')
        self.ch = os.path.join(files, 'recording.ch')
        self.raw_bytes = src.nbytes
        self.written = 0

    def options(self, role):
        return dict(self.config[role], device=self.device, quiet=True)

    def compress(self, raw, cbin, ch):
        c = self.config
        self.mt.compress(raw, cbin, ch, sample_rate=c['sample_rate'],
                         n_channels=c['n_channels'], dtype=c['dtype'],
                         chunk_duration=c['chunk_duration'],
                         **self.options('writer'))
        self.written += os.path.getsize(cbin) + os.path.getsize(ch)

    def encode_source(self):
        """Write the recording and encode it through the program."""
        self.src.tofile(self.raw)
        self.written += self.raw_bytes
        self.compress(self.raw, self.cbin, self.ch)
        os.remove(self.raw)

    def ratio(self):
        return self.raw_bytes / (os.path.getsize(self.cbin)
                                 + os.path.getsize(self.ch))

    def close(self):
        pass


class BulkRead(Kind):
    """``Reader.to_array()`` or ``.to_tensor()`` of the whole file."""

    def setup(self):
        self.encode_source()
        self.coded_bytes = os.path.getsize(self.cbin)
        self.kept = Reservoir(KEEP, self.sample)
        self.outs = [None] * KEEP

    def _read(self):
        r = self.mt.decompress(self.cbin, self.ch, **self.options('reader'))
        try:
            if self.traffic['call'] == 'to_tensor':
                import torch
                out = r.to_tensor()
                if out.device.type == 'cuda':
                    torch.cuda.synchronize(out.device)
            else:
                out = r.to_array()
        finally:
            r.close()
        return out

    def warm(self):
        self._read()

    def call(self):
        out = self._read()
        slot = self.kept.slot()
        if slot is not None:
            self.outs[slot] = out
        return self.raw_bytes, self.coded_bytes

    def check(self):
        kept, self.outs = [o for o in self.outs if o is not None], []
        wrong, checked = 0, len(kept)
        while kept:
            out = kept.pop()
            if not isinstance(out, np.ndarray):
                out = out.cpu().numpy()
            wrong += samples_wrong(lossy(out) if self.control else out,
                                   self.src)
        return {'samples_wrong': {'value': wrong, 'at_most': 0},
                'calls_checked': {'value': checked, 'at_least': 1}}


class Compress(Kind):
    """``compress()`` of the raw file, over one output path."""

    def setup(self):
        (lossy(self.src) if self.control else self.src).tofile(self.raw)
        self.written += self.raw_bytes
        self.sidecars = []

    def _compress(self):
        for path in (self.cbin, self.ch):
            if os.path.exists(path):
                os.remove(path)
        self.compress(self.raw, self.cbin, self.ch)

    def warm(self):
        self._compress()

    def call(self):
        self._compress()
        with open(self.ch, 'rb') as f:
            self.sidecars.append(f.read())
        return self.raw_bytes, os.path.getsize(self.cbin)

    def check(self):
        """The last call's files decoded by the reference against the
        source; every earlier call's sidecar (which holds the SHA1 of its
        ``.cbin``) equal to the last one's."""
        meta = ref_decode.read_sidecar(self.ch)
        try:
            chunks = ref_decode.decode_file(self.cbin, self.ch)
            got = np.concatenate([chunks[i] for i in sorted(chunks)])
        except ValueError as e:
            print('portbench: the reference cannot decode the file: %s' % e)
            got = None
        wrong = samples_wrong(got, self.src)
        with open(self.cbin, 'rb') as f:
            sha1 = hashlib.sha1(f.read()).hexdigest()
        sha1_wrong = int(meta.get('sha1_compressed') != sha1) + int(
            meta.get('sha1_uncompressed')
            != hashlib.sha1(self.src.tobytes()).hexdigest())
        return {'samples_wrong': {'value': wrong, 'at_most': 0},
                'sidecar_sha1_wrong': {'value': sha1_wrong, 'at_most': 0},
                'sidecars_unlike_last': {
                    'value': sum(s != self.sidecars[-1]
                                 for s in self.sidecars),
                    'at_most': 0},
                'calls_checked': {'value': len(self.sidecars),
                                  'at_least': 1}}


class WindowRead(Kind):
    """``Reader[i0:i1]`` of windows of ``window_s`` on one open reader."""

    def setup(self):
        self.encode_source()
        n = self.src.shape[0]
        self.width = int(round(self.traffic['window_s']
                               * self.config['sample_rate']))
        self.n_starts = n - self.width + 1
        self.scrolls = int(round(self.traffic['scroll_share'] * BLOCK))
        self.next_start, self.queue = 0, []
        # The windows kept are copied into one buffer made here, so that
        # every window the program returns is freed as a viewer's would be.
        self.kept = Reservoir(WINDOWS_KEPT, self.sample)
        self.kept_starts = [None] * WINDOWS_KEPT
        self.kept_windows = np.empty(
            (WINDOWS_KEPT, self.width, self.src.shape[1]), self.src.dtype)
        self.kept_windows.fill(0)

    def warm(self):
        """A chunk-aligned and an unaligned window, on a reader of its
        own: the shapes the requests take, and a cold cache after."""
        r = self.mt.decompress(self.cbin, self.ch, **self.options('reader'))
        try:
            r[0:self.width]
            r[self.width // 2:self.width // 2 + self.width]
        finally:
            r.close()
        self.reader = self.mt.decompress(self.cbin, self.ch,
                                         **self.options('reader'))

    def _start(self):
        if not self.queue:
            self.queue = list(self.requests.permutation(
                [True] * self.scrolls + [False] * (BLOCK - self.scrolls)))
        if not self.queue.pop():
            self.next_start = int(self.requests.integers(0, self.n_starts))
        elif self.next_start >= self.n_starts:
            self.next_start = 0
        return self.next_start

    def call(self):
        i0 = self._start()
        i1 = i0 + self.width
        out = self.reader[i0:i1]
        self.next_start = i1
        slot = self.kept.slot()
        if slot is not None:
            whole = (out.shape == self.kept_windows.shape[1:]
                     and out.dtype == self.kept_windows.dtype)
            if whole:
                self.kept_windows[slot] = out
            self.kept_starts[slot] = (i0, whole)
        return self.width * self.src.shape[1] * self.src.itemsize, 0

    def check(self):
        wrong, checked = 0, 0
        for start, out in zip(self.kept_starts, self.kept_windows):
            if start is None:
                break
            i0, whole = start
            checked += 1
            wrong += samples_wrong(
                (lossy(out) if self.control else out) if whole else None,
                self.src[i0:i0 + self.width])
        return {'samples_wrong': {'value': wrong, 'at_most': 0},
                'windows_checked': {'value': checked, 'at_least': 1}}

    def close(self):
        self.reader.close()


KINDS = {'to_array': BulkRead, 'to_tensor': BulkRead, 'compress': Compress,
         'window': WindowRead}

