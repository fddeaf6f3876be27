"""Hardware storm: the ans format surface through the port's CUDA kernels
on one GPU, the port's counterpart of ``tools/tpu_storm.py``.

The CPU tests run the kernels' plain twins at small sizes; this tool
runs the JAX storm's format matrix through the hand-written kernels on
the card and holds every cell byte for byte against the source and the
host codec (the reference's analogue is its exhaustive parameter sweeps,
tests.py:499-526, run on the machine that executes the hot path).

Matrix axes (every cell decodes byte-exactly through
:class:`~.parallel.pipeline.DeviceBatchDecoder` with the word audit on;
every dtype cell also encodes on the device and requires containers
byte-identical to the host codec; the JAX storm encodes items of 2 bytes
or less):

- dtype: int8 / uint8 / int16 / uint16 / int32 / uint32 / int64 /
  uint64, bitcast float16, float32 and float64 (8-byte items through the
  int64 forms of K4 and K5; the JAX storm leaves them to its host codec)
- tables: per-plane vs clustered per-segment multitable (flags bit4)
- layout: channel-aligned segments (bit2) vs non-aligned
- table origin: self-written 8-aligned tables (K1's octet form) vs a
  foreign writer's min-8 tables (its coarse form, two fixups)
- chunk geometry: partial tail chunks; ``chunk_order='C'``; spatial
  diff; time diff off; second-order time diff; the joint ``'auto'``
  probe; the ragged-tail split (bit6); adaptive windows (bit5)
- K6's word region: a stream at the densest rate this writer codes fits
  the region of :func:`~.ops.rans_encode.symbol_capacity`, and a region
  too small for it raises (the JAX storm's overflow fallback has no
  counterpart in the port)
- corruption surfacing on the device path
- random cells (``--random N``): dtype, channels (3-511), chunk length
  (400-5999 samples), table mode, layout, order and diffs

Every cell records the launches of each kernel form
(:func:`~mtscomp_tpu_torch.launch_counts`) and the chunks the pipeline
left to the host codec. On the card a decode batch with rANS groups that
does not launch K1 exactly once fails, as does a device encode of a rANS
plane that launches no K6, and a cell of 8-byte items that leaves a chunk
to the host codec, launches a scan narrower than 64 bits, or (on the
card) none of 64 bits.

Usage, from the repository root::

    python -m mtscomp_tpu_torch.storm [--quick] [--random N] [--seed S]
        [--cells SUBSTR] [--device cuda|cpu] [--out BASE]

``--device cuda`` (the default) needs a GPU and exits with code 2
without one; ``cpu`` runs the plain twins. ``--out BASE`` writes
``BASE.json`` and ``BASE.md``; without it no file is written. The exit
code is 0 when every cell passed and 1 when one failed.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import config, launch_counts, native
from .api import Writer, compress, decompress
from .codec import ans as ans_mod
from .codec.ans import MODE_RANS, seg_freqs
from .device import resolve_device
from .models import rans
from .ops import _build
from .ops.rans_encode import encode_groups, symbol_capacity
from .ops.tables import pack_device_tables
from .parallel.pipeline import (DeviceBatchDecoder, DeviceBatchEncoder,
                                DeviceChunkCache, _read_payload,
                                check_words_used, decompress_to_array)

#: The counters of :func:`~mtscomp_tpu_torch.launch_counts` that count
#: chunks sent to the host codec, not kernel launches.
HOST_COUNTERS = ('host_fallback_chunks', 'host_encoded_chunks')
#: Prefixes of the scan forms' launch counters (K2-K5): a scan narrower
#: than 64 bits on an 8-byte file would lose the upper half.
SCAN_FORMS = ('finalize_u8', 'scan_', 'cumsum_time')


def make_data(kind, dtype, ns, nc, seed=0):
    """Random-walk test signal wrapped into the dtype's range.

    'gradient' scales the walk per channel (k+1 amplitude bands) so
    per-channel histograms differ — the geometry segment-table
    clustering exists for.
    """
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == 'f':
        # Smooth float walk (realistic smooth-signal bit patterns for
        # the bitcast transform) plus sign flips via mean removal.
        walk = np.cumsum(rng.normal(0.0, 1.0, size=(ns, nc)), axis=0)
        if kind == 'gradient':
            walk *= (0.25 + 4.0 * (np.arange(nc) / max(nc - 1, 1)))[None]
        walk -= walk.mean(axis=0, keepdims=True)
        return (walk * 0.03).astype(dtype)
    std = {1: 2.0, 2: 6.0, 4: 6.0}[dtype.itemsize]
    walk = np.cumsum(rng.normal(0.0, std, size=(ns, nc)), axis=0)
    if kind == 'gradient':
        walk = walk * (0.25 + 4.0 * (np.arange(nc) / max(nc - 1, 1)))[None]
    elif kind == 'common':
        # Strong shared artifact on top of the independent walks: the
        # joint transform auto-probe must engage the spatial diff.
        walk = walk + np.cumsum(
            rng.normal(0.0, 3 * std, size=(ns, 1)), axis=0)
    info = np.iinfo(dtype)
    span = int(info.max) - int(info.min) + 1
    wrapped = np.mod(np.round(walk).astype(np.int64) - int(info.min), span)
    return (wrapped + int(info.min)).astype(dtype)


def quantize_foreign(counts, scale_bits=None, min_freq=None):
    """A *foreign* writer's quantizer: min-8 frequencies at UNIT
    granularity, so cumulative table boundaries are generally not
    multiples of 8 and 16-slot buckets can hold three symbols — decode
    must take the two-fixup path. Valid per the format contract
    (FORMAT.md: decoders accept arbitrary min-8 tables)."""
    scale_bits = rans.SCALE_BITS if scale_bits is None else scale_bits
    min_freq = rans.MIN_FREQ if min_freq is None else min_freq
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    present = counts > 0
    if int(present.sum()) <= 1:
        return None
    scale = 1 << scale_bits
    ideal = counts * scale / total
    freqs = np.floor(ideal).astype(np.int64)
    freqs[present] = np.maximum(freqs[present], min_freq)
    rem = int(scale - freqs.sum())
    if rem > 0:
        frac = np.where(present, ideal - np.floor(ideal), -1.0)
        order = np.argsort(-frac, kind='stable')
        bump = order[:rem]
        freqs[bump] += 1
    while freqs.sum() > scale:
        k = int(np.argmax(freqs))
        if freqs[k] <= min_freq:
            raise ValueError("cannot rebalance foreign table")
        freqs[k] -= 1
    if freqs.sum() != scale:
        raise ValueError("foreign table sums to %d, not %d"
                         % (freqs.sum(), scale))
    return freqs


class _patched:
    """Temporarily replace module attributes ({(mod, name): value})."""

    def __init__(self, repl):
        self.repl = repl
        self.saved = {}

    def __enter__(self):
        for (mod, name), val in self.repl.items():
            self.saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, val)

    def __exit__(self, *exc):
        for (mod, name), val in self.saved.items():
            setattr(mod, name, val)


def _k1_launches():
    return sum(v for k, v in launch_counts().items()
               if k.startswith('rans_decode'))


def _rans_coded(codec, payloads):
    """Whether any of the containers codes a plane with rANS."""
    return any(MODE_RANS in codec.parse(p)['modes'] for p in payloads)


def table_fixups(reader):
    """(n_tables, n_two_fixup) over every rANS table in the file."""
    n_tables = n_two = 0
    seen = set()
    for i in range(reader.n_chunks):
        parsed = reader.codec.parse(_read_payload(reader, i))
        for g in parsed['groups']:
            for (p, start, _n) in g['segments']:
                t = seg_freqs(parsed, p, start)
                key = t.tobytes()
                if key in seen:
                    continue
                seen.add(key)
                n_tables += 1
                if pack_device_tables(t)[2]:
                    n_two += 1
    return n_tables, n_two


def device_decode_all(reader, arr, device):
    """Decode every chunk through :class:`DeviceBatchDecoder` on
    ``device``, asserting the device path accepted each batch (no silent
    host fallback), the stream-word audit passed, and the bytes match
    ``arr`` (in the coding dtype). On the card, every batch with rANS
    groups must launch K1 exactly once.

    Chunks are grouped by their full container signature (size, plane
    modes, segment geometry, transform descriptor, bit6 sub-rows):
    data-dependent mode differences between chunks are legal and batch
    separately, as the production pipeline's batching does.
    """
    groups = []
    for idx in range(reader.n_chunks):
        ns = reader.chunk_bounds[idx + 1] - reader.chunk_bounds[idx]
        parsed = reader.codec.parse(_read_payload(reader, idx))
        sig = (ns, tuple(parsed['modes']), parsed['seg'],
               parsed['aligned'], parsed['zigzag'], parsed['n_stream'],
               parsed['n_head'], parsed.get('transform'),
               parsed.get('tail_split', 1))
        if groups and groups[-1][1] == sig:
            groups[-1][0].append(parsed)
        else:
            groups.append(([parsed], sig))
    parts = []
    for parsed_list, sig in groups:
        ns = sig[0]
        dec = DeviceBatchDecoder(reader, device)
        if not dec.supported(parsed_list, ns):
            raise AssertionError("device path declined a uniform batch "
                                 "(sig=%r)" % (sig,))
        k1 = _k1_launches()
        out = dec.decode_batch(parsed_list, ns)
        if device.type == 'cuda':
            want = int(any(p['groups'] for p in parsed_list))
            got = _k1_launches() - k1
            if got != want:
                raise AssertionError("a decode batch of %d chunks launched "
                                     "K1 %d times, expected %d"
                                     % (len(parsed_list), got, want))
        parts.extend(out[i] for i in range(len(parsed_list)))
    got = np.concatenate(parts, axis=0)
    if not np.array_equal(got, arr):
        bad = int(np.argmax((got != arr).any(axis=1)))
        raise AssertionError("decode mismatch from sample %d" % bad)


def device_encode(w, chunks, device):
    """Encode ``chunks`` through a :class:`DeviceBatchEncoder` of writer
    ``w`` on ``device``; returns ``(payloads, encoder)``.

    Every mode row of a batch encodes on the device, however few chunks
    hold it (the JAX storm pins its host rule for short sub-batches to
    1 for the same effect). So no chunk may reach the host codec, every
    container must equal the host codec's bytes, and on the card a batch
    that codes a rANS plane must launch K6.
    """
    enc = DeviceBatchEncoder(w, device=device)
    before = launch_counts()
    payloads = enc.encode_batch(chunks)
    after = launch_counts()
    if after['host_encoded_chunks'] != before['host_encoded_chunks']:
        raise AssertionError("%d chunks of the device encode went to the "
                             "host codec" % (after['host_encoded_chunks']
                                             - before['host_encoded_chunks']))
    for b, payload in enumerate(payloads):
        host = w.codec.encode(w._transform_chunk(chunks[b]),
                              order=w.chunk_order)
        if payload != host:
            raise AssertionError("device container %d != host codec bytes"
                                 % b)
    if (device.type == 'cuda' and _rans_coded(w.codec, payloads)
            and after['rans_encode'] == before['rans_encode']):
        raise AssertionError("the device encode of a rANS plane never "
                             "launched K6")
    return payloads, enc


def _encode_label(w, payloads, device):
    if not _rans_coded(w.codec, payloads):
        return 'no rANS plane'
    return 'K6' if device.type == 'cuda' else 'twin'


def _writer_kwargs(compress_kwargs):
    """The Writer settings of a compress call that the encode depends on."""
    return {k: v for k, v in compress_kwargs.items()
            if k.startswith('ans_') or k in
            ('chunk_order', 'do_time_diff', 'do_spatial_diff',
             'chunk_duration', 'time_diff_order')}


def device_encode_check(raw, arr, sr, nc, compress_kwargs, device):
    """Device-encode the file's leading equal-size chunks; the containers
    must be byte-identical to the host codec (:func:`device_encode`).
    Returns ``(label, encoder)``: ``'K6'`` on the card, ``'twin'`` on the
    CPU, ``'no rANS plane'`` where no container codes one."""
    w = Writer(algorithm='ans', quiet=True, device=str(device),
               **_writer_kwargs(compress_kwargs))
    try:
        w.open(raw, sample_rate=sr, n_channels=nc, dtype=arr.dtype.name)
        csize = w.chunk_bounds[1] - w.chunk_bounds[0]
        B = 0
        while (B < w.n_chunks
               and w.chunk_bounds[B + 1] - w.chunk_bounds[B] == csize):
            B += 1
        chunks = np.stack([np.asarray(w.get_chunk(i)) for i in range(B)])
        if not DeviceBatchEncoder(w, device=device).supported(csize):
            raise AssertionError("device encode declined the geometry")
        payloads, enc = device_encode(w, chunks, device)
        return _encode_label(w, payloads, device), enc
    finally:
        w.close()


def _card_line():
    """The card's name and power limit (``nvidia-smi``), or what is
    known without it."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return '%s (power limit not read)' % torch.cuda.get_device_name(0)


class Storm:
    """One storm run: the cells, their results, and where they run.

    ``device`` is a resolved ``torch.device`` (``cuda`` for the kernels,
    ``cpu`` for the twins); ``tmp`` the directory the cells write their
    files in; ``cell_filter`` runs only cells whose name contains it.
    """

    def __init__(self, device, tmp, quick=False, cell_filter=None):
        self.device = device
        self.tmp = Path(tmp)
        self.quick = quick
        self.cell_filter = cell_filter
        self.results = []
        # Geometry: C=385 (the Neuropixels non-128-multiple), 2 full
        # chunks of SR samples and a partial tail.
        self.SR = 2000.0 if quick else 4000.0
        self.C = 385
        self.csize = int(self.SR)
        self.NS = 2 * self.csize + self.csize // 2

    @property
    def on_card(self):
        return self.device.type == 'cuda'

    def subdir(self, name):
        sub = self.tmp / name
        sub.mkdir()
        return sub

    def cbase(self, **kw):
        """compress() settings of a cell: the host codec writes the file
        (the normative coder), and cells pin their table mode explicitly
        (the library default is 'segment'): the dtype sweep runs plane
        containers, the segment_tables_* cells the bit4 multitable
        ones."""
        d = dict(algorithm='ans', quiet=True, check_after_compress=False,
                 ans_table_mode='plane', device='none')
        d.update(kw)
        return d

    def open(self, sub):
        return decompress(sub / 'x.cbin', sub / 'x.ch', quiet=True,
                          device=str(self.device))

    def run_cell(self, name, note, fn):
        if self.cell_filter and self.cell_filter not in name:
            return
        t0 = time.perf_counter()
        before = launch_counts()
        try:
            extra = fn() or {}
            ok, error = True, None
        except Exception as e:
            traceback.print_exc()
            extra, ok = {}, False
            error = "%s: %s" % (type(e).__name__, e)
        secs = time.perf_counter() - t0
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        launches = {k: v for k, v in delta.items() if k not in HOST_COUNTERS}
        host = {k: v for k, v in delta.items() if k in HOST_COUNTERS}
        result = dict(cell=name, ok=ok, note=note, secs=round(secs, 3),
                      launches=launches, host=host, **extra)
        if error is not None:
            result['error'] = error
        self.results.append(result)
        if ok:
            print("PASS %-34s %7.2fs  %s  %s" % (name, secs, launches,
                                                 extra or ''), flush=True)
        else:
            print("FAIL %-34s %s" % (name, error), flush=True)

    # --- cells --------------------------------------------------------

    def cell_roundtrip(self, dtype, kind='walk', expect_fixups=None,
                       window=False, encode=True, seed=0, expect_meta=None,
                       quantizer=None, **kw):
        SR, C, NS, csize = self.SR, self.C, self.NS, self.csize

        def fn():
            dt = np.dtype(dtype)
            arr = make_data(kind, dt, NS, C, seed=seed)
            # Bitcast float files decode (on device) in their integer
            # coding dtype; compare in that domain (bit equality).
            code = (arr.view('int%d' % (dt.itemsize * 8))
                    if dt.kind == 'f' else arr)
            sub = self.subdir("cell_%d" % len(self.results))
            raw = sub / 'x.bin'
            arr.tofile(raw)
            patches = {}
            if quantizer:
                # Patch EVERY quantizer seam the encode paths use: the
                # scalar normative entry AND the batched path the host
                # codec's decide_plane routes through (the JAX storm
                # found a native row-batched quantizer making the scalar
                # patch silently dead: two_fixup == 0).
                def quant_rows(sums, _q=quantizer):
                    return np.stack(
                        [_q(row) for row in np.asarray(sums)]
                    ).astype(np.uint16)

                patches[(rans, 'quantize_freqs')] = quantizer
                patches[(ans_mod, '_quantize_rows')] = quant_rows
            with _patched(patches):
                compress(raw, sub / 'x.cbin', sub / 'x.ch', sample_rate=SR,
                         n_channels=C, dtype=dt.name, **self.cbase(**kw))
            r = self.open(sub)
            try:
                extra = {}
                for mk, mv in (expect_meta or {}).items():
                    got = r.cmeta.get(mk)
                    if got != mv:
                        raise AssertionError("sidecar %s=%r, expected %r"
                                             % (mk, got, mv))
                n_tables, n_two = table_fixups(r)
                extra['tables'] = n_tables
                extra['two_fixup'] = n_two
                if expect_fixups == 'two' and n_two == 0:
                    raise AssertionError("expected >=1 two-fixup table")
                if expect_fixups == 'one' and n_two:
                    raise AssertionError("self-written tables must be "
                                         "single-fixup (%d/%d)"
                                         % (n_two, n_tables))
                device_decode_all(r, code, self.device)
                if window:
                    cache = DeviceChunkCache(r)
                    for (a, b) in [(7, csize // 2), (csize - 3, csize + 9),
                                   (NS - csize // 3, NS)]:
                        got = cache.read_window(a, b)
                        if got is None or got.dtype != dt \
                                or not np.array_equal(got.view(code.dtype),
                                                      code[a:b]):
                            raise AssertionError("device window [%d:%d) "
                                                 "mismatch" % (a, b))
                    extra['windows'] = 'ok'
                if encode:
                    with _patched(patches):
                        # Full merged config (incl. cbase's pinned
                        # table mode), matching what compress() used.
                        extra['encode'] = device_encode_check(
                            raw, arr, SR, C, self.cbase(**kw),
                            self.device)[0]
            finally:
                r.close()
            return extra
        return fn

    def cell_wide_dtype(self, dtype):
        """8-byte dtypes on the card's route, which the JAX package
        declines (JAX without x64 truncates a uint64 plane accumulator):
        every batch decodes on the device byte-exactly
        (:func:`device_decode_all`; K1 and the int64 forms of K4/K5 on
        the card), the device chunk cache serves windows, every entry
        that names the device returns the source's bytes with no chunk
        on the host codec, and the device encode (8 byte planes, K6)
        writes the host codec's containers. A cell that launches a scan
        form narrower than 64 bits fails: a lost upper half would hide
        there. Values exceed 2**32 (the float64 file holds NaN and -inf),
        so that a lost upper plane cannot hide either."""
        SR, C, NS, csize = self.SR, self.C, self.NS, self.csize

        def fn():
            before = launch_counts()
            rng = np.random.default_rng(13)
            walk = np.cumsum(rng.integers(-2000, 2000, size=(NS, C),
                                          dtype=np.int64), axis=0) \
                + (np.int64(3) << 40)
            if dtype == 'int64':
                arr = walk
            elif dtype == 'uint64':
                arr = walk.astype(np.uint64) + (np.uint64(1) << np.uint64(63))
            else:
                arr = walk.astype(np.float64) * 1.5
                arr[0, 0] = np.nan
                arr[0, 1] = -np.inf
            code = arr.view(np.int64) if dtype == 'float64' else arr
            sub = self.subdir("wide_%s" % dtype)
            raw = sub / 'x.bin'
            arr.tofile(raw)
            compress(raw, sub / 'x.cbin', sub / 'x.ch', sample_rate=SR,
                     n_channels=C, dtype=dtype, **self.cbase())
            r = self.open(sub)
            try:
                device_decode_all(r, code, self.device)
                cache = DeviceChunkCache(r)
                spans = [(7, csize // 2), (csize - 3, csize + 9),
                         (NS - csize // 3, NS)]
                for (a, b) in spans:
                    got = cache.read_window(a, b)
                    if got is None or got.tobytes() != arr[a:b].tobytes():
                        raise AssertionError("device window [%d:%d) "
                                             "mismatch" % (a, b))
                got = decompress_to_array(r, device=self.device)
                if got.dtype != arr.dtype or got.tobytes() != arr.tobytes():
                    raise AssertionError("device bulk decode mismatch")
                for (a, b) in spans:
                    win = r[a:b]                 # the reader names the device
                    if win.dtype != arr.dtype \
                            or win.tobytes() != arr[a:b].tobytes():
                        raise AssertionError("window [%d:%d) mismatch"
                                             % (a, b))
                encode = device_encode_check(raw, arr, SR, C, self.cbase(),
                                             self.device)[0]
            finally:
                r.close()
            after = launch_counts()
            moved = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            host = {k: v for k, v in moved.items() if k in HOST_COUNTERS}
            if host:
                raise AssertionError("a file of 8-byte items left chunks "
                                     "to the host codec: %s" % host)
            narrow = {k: v for k, v in moved.items()
                      if k.startswith(SCAN_FORMS) and '_i64' not in k}
            if narrow:
                raise AssertionError("a file of 8-byte items launched %s"
                                     % narrow)
            if self.on_card and not any('_i64' in k for k in moved):
                raise AssertionError("a file of 8-byte items decoded on "
                                     "the card without an int64 scan")
            return {'encode': encode}
        return fn

    def cell_ragged_tail(self):
        """ans_seg_log2 14 (13 quick) -> 4-channel segments, 97 per
        plane; the bit6 writer splits the ragged tail into 8 sub-rows ->
        groups [32,32,32,8]: the packer must engage the [fulls | tails]
        layout (``DeviceBatchDecoder.last_tail``) and the finalize's
        tail form (K3) must be byte-exact on the device."""
        SR, C, NS = self.SR, self.C, self.NS
        arr = make_data('walk', np.dtype(np.int16), NS, C, seed=5)
        sub = self.subdir("cell_%d" % len(self.results))
        raw = sub / 'x.bin'
        arr.tofile(raw)
        compress(raw, sub / 'x.cbin', sub / 'x.ch', sample_rate=SR,
                 n_channels=C, dtype='int16',
                 **self.cbase(ans_seg_log2=13 if self.quick else 14))
        r = self.open(sub)
        try:
            parsed = [r.codec.parse(_read_payload(r, i))
                      for i in range(2)]          # the two full chunks
            rows = [len(g['segments']) for g in parsed[0]['groups']]
            if rows != [32, 32, 32, 8]:
                raise AssertionError("groups of %s rows, expected "
                                     "[32, 32, 32, 8]" % rows)
            ns = r.chunk_bounds[1]
            dec = DeviceBatchDecoder(r, self.device)
            if not dec.supported(parsed, ns):
                raise AssertionError("device path declined the split")
            fn, dev_args = dec.pack(parsed, ns)
            if dec.last_tail is None:
                raise AssertionError("tail split not engaged")
            out, used = fn(*dev_args)
            check_words_used(parsed, used)
            got = out.cpu().numpy().reshape(2 * ns, C)
            if not np.array_equal(got, arr[:2 * ns]):
                raise AssertionError("split mismatch")
            device_decode_all(r, arr, self.device)  # and the partial tail
            # Device window reads over the split layout (the chunk cache
            # packs B=1 batches through the same tail path).
            cache = DeviceChunkCache(r)
            for (a, b) in [(3, ns // 2), (ns - 5, ns + 7)]:
                w = cache.read_window(a, b)
                if w is None or not np.array_equal(w, arr[a:b]):
                    raise AssertionError("bit6 device window [%d:%d) "
                                         "mismatch" % (a, b))
            rem, ctb, rows_n = dec.last_tail
            return {'tail': [rem, ctb, list(rows_n)], 'windows': 'ok'}
        finally:
            r.close()

    def cell_transform_adapt(self):
        """Per-chunk transform adaptation (flags bit5): 10 short chunks,
        a noise half and an LFP-like half. The device compress (batches
        of 8 chunks: window 0's run on the device, the 2-chunk window
        run on the host codec) must write the all-host compress's bytes;
        every chunk then decodes on the device per uniform window."""
        SR, C, NS = self.SR, self.C, self.NS
        half = NS // 2
        rng = np.random.default_rng(21)
        t = np.arange(half)
        noise = np.cumsum(rng.normal(0, 8, size=(half, C)), axis=0)
        lfp = (800 * np.sin(2 * np.pi * 4 * t / SR)[:, None]
               + np.cumsum(rng.normal(0, .6, size=(NS - half, C)), axis=0))
        arr = np.concatenate([noise, lfp]).astype(np.int16)
        sub = self.subdir("cell_%d" % len(self.results))
        raw = sub / 'x.bin'
        arr.tofile(raw)
        cd = (NS // 10) / SR
        compress(raw, sub / 'x.cbin', sub / 'x.ch', sample_rate=SR,
                 n_channels=C, dtype='int16',
                 **self.cbase(transform_adapt=8, chunk_duration=cd))
        k6 = launch_counts()['rans_encode']
        compress(raw, sub / 'd.cbin', sub / 'd.ch', sample_rate=SR,
                 n_channels=C, dtype='int16',
                 **self.cbase(transform_adapt=8, chunk_duration=cd,
                              device=str(self.device), n_threads=8))
        if self.on_card and launch_counts()['rans_encode'] == k6:
            raise AssertionError("the device compress never launched K6")
        if (sub / 'd.cbin').read_bytes() != (sub / 'x.cbin').read_bytes():
            raise AssertionError("adaptive device encode diverged from host "
                                 "bytes")
        r = self.open(sub)
        try:
            descs = [r.codec.parse(_read_payload(r, i))['transform']
                     for i in range(r.n_chunks)]
            if any(d is None for d in descs):
                raise AssertionError("a chunk lacks its bit5 descriptor")
            device_decode_all(r, arr, self.device)
            return {'descs': [list(d) for d in descs],
                    'device_encode': 'byte-identical'}
        finally:
            r.close()

    def cell_region_bound(self):
        """K6's word region (the port has no overflow fallback). The
        coded low bytes are uniform over 192 values (7.6 bits a symbol
        with the quantized table: near the densest stream this writer
        still codes with rANS; uniform bytes, and at the quick geometry
        bytes over 224 values, are stored RAW), the high bytes uniform
        (RAW). The
        device encode must equal the host codec with every group's words
        within :func:`symbol_capacity` of its counts; K6 called with a
        region one word short of the longest stream must raise
        RuntimeError, and the same call with the full region then still
        gives the first call's states and streams (a write outside the
        region would surface on the card as an illegal address)."""
        SR, C, NS = self.SR, self.C, self.NS
        rng = np.random.default_rng(5)
        z = (rng.integers(0, 192, size=(NS, C))
             + 256 * rng.integers(0, 256, size=(NS, C))).astype(np.uint16)
        arr = np.cumsum(rans.zigzag_decode(z, np.int16), axis=0,
                        dtype=np.int16)
        sub = self.subdir('region')
        raw = sub / 'x.bin'
        arr.tofile(raw)
        kw = self.cbase(time_diff_order=1, do_spatial_diff=False)
        compress(raw, sub / 'x.cbin', sub / 'x.ch', sample_rate=SR,
                 n_channels=C, dtype='int16', **kw)
        r = self.open(sub)
        try:
            modes = r.codec.parse(_read_payload(r, 0))['modes']
            device_decode_all(r, arr, self.device)
        finally:
            r.close()
        if modes[0] != MODE_RANS:
            raise AssertionError("the low plane is not rANS-coded (modes "
                                 "%s)" % (modes,))
        label, enc = device_encode_check(raw, arr, SR, C, kw, self.device)
        symbols, pk, rcp, counts, cap = enc.last_kernel_args
        need = symbol_capacity(counts.cpu().numpy())
        if cap != need:
            raise AssertionError("K6's region is %d words, symbol_capacity "
                                 "%d" % (cap, need))
        states, words, n_words = encode_groups(symbols, pk, rcp, counts, cap)
        nw = n_words.cpu().numpy()
        n_max = int(nw.max())
        if n_max > cap:
            raise AssertionError("a stream of %d words in a %d-word region"
                                 % (n_max, cap))
        try:
            encode_groups(symbols, pk, rcp, counts, n_max - 1)
        except RuntimeError as e:
            short = 'RuntimeError'
            if 'region' not in str(e):
                raise
        else:
            raise AssertionError("a region one word short of the stream "
                                 "returned")
        states2, words2, n_words2 = encode_groups(symbols, pk, rcp, counts,
                                                  cap)
        if not (torch.equal(states2, states) and torch.equal(n_words2,
                                                             n_words)):
            raise AssertionError("K6 after the short region gave other "
                                 "states or counts")
        for g, k in enumerate(nw.tolist()):
            if k and not torch.equal(words2[g, cap - k:], words[g, cap - k:]):
                raise AssertionError("K6 after the short region gave "
                                     "another stream for group %d" % g)
        live = int(counts.sum())
        return {'encode': label, 'cap': cap, 'max_words': n_max,
                'words_per_symbol': round(int(nw.sum()) / max(live, 1), 4),
                'short_region': short}

    def cell_corruption(self):
        """A byte flipped mid-.cbin must surface as IOError on the device
        path."""
        SR, C, NS = self.SR, self.C, self.NS
        arr = make_data('walk', np.dtype(np.int16), NS, C, seed=7)
        sub = self.subdir('corr')
        raw = sub / 'x.bin'
        arr.tofile(raw)
        compress(raw, sub / 'x.cbin', sub / 'x.ch', sample_rate=SR,
                 n_channels=C, dtype='int16', **self.cbase())
        data = bytearray((sub / 'x.cbin').read_bytes())
        data[len(data) // 2] ^= 0x40
        (sub / 'x.cbin').write_bytes(bytes(data))
        r = self.open(sub)
        try:
            try:
                device_decode_all(r, arr, self.device)
            except IOError as e:
                return {'detected': type(e).__name__}
            raise AssertionError("corrupted payload decoded silently")
        finally:
            r.close()

    def cell_random(self, i, seed):
        """Random geometry, dtype, table mode, layout, order and diffs;
        the same draws as the JAX storm's random cells of the same seed."""
        def fn():
            rng = np.random.default_rng(seed * 1000 + i)
            dt = np.dtype(str(rng.choice(
                ['int8', 'uint8', 'int16', 'uint16', 'int32', 'uint32',
                 'float16', 'float32'])))
            nc = int(rng.integers(3, 512))
            csz = int(rng.integers(400, 6000))
            ns = int(csz * rng.uniform(1.1, 3.4))
            kw = dict(
                ans_table_mode=str(rng.choice(['plane', 'segment'])),
                ans_channel_segments=bool(rng.integers(0, 2)),
                ans_seg_log2=int(rng.integers(10, 18)),
                chunk_order=str(rng.choice(['F', 'F', 'F', 'C'])),
                do_spatial_diff=bool(rng.integers(0, 4) == 0),
                do_time_diff=bool(rng.integers(0, 8) != 0),
                time_diff_order=int(rng.choice([1, 1, 2])),
            )
            kind = str(rng.choice(['walk', 'gradient']))
            arr = make_data(kind, dt, ns, nc, seed=int(rng.integers(1e6)))
            sub = self.subdir('rand_%d' % i)
            raw = sub / 'x.bin'
            arr.tofile(raw)
            compress(raw, sub / 'x.cbin', sub / 'x.ch',
                     sample_rate=float(csz), n_channels=nc, dtype=dt.name,
                     **self.cbase(**kw))
            code = (arr.view('int%d' % (dt.itemsize * 8))
                    if dt.kind == 'f' else arr)
            r = self.open(sub)
            try:
                device_decode_all(r, code, self.device)
            finally:
                r.close()
            extra = dict(dtype=dt.name, nc=nc, csize=csz, ns=ns,
                         mode=kw['ans_table_mode'],
                         aligned=kw['ans_channel_segments'],
                         order=kw['chunk_order'])
            w = Writer(algorithm='ans', quiet=True, device=str(self.device),
                       **_writer_kwargs(self.cbase(**kw)))
            try:
                w.open(raw, sample_rate=float(csz), n_channels=nc,
                       dtype=dt.name)
                chunk = np.stack([np.asarray(w.get_chunk(0))])
                payloads, _enc = device_encode(w, chunk, self.device)
                extra['encode'] = _encode_label(w, payloads, self.device)
            finally:
                w.close()
            return extra
        return fn

    # --- the matrix ---------------------------------------------------

    def run_grid(self):
        """Every cell of the JAX storm's fixed grid, by name, with
        ``encode_region_bound`` in place of ``encode_overflow_fallback``."""
        run, rt = self.run_cell, self.cell_roundtrip
        # dtype sweep: aligned layout, per-plane self-written tables.
        for dtype in ('int8', 'uint8', 'int16', 'uint16', 'int32', 'uint32'):
            run('dtype_%s' % dtype, 'aligned, plane tables, partial tail',
                rt(dtype, expect_fixups='one', window=(dtype == 'int16')))
        # Bitcast floats: float16 codes through the 2-byte path, float32
        # through the 4-byte decode; both encode on the device.
        run('dtype_float16', 'bitcast float via the i16 kernels + device '
            'encode', rt('float16', expect_fixups='one'))
        run('dtype_float32', 'bitcast float via the int32 decode + windows',
            rt('float32', expect_fixups='one', window=True))
        for dtype in ('int64', 'uint64', 'float64'):
            run('wide_dtype_%s' % dtype, 'int64 forms of K4/K5 + device '
                'encode; every entry that names the device on the card',
                self.cell_wide_dtype(dtype))
        run('segment_tables_int16', 'bit4 multitable on gradient data',
            rt('int16', kind='gradient', ans_table_mode='segment',
               expect_fixups='one'))
        run('segment_tables_uint16', 'bit4 multitable, uint16 bitcast ride',
            rt('uint16', kind='gradient', ans_table_mode='segment'))
        run('nonaligned_int16', 'channel segments off',
            rt('int16', ans_channel_segments=False))
        run('foreign_two_fixup_int16', 'unit-granularity min-8 tables from a '
            'foreign writer', rt('int16', expect_fixups='two',
                                 quantizer=quantize_foreign))
        run('foreign_two_fixup_int32', 'foreign tables on the 4-byte decode',
            rt('int32', expect_fixups='two', quantizer=quantize_foreign))
        run('order_C_int16', "chunk_order='C'", rt('int16', chunk_order='C'))
        run('spatial_diff_int16', 'time+spatial diff',
            rt('int16', do_spatial_diff=True))
        run('no_time_diff_int16', 'raw rows (no delta)',
            rt('int16', do_time_diff=False))
        # Second-order time prediction, forced (no auto probe).
        run('order2_int16', 'time_diff_order=2: device decode + windows + '
            'encode', rt('int16', time_diff_order=2, window=True))
        run('order2_int32', 'time_diff_order=2 on the 4-byte decode',
            rt('int32', time_diff_order=2))
        run('spatial_order2_int16', 'order-2 x spatial combined: device '
            'decode/windows/encode', rt('int16', time_diff_order=2,
                                        do_spatial_diff=True, window=True))
        # Joint auto probe on common-mode data: 'auto' must engage the
        # spatial diff and the file must ride the device paths.
        run('spatial_auto_common_int16', 'joint auto probe engages spatial '
            'on common-mode data',
            rt('int16', kind='common', do_spatial_diff='auto',
               time_diff_order='auto',
               expect_meta={'do_spatial_diff': True}))
        run('ragged_tail_split', 'groups [32,32,32,8]: [fulls|tails] packing '
            '+ the finalize tail form byte-exact', self.cell_ragged_tail)
        run('transform_adapt_int16', 'adaptive bit5 chunks: device compress '
            '= host bytes, decode per uniform window',
            self.cell_transform_adapt)
        run('encode_region_bound', "dense streams fit K6's region; a short "
            'region raises', self.cell_region_bound)
        run('corruption_detected', 'flipped byte mid-.cbin must surface',
            self.cell_corruption)

    def run_random(self, n, seed):
        for i in range(n):
            self.run_cell('random_%02d' % i, 'randomized geometry/mode',
                          self.cell_random(i, seed))


def write_report(base, summary, results):
    """``base``.json (summary and cells) and ``base``.md (a table)."""
    base = Path(base)
    base.parent.mkdir(parents=True, exist_ok=True)
    base.with_name(base.name + '.json').write_text(
        json.dumps(dict(summary=summary, cells=results), indent=1))
    s = summary
    lines = [
        "# GPU hardware storm — the ans format surface through the port's "
        "kernels",
        "",
        "Command: `python -m mtscomp_tpu_torch.storm%s` (the port's "
        "counterpart of `tools/tpu_storm.py`)." % s['argv'],
        "Device: **%s**; card: %s; torch %s, CUDA %s."
        % (s['device'], s['card'], s['torch'], s['cuda']),
        "%d/%d cells passed in %.1f s (after %.1f s building the kernels "
        "and the host codec's library); launches over the storm by kernel "
        "form: %s; chunks left to the host codec: %s."
        % (s['passed'], s['cells'], s['seconds'], s['setup_seconds'],
           json.dumps(s['launches']), json.dumps(s['host'])),
        "",
        "Every cell: the host codec compresses (the normative coder), the "
        "device batch decode runs on %s and is compared byte for byte with "
        "the source, with the stream-word audit on. Cells with items of 2 "
        "bytes or less also encode on the device and require containers "
        "byte-identical to the host codec." % s['device'],
        "",
        "| cell | ok | s | launches | detail | notes |",
        "|---|---|---|---|---|---|",
    ]
    for r in results:
        detail = {k: v for k, v in r.items()
                  if k not in ('cell', 'ok', 'note', 'secs', 'error',
                               'launches') and v != {}}
        lines.append("| %s | %s | %.2f | %s | %s | %s |" % (
            r['cell'], 'PASS' if r['ok'] else '**FAIL**', r['secs'],
            ', '.join('%s=%d' % kv for kv in r['launches'].items()) or '—',
            ', '.join('%s=%s' % kv for kv in detail.items()) or '—',
            r.get('error', r['note']).replace('|', '/')))
    lines.append("")
    base.with_name(base.name + '.md').write_text('\n'.join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m mtscomp_tpu_torch.storm',
        description="The ans format matrix through the port's kernels.")
    ap.add_argument('--quick', action='store_true',
                    help='smaller geometry (still every cell)')
    ap.add_argument('--out', default=None, metavar='BASE',
                    help='write BASE.json and BASE.md')
    ap.add_argument('--random', type=int, default=0, metavar='N',
                    help='append N randomized cells (geometry, dtype, '
                         'mode, order, diffs)')
    ap.add_argument('--seed', type=int, default=0,
                    help='base seed for --random cells')
    ap.add_argument('--cells', default=None, metavar='SUBSTR',
                    help='run only cells whose name contains SUBSTR '
                         '(targeted re-runs; a report of record comes from '
                         'an unfiltered run)')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                    help="'cuda' runs the kernels (the default; fails "
                         "without a GPU), 'cpu' their plain twins")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print('storm: %s' % e, file=sys.stderr)
        return 2

    # The runtimes build at first use: before the first cell, so that no
    # cell's seconds hold a build (the kernels on the card, the host
    # codec's C++ library either way).
    t0 = time.perf_counter()
    if device.type == 'cuda':
        _build.library()
        torch.cuda.synchronize(device)
    native.available()
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    before = launch_counts()
    with tempfile.TemporaryDirectory(prefix='mtscomp_storm_') as tmp, \
            _patched({(config, 'CONFIG_PATH'): Path(tmp) / '.mtscomp'}):
        storm = Storm(device, tmp, quick=args.quick, cell_filter=args.cells)
        storm.run_grid()
        storm.run_random(args.random, args.seed)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    results = storm.results
    n_ok = sum(r['ok'] for r in results)
    summary = dict(
        device=str(device),
        card=_card_line() if device.type == 'cuda' else 'none (the twins)',
        torch=torch.__version__, cuda=torch.version.cuda,
        argv=''.join(' ' + a for a in (argv if argv is not None
                                        else sys.argv[1:])),
        cells=len(results), passed=n_ok, failed=len(results) - n_ok,
        seconds=round(seconds, 3), setup_seconds=round(setup_s, 3),
        launches={k: v for k, v in delta.items() if k not in HOST_COUNTERS},
        host={k: v for k, v in delta.items() if k in HOST_COUNTERS},
        quick=bool(args.quick), random=args.random, seed=args.seed,
        geometry=dict(sr=storm.SR, n_channels=storm.C, n_samples=storm.NS))
    if args.out:
        write_report(args.out, summary, results)
    print("\n%d/%d cells passed on %s in %.1f s%s"
          % (n_ok, len(results), device, seconds,
             ' -> %s.md' % args.out if args.out else ''), flush=True)
    return 0 if n_ok == len(results) else 1


if __name__ == '__main__':
    sys.exit(main())
