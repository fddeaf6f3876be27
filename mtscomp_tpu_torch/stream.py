"""Streaming compression: append samples as they are acquired.

The reference compresses completed files only, yet its headline claim is
"4x faster than real time" (README.md:173-176) — i.e. the natural
deployment is compressing a recording WHILE it is acquired.
``StreamWriter`` provides that: feed ``(n, n_channels)`` sample blocks
of any size as they arrive; every full chunk is delta-transformed,
entropy-coded and written out immediately (bounded memory: one chunk
buffered), and ``close()`` flushes the final partial chunk and emits the
sidecar. The output is **byte-identical** to running ``compress`` on the
finished recording with the same parameters (same chunk geometry from
``compute_chunk_bounds``, same codecs, same SHA1 bookkeeping), so files
written live are indistinguishable from batch-compressed ones.

Usage::

    with StreamWriter('live.cbin', 'live.ch', sample_rate=30000.,
                      n_channels=385, dtype='int16',
                      algorithm='ans') as w:
        for block in acquisition:        # any block sizes
            w.append(block)
    # live.cbin/.ch now equal compress() of the concatenated blocks.

Thread-compatible with an acquisition loop: ``append`` does the codec
work inline (call it from a worker thread to overlap with acquisition);
each call writes complete chunks straight to disk. ``StreamWriter``
runs on the host codec, as in the JAX package: one chunk at a time never
fills a device batch. ``StreamReader`` reads on the configured device,
as the JAX package's does; its windows go through the device chunk cache
of each snapshot's ``Reader``, which it hands on to the next snapshot of
the same file (published chunks never change).
"""

import hashlib
from pathlib import Path

import numpy as np

from .codec import get_codec
from .config import read_config
from .format import build_cmeta, write_cmeta
from .ops.delta import diff_along_axis
from .utils.misc import logger


class StreamWriter:
    """Incrementally compress an unbounded stream of sample blocks."""

    def __init__(self, out, outmeta, sample_rate=None, n_channels=None,
                 dtype=None, live_sidecar=False, **kwargs):
        self.quiet = kwargs.pop('quiet', True)
        # Internal: resume() reopens the existing payload in place
        # instead of truncating it (see StreamWriter.resume).
        reopen = kwargs.pop('_reopen', False)
        self.live_sidecar = bool(live_sidecar)
        config = read_config(**kwargs)
        self.config = config
        if not sample_rate:
            raise ValueError("Please provide a sample rate.")
        if not n_channels:
            raise ValueError("Please provide n_channels.")
        if not dtype:
            raise ValueError("Please provide a dtype.")
        self.sample_rate = float(sample_rate)
        self.n_channels = int(n_channels)
        self.dtype = np.dtype(dtype)
        self.algorithm = config.algorithm
        self.do_time_diff = config.do_time_diff
        # 'auto' transforms are probed on the FIRST BUFFERED CHUNK at
        # first flush (_flush_chunk) — by then a full chunk of real
        # signal exists and no container bytes are written yet — with
        # the exact probe the batch Writer runs on chunk 0, so a
        # streamed recording stays byte-identical to compress() of the
        # finished file under the default config (a live LFP stream
        # must not silently lose the order-2/spatial ratio wins).
        # Until the probe runs, attributes hold the reference transform
        # (order 1, spatial off); explicit values are honored as given;
        # resume() restores the sidecar's record (never 'auto').
        self.do_spatial_diff = (False if config.do_spatial_diff == 'auto'
                                else bool(config.do_spatial_diff))
        self._probe_spatial = (config.do_spatial_diff == 'auto'
                               and config.algorithm == 'ans')
        order_cfg = config.get('time_diff_order', 'auto')
        if order_cfg not in (1, 2, 'auto'):
            raise ValueError("time_diff_order must be 1, 2 or 'auto' "
                             "(got %r)." % (order_cfg,))
        self.time_diff_order = (2 if (order_cfg == 2
                                      and config.algorithm == 'ans'
                                      and config.do_time_diff) else 1)
        self._probe_order = (order_cfg == 'auto'
                             and config.algorithm == 'ans'
                             and bool(config.do_time_diff))
        self.transform_adapt = int(config.get('transform_adapt', 0) or 0)
        if self.transform_adapt < 0:
            raise ValueError("transform_adapt must be >= 0 (got %r)."
                             % (self.transform_adapt,))
        if self.transform_adapt and self.algorithm != 'ans':
            raise ValueError(
                "transform_adapt requires algorithm='ans' (zlib output "
                "must stay byte-identical to the reference).")
        # Candidate grids for adaptive window probes: the same grids
        # the 'auto' settings search (explicit settings stay fixed).
        self._adapt_orders = (
            [1, 2] if order_cfg == 'auto'
            else [order_cfg]) if config.do_time_diff else [1]
        self._adapt_spatials = ([False, True]
                                if config.do_spatial_diff == 'auto'
                                else [bool(config.do_spatial_diff)])
        self.chunk_order = config.chunk_order
        self.comp_level = config.comp_level
        self.codec = get_codec(
            self.algorithm, seg_log2=config.get('ans_seg_log2', 16),
            channel_aligned=config.get('ans_channel_segments', True),
            table_mode=config.get('ans_table_mode', 'plane'))
        # Byte-exact floats under v2 (same transform as Writer.open):
        # code the IEEE bit pattern as the same-width integer. resume()
        # overrides this from the sidecar so pre-flag float streams
        # keep their float-domain transform.
        self.float_bitcast = (self.algorithm == 'ans'
                              and self.dtype.kind == 'f'
                              and self.dtype.itemsize in (2, 4, 8))
        self.code_dtype = (np.dtype('int%d' % (self.dtype.itemsize * 8))
                           if self.float_bitcast else self.dtype)
        self.chunk_size = int(np.round(config.chunk_duration
                                       * self.sample_rate))
        assert self.chunk_size > 0
        self.out = Path(out)
        self.outmeta = Path(outmeta)
        self.out.parent.mkdir(exist_ok=True, parents=True)
        self._fb = open(self.out, 'r+b' if reopen else 'wb')
        # Preallocated one-chunk staging buffer, filled in place: every
        # appended sample is copied exactly once, and the writer never
        # aliases a caller's (possibly reused) acquisition buffer.
        self._buffer = np.empty((self.chunk_size, self.n_channels),
                                dtype=self.dtype)
        self._fill = 0
        self._adapt_current = None
        self._adapt_win = -1
        self.chunk_bounds = [0]
        self.chunk_offsets = [0]
        self.n_samples = 0
        self.sha1_compressed = hashlib.sha1()
        self.sha1_uncompressed = hashlib.sha1()
        self._closed = False
        self._ratio = None

    # -- feeding ------------------------------------------------------------

    def append(self, samples):
        """Add a ``(n, n_channels)`` block; full chunks are written out."""
        if self._closed:
            # Real exception (not an assert): under python -O a closed
            # writer would silently buffer-and-drop samples.
            raise ValueError("StreamWriter is closed.")
        samples = np.asarray(samples)
        if samples.ndim == 1:
            if samples.size % self.n_channels:
                # Same descriptive error as the 2-D mismatch below, not
                # numpy's raw reshape error.
                raise ValueError("Block shape %s does not match %d channels."
                                 % (samples.shape, self.n_channels))
            samples = samples.reshape(-1, self.n_channels)
        # Real exceptions, not asserts: silently casting a mismatched
        # block under python -O would write a self-consistent but WRONG
        # recording that no later hash check can catch.
        if samples.ndim != 2 or samples.shape[1] != self.n_channels:
            raise ValueError("Block shape %s does not match %d channels."
                             % (samples.shape, self.n_channels))
        if samples.dtype != self.dtype:
            raise ValueError("Block dtype %s != stream dtype %s."
                             % (samples.dtype, self.dtype))
        pos, n = 0, samples.shape[0]
        while pos < n:
            take = min(self.chunk_size - self._fill, n - pos)
            self._buffer[self._fill:self._fill + take] = \
                samples[pos:pos + take]
            self._fill += take
            pos += take
            if self._fill == self.chunk_size:
                self._flush_chunk(self._buffer)
                self._fill = 0

    @classmethod
    def resume(cls, out, outmeta, live_sidecar=None, quiet=True,
               **overrides):
        """Reopen an interrupted stream and continue where it left off.

        Crash recovery for live acquisition: a
        ``StreamWriter(live_sidecar=True)`` that dies (power loss,
        kill) leaves a payload plus a snapshot sidecar referencing only
        fully flushed chunks. ``resume`` re-derives the writer state
        from that pair so appending can continue, and the finished file
        is **byte-identical** to an uninterrupted stream (and therefore
        to ``compress()`` of the whole recording):

        - format parameters (algorithm, diffs, order, chunk geometry,
          ANS table settings) come from the sidecar — ``overrides`` may
          add non-format options only;
        - payload bytes past the last published chunk offset (an
          unflushed partial write) are truncated away;
        - both SHA1 accumulators are re-derived over the surviving
          prefix — the compressed stream by re-hashing the file, the
          raw stream by decoding every chunk — and checked against the
          sidecar where it records them, so a resume doubles as a full
          integrity audit (IOError on any mismatch). Chopped files
          (hashes nulled) resume uncheckable but finalize with real
          re-derived hashes;
        - samples that were still in the crashed writer's one-chunk
          buffer were never on disk and are NOT recovered — the
          acquisition must replay from ``writer.n_samples``.

        A finalized (non-streaming) sidecar is also accepted — i.e.
        this doubles as append-to-existing — provided its last chunk is
        full (a partial tail chunk cannot be extended byte-identically).

        A sidecar whose offset table is ``[0]`` publishes no payload
        byte: the stream resumes empty, at sample 0 (its chunk bounds,
        which no payload backs, only give the chunk size), and the
        payload file is truncated like any other unpublished tail.
        """
        from .format import read_cmeta
        out, outmeta = Path(out), Path(outmeta)
        cm = read_cmeta(outmeta)
        bounds = [int(b) for b in cm['chunk_bounds']]
        offsets = [int(o) for o in cm['chunk_offsets']]
        if len(bounds) < 2:
            raise ValueError("Cannot resume %s: the sidecar references "
                             "no complete chunks." % out)
        sizes = set(b1 - b0 for b0, b1 in zip(bounds, bounds[1:]))
        if len(sizes) != 1:
            raise ValueError(
                "Cannot resume %s: its last chunk is partial — a longer "
                "recording would place a full chunk there, so appending "
                "cannot stay byte-identical to a batch compress." % out)
        chunk_size = sizes.pop()
        # Chunks on disk are what the offset table publishes.
        published = len(offsets) > 1
        if not published:
            bounds = [0]
        # Every key that defines how already-written chunks decode is
        # sidecar-owned: an override would finalize a sidecar that no
        # longer describes the surviving chunks (e.g. time_diff_order
        # rewritten to 1 while the prefix was encoded order-2 —
        # silently corrupt, and the resume audit can't catch it because
        # the audit runs with the ORIGINAL sidecar).
        for key in ('sample_rate', 'n_channels', 'dtype', 'algorithm',
                    'do_time_diff', 'do_spatial_diff', 'time_diff_order',
                    'chunk_order', 'float_bitcast', 'transform_adapt'):
            if key in overrides:
                raise ValueError("resume derives %r from the sidecar; "
                                 "it cannot be overridden." % key)
        kwargs = dict(
            algorithm=cm['algorithm'],
            do_time_diff=cm['do_time_diff'],
            do_spatial_diff=cm['do_spatial_diff'],
            chunk_order=cm.get('chunk_order', 'F'),
            comp_level=cm.get('comp_level', -1),
            chunk_duration=chunk_size / float(cm['sample_rate']),
            # Continue with the recorded prediction order (absent key =
            # order 1), never the library default.
            time_diff_order=int(cm.get('time_diff_order', 1)),
        )
        if cm.get('ans_seg_log2') is not None:
            kwargs['ans_seg_log2'] = cm['ans_seg_log2']
        adapt_grid = None
        if cm.get('transform_adapt'):
            kwargs['transform_adapt'] = int(cm['transform_adapt'])
            adapt_grid = cm.get('transform_adapt_grid')
        # The sidecar records ans_table_mode only when it is not
        # 'plane' — absence means plane, which must NOT fall back to
        # the Writer's default ('segment') or the resumed
        # chunks would diverge from the batch-compressed bytes.
        kwargs['ans_table_mode'] = cm.get('ans_table_mode') or 'plane'
        kwargs.update(overrides)
        if (np.dtype(cm['dtype']).kind == 'f'
                and not bool(cm.get('float_bitcast', False))):
            # Legacy-domain float files decode within CHECK_ATOL, not
            # byte-exactly, so the writer's raw-stream hash state cannot
            # be re-derived — a resumed file would finalize a
            # sha1_uncompressed describing neither the original
            # recording nor the decode. Refuse BEFORE touching the file:
            # a resume that can never succeed must be side-effect-free
            # (no truncation of trailing bytes).
            raise ValueError(
                "Cannot resume %s: float files in the legacy "
                "(non-bitcast) domain do not decode byte-exactly, "
                "so the raw-stream hash cannot be recovered. "
                "Record float streams with algorithm='ans' "
                "(float_bitcast) to make them resumable." % out)
        if live_sidecar is None:
            live_sidecar = bool(cm.get('streaming', False))
        w = cls(out, outmeta, sample_rate=cm['sample_rate'],
                n_channels=cm['n_channels'], dtype=cm['dtype'],
                live_sidecar=live_sidecar, quiet=quiet, _reopen=True,
                **kwargs)
        # The float transform domain is a format property of the file:
        # follow the sidecar, not the library default — float streams
        # written before the flag existed must keep their float-domain
        # diffs or resumed chunks would not round-trip.
        w.float_bitcast = (bool(cm.get('float_bitcast', False))
                           and w.dtype.kind == 'f')
        w.code_dtype = (np.dtype('int%d' % (w.dtype.itemsize * 8))
                        if w.float_bitcast else w.dtype)
        if adapt_grid:
            # The probe grid the original writer searched ('auto'
            # candidates); the resumed writer must keep probing the
            # same grid, not the singletons its resolved kwargs imply.
            w._adapt_orders = [int(o) for o in adapt_grid[0]]
            w._adapt_spatials = [bool(s) for s in adapt_grid[1]]
        try:
            if w.chunk_size != chunk_size:
                # Guard against chunk_duration float round-trip drift.
                w.chunk_size = chunk_size
                w._buffer = np.empty((chunk_size, w.n_channels),
                                     dtype=w.dtype)
            import os
            size = os.fstat(w._fb.fileno()).st_size
            if size < offsets[-1]:
                raise IOError(
                    "Cannot resume %s: payload is %d bytes but the "
                    "sidecar references %d — the file is truncated "
                    "below its last published chunk."
                    % (out, size, offsets[-1]))
            if size > offsets[-1]:
                # Unflushed bytes past the last published chunk (the
                # crash interrupted a write): drop them.
                w._fb.truncate(offsets[-1])
            w._fb.seek(0)
            while True:
                block = w._fb.read(1 << 20)
                if not block:
                    break
                w.sha1_compressed.update(block)
            # Chopped files null both hashes (reference chop semantics,
            # mtscomp.py:750-796): nothing to audit against, but the
            # re-derived accumulators below are still exact, so the
            # finalized sidecar regains REAL hashes over the whole file.
            if cm.get('sha1_compressed') is not None \
                    and w.sha1_compressed.hexdigest() != cm['sha1_compressed']:
                raise IOError(
                    "Cannot resume %s: payload does not match the "
                    "sidecar's sha1_compressed — the surviving prefix "
                    "is corrupt." % out)
            if published and w.algorithm == 'ans' \
                    and 'ans_channel_segments' not in overrides:
                # The sidecar does not record the channel-aligned
                # layout choice (it is a per-container flag, bit2);
                # derive it from the first surviving chunk so resumed
                # chunks keep the file's layout. Restored BEFORE the
                # audit pass: the adaptive leader re-probe below sizes
                # candidates with w.codec, and probe_transform's winner
                # can flip with channel_aligned — probing with the
                # constructor default would silently diverge resumed
                # bytes for ans_channel_segments=False streams.
                w._fb.seek(offsets[0])
                parsed0 = w.codec.parse(
                    w._fb.read(offsets[1] - offsets[0]))
                w.codec.channel_aligned = bool(parsed0['aligned'])
            if published:
                cls._audit_prefix(w, out, outmeta, len(bounds) - 1)
            if cm.get('sha1_uncompressed') is not None \
                    and w.sha1_uncompressed.hexdigest() != cm['sha1_uncompressed']:
                raise IOError(
                    "Cannot resume %s: decoded data does not match the "
                    "sidecar's sha1_uncompressed." % out)
            w.chunk_bounds = bounds
            w.chunk_offsets = offsets
            w.n_samples = bounds[-1]
            w._fb.seek(offsets[-1])
        except BaseException:
            w._fb.close()
            w._closed = True
            raise
        if not quiet:
            logger.info("Resumed stream %s at sample %d (%d chunks).",
                        out, w.n_samples, len(bounds) - 1)
        return w

    @staticmethod
    def _audit_prefix(w, out, outmeta, n_done):
        """Decode the ``n_done`` chunks on disk into the resumed writer
        ``w``'s raw-stream hash and, mid-window in an adaptive stream,
        re-derive the window leader's transform."""
        from .api import Reader, probe_transform, TRANSFORM_PROBE_SAMPLES
        r = Reader(quiet=True, device='none')
        r.open(out, outmeta)
        # Mid-window resume of an adaptive stream: the NEXT chunk's
        # transform is its window LEADER's probe result; the leader
        # is already on disk, so re-derive the choice from its
        # decoded samples (bit-exact for ans) during the audit pass
        # below — resumed bytes stay identical to an uninterrupted
        # stream.
        adapt_leader = None
        if w.transform_adapt and n_done % w.transform_adapt:
            adapt_leader = ((n_done // w.transform_adapt)
                            * w.transform_adapt)
        try:
            for i, start, length in r.iter_chunks():
                chunk = r.read_chunk(i, start, length)
                chunk = np.ascontiguousarray(chunk)
                w.sha1_uncompressed.update(chunk)
                if i == adapt_leader:
                    probe = chunk.view(w.code_dtype) \
                        if w.float_bitcast else chunk
                    w._adapt_current = probe_transform(
                        probe[:TRANSFORM_PROBE_SAMPLES], w.codec,
                        w.chunk_order, w.do_time_diff,
                        w._adapt_orders, w._adapt_spatials)
                    w._adapt_win = i // w.transform_adapt
        finally:
            r.close()

    def _flush_chunk(self, chunk):
        chunk = np.ascontiguousarray(chunk)
        if self.float_bitcast:
            # Identical bytes (both SHA1s unaffected); the transform and
            # the entropy stage run on the integer view.
            chunk = chunk.view(self.code_dtype)
        if (self._probe_order or self._probe_spatial) \
                and len(self.chunk_bounds) == 1:
            # First flush of an 'auto' stream: same probe, same slice,
            # same margin as Writer._pick_transform on chunk 0 (the
            # first flushed chunk IS batch chunk 0 — full, or the whole
            # short recording when close() flushes a partial tail).
            from .api import probe_transform, TRANSFORM_PROBE_SAMPLES
            orders = [1, 2] if self._probe_order else [self.time_diff_order]
            spatials = ([False, True] if self._probe_spatial
                        else [bool(self.do_spatial_diff)])
            order, spatial = probe_transform(
                chunk[:TRANSFORM_PROBE_SAMPLES], self.codec,
                self.chunk_order, self.do_time_diff, orders, spatials)
            self.time_diff_order, self.do_spatial_diff = order, spatial
            self._probe_order = self._probe_spatial = False
            if self.transform_adapt:
                # This probe IS window 0's leader probe (same inputs,
                # same grids); seed the adaptive state instead of
                # re-running it below.
                self._adapt_current = (order, spatial)
                self._adapt_win = 0
        if self.transform_adapt:
            idx = len(self.chunk_bounds) - 1
            win = idx // self.transform_adapt
            if win != self._adapt_win or self._adapt_current is None:
                # Window leader: re-probe (identical inputs and grids
                # to the batch Writer's window probe, so stream bytes
                # stay identical to a batch compress with the same
                # transform_adapt).
                from .api import probe_transform, TRANSFORM_PROBE_SAMPLES
                self._adapt_current = probe_transform(
                    chunk[:TRANSFORM_PROBE_SAMPLES], self.codec,
                    self.chunk_order, self.do_time_diff,
                    self._adapt_orders, self._adapt_spatials)
                self._adapt_win = win
            t_order, t_spatial = self._adapt_current
            tdesc = (t_order if self.do_time_diff else 0, t_spatial)
        else:
            t_order, t_spatial = self.time_diff_order, self.do_spatial_diff
            tdesc = None
        # Parts form when available: the container streams to the file
        # part by part instead of through one multi-MB join (see
        # Writer._compress_chunk).
        enc = getattr(self.codec, 'encode_parts', self.codec.encode)
        if (self.algorithm == 'ans' and self.do_time_diff
                and not t_spatial):
            # The codec fuses the axis-0 diff into its native prep
            # pass (byte-identical output; saves a memory round trip).
            src = (diff_along_axis(chunk, axis=0)
                   if t_order == 2 else chunk)
            payload = enc(src, order=self.chunk_order,
                          time_diff_pending=True, transform=tdesc)
        else:
            chunkd = diff_along_axis(chunk,
                                     axis=0 if self.do_time_diff else None)
            if self.do_time_diff and t_order == 2:
                chunkd = diff_along_axis(chunkd, axis=0)
            chunkd = diff_along_axis(chunkd,
                                     axis=1 if t_spatial else None)
            if tdesc is not None:
                payload = enc(chunkd, order=self.chunk_order,
                              transform=tdesc)
            else:
                payload = enc(chunkd, order=self.chunk_order)
        parts = payload if isinstance(payload, list) else (payload,)
        size = 0
        for part in parts:
            self._fb.write(part)
            self.sha1_compressed.update(part)
            size += len(part)
        self.n_samples += chunk.shape[0]
        self.chunk_bounds.append(self.n_samples)
        self.chunk_offsets.append(self.chunk_offsets[-1] + size)
        self.sha1_uncompressed.update(chunk)
        logger.debug("Streamed chunk %d (%d samples).",
                     len(self.chunk_bounds) - 2, chunk.shape[0])
        if self.live_sidecar:
            # Publish a snapshot sidecar so concurrent readers can tail
            # the stream. Payload bytes are flushed to the OS first, so
            # every chunk a published sidecar references is readable;
            # the atomic replace means readers never see a torn file.
            # Each snapshot (with its prefix hashes) is itself a fully
            # valid compressed file of the samples so far.
            self._fb.flush()
            self._write_sidecar(streaming=True)

    def _write_sidecar(self, streaming=False):
        extra = {}
        if self.algorithm == 'ans':
            extra['ans_seg_log2'] = self.codec.seg_log2
            if self.codec.table_mode != 'plane':
                extra['ans_table_mode'] = self.codec.table_mode
            if self.float_bitcast:
                extra['float_bitcast'] = True
            if self.do_time_diff and self.time_diff_order == 2:
                extra['time_diff_order'] = 2
            if self.transform_adapt:
                # Writer setting + its probe grid (resume must keep
                # probing the SAME candidate grid or post-resume
                # windows would diverge from an uninterrupted stream).
                # Decode never consults these: chunks self-describe
                # via the container's flags bit5.
                extra['transform_adapt'] = int(self.transform_adapt)
                extra['transform_adapt_grid'] = [
                    list(self._adapt_orders),
                    [bool(s) for s in self._adapt_spatials]]
        if streaming:
            extra['streaming'] = True
        cmeta = build_cmeta(
            algorithm=self.algorithm, comp_level=self.comp_level,
            do_time_diff=self.do_time_diff,
            do_spatial_diff=self.do_spatial_diff,
            dtype=self.dtype, n_channels=self.n_channels,
            sample_rate=self.sample_rate, chunk_bounds=self.chunk_bounds,
            chunk_offsets=self.chunk_offsets, chunk_order=self.chunk_order,
            sha1_compressed=self.sha1_compressed.hexdigest(),
            sha1_uncompressed=self.sha1_uncompressed.hexdigest(),
            shape=(self.n_samples, self.n_channels), extra=extra)
        if self.live_sidecar:
            # Atomic replace for EVERY publish (snapshots and the final
            # sidecar alike): concurrent tailers must never observe a
            # truncated file mid-write.
            tmp = self.outmeta.with_name(self.outmeta.name + '.snapshot')
            write_cmeta(tmp, cmeta)
            tmp.replace(self.outmeta)
        else:
            write_cmeta(self.outmeta, cmeta)

    # -- finalize -----------------------------------------------------------

    def close(self):
        """Flush the trailing partial chunk and write the sidecar.

        Returns the compressed/raw size ratio. The stream must have
        received at least one sample (empty recordings are rejected,
        matching ``Writer.open``'s ``n_samples > 0`` contract).
        """
        if self._closed:
            return self._ratio
        if self._fill:
            self._flush_chunk(self._buffer[:self._fill])
            self._fill = 0
        self._fb.close()
        if self.n_samples == 0:
            self.out.unlink(missing_ok=True)
            self._closed = True
            raise ValueError("Cannot finalize an empty stream.")
        self._write_sidecar(streaming=False)
        raw = self.n_samples * self.n_channels * self.dtype.itemsize
        self._ratio = self.chunk_offsets[-1] / raw
        self._closed = True
        if not self.quiet:
            logger.info("Closed stream %s: %d samples, ratio %.3f.",
                        self.out, self.n_samples, self._ratio)
        return self._ratio

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        elif not self._closed:
            # Abort: leave no half-written outputs behind. A stream
            # already finalized by an explicit close() is a complete,
            # valid recording — never delete it because unrelated code
            # raised later inside the with-block.
            self._fb.close()
            self.out.unlink(missing_ok=True)
            if self.live_sidecar:
                self.outmeta.unlink(missing_ok=True)
            self._closed = True


class StreamReader:
    """Tail a recording while a ``StreamWriter(live_sidecar=True)``
    writes it — possibly from another process.

    Every published sidecar snapshot references only fully flushed
    chunks and is replaced atomically, so this is just a ``Reader``
    that re-opens when the sidecar changes::

        r = StreamReader('live.cbin', 'live.ch')
        while r.refresh() or not r.finalized:
            plot(r[-3000:])           # the newest second, live
        full = r[:]                   # recording complete

    ``refresh()`` returns True when new samples appeared; ``finalized``
    turns True once the writer has closed (the snapshot's ``streaming``
    marker is dropped from the final sidecar). All ``Reader`` indexing
    (slices, tuples, scalars) works on the samples available so far.
    """

    def __init__(self, cdata, cmeta=None, **kwargs):
        from .format import cmeta_sidecar_path
        self.cdata = Path(cdata)
        self.cmeta = Path(cmeta) if cmeta is not None \
            else cmeta_sidecar_path(self.cdata)
        self._kwargs = dict(kwargs, quiet=kwargs.get('quiet', True))
        self._reader = None
        self._stamp = None
        self._refresh_failures = 0
        self.refresh()
        if self._reader is None:
            raise IOError("No readable sidecar at %s — is the stream's "
                          "writer using live_sidecar=True?" % self.cmeta)

    def refresh(self):
        """Re-open if the sidecar changed; True when samples were added.

        Tolerant of torn reads: a sidecar that fails to parse (mid-copy
        on a non-atomic filesystem, truncated snapshot) keeps the
        previous reader and returns False — the next poll retries.
        """
        try:
            st = self.cmeta.stat()
        except FileNotFoundError:
            return False
        stamp = (st.st_mtime_ns, st.st_size)
        if stamp == self._stamp:
            return False
        from .api import Reader
        r = Reader(**self._kwargs)
        try:
            r.open(self.cdata, self.cmeta)
        except (OSError, ValueError, KeyError) as e:
            # Parse-shaped failures only: a torn snapshot is transient,
            # but a genuine reader bug (AttributeError etc.) must NOT be
            # swallowed as "stale sidecar, retry forever". Count
            # consecutive failures so a permanently malformed sidecar
            # eventually surfaces instead of looking like silence.
            self._refresh_failures += 1
            logger.debug("StreamReader.refresh: sidecar not (yet) "
                         "readable (%s: %s) — attempt %d.",
                         type(e).__name__, e, self._refresh_failures)
            if self._refresh_failures >= 10:
                logger.warning(
                    "StreamReader: sidecar %s failed to parse %d "
                    "consecutive times (%s: %s) — it may be permanently "
                    "malformed, not a torn snapshot.",
                    self.cmeta, self._refresh_failures,
                    type(e).__name__, e)
            return False
        self._refresh_failures = 0
        before = self._reader.shape[0] if self._reader is not None else 0
        if self._reader is not None:
            # The new snapshot keeps the decoded chunks of the old one.
            cache = self._reader._dev_cache
            if cache is not None and r.device == self._reader.device:
                cache.adopt(r)
            self._reader.close()
        self._reader = r
        self._stamp = stamp
        return r.shape[0] > before

    @property
    def finalized(self):
        """True once the writer closed (final sidecar published)."""
        return not self._reader.cmeta.get('streaming', False)

    @property
    def shape(self):
        return self._reader.shape

    @property
    def n_samples(self):
        return self._reader.shape[0]

    @property
    def dtype(self):
        return self._reader.dtype

    def __getitem__(self, item):
        return self._reader[item]

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
