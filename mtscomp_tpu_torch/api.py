"""Core codec runtime of the port: ``Writer``, ``Reader``, and the
functional API (``compress``, ``decompress``, ``check``).

The port's own copy of ``mtscomp_tpu/api.py``, with the JAX package's
device routing replaced by the port's:

- ``Writer`` encodes each batch of an ans (v2) file through
  :class:`~.parallel.pipeline.DeviceBatchEncoder` on the configured
  ``device`` (``'cuda'``, the default, runs the hand-written kernels;
  ``'cpu'`` their plain PyTorch twins), or on the host codec with
  ``device='none'``. Both write the same bytes.
- ``Reader`` decodes bulk reads of ans files (``to_array``, ``tofile``)
  through the port's batched decode on its ``device``, and
  ``to_tensor`` leaves the decoded samples there. Random-access
  windows and column reads stay on the host codec.

Everything else (memmapped input, chunking, the transform probe,
adaptive windows, the double-buffered write-back with its two SHA1
streams, the automatic check, NumPy-protocol slicing, ``chop``) is the
reference's (mtscomp.py:216-997) as the JAX package implements it.
"""

import bisect
import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
import math
from pathlib import Path

import numpy as np

from .codec import get_codec
from .config import read_config, CHECK_ATOL, CRITICAL_ERROR_MSG
from .device import configured_device
from .format import (build_cmeta, compute_chunk_bounds, read_cmeta,
                     write_cmeta, cmeta_sidecar_path)
from .io_host import load_raw_data, pread_exact, default_compressed_paths
from .ops.delta import diff_along_axis, cumsum_along_axis
from .parallel import pipeline
from .parallel.pipeline import (DeviceBatchEncoder, MIN_DEVICE_SUBBATCH,
                                decompress_to_array, decompress_to_tensor)
from .utils.misc import Bunch, clip, logger, progress


# Host slice reads spanning at least this many chunks — and more than
# the reader's LRU capacity, so repeated reads could never be cache
# hits anyway — skip the chunk cache and run the codec's batch decoder
# straight into one span-wide array (Reader._read_span_bulk): cacheable
# window reads keep the LRU's repeat-read latency, wide reads get the
# C++ worker pool and lose a full-span concatenate copy.
_BULK_SPAN_CHUNKS = 4

# Probe slice length for the 'auto' transform decision (first chunk's
# leading samples): long enough for a stable ratio estimate, short
# enough that the probe costs ~0.5% of a realistic compress.
TRANSFORM_PROBE_SAMPLES = 8192


def probe_transform(probe, codec, chunk_order, do_time_diff, orders,
                    spatials):
    """Encode a probe slice under each candidate transform (time-diff
    order x spatial diff); return the winning ``(order, spatial)``.

    Oversampled bands (LFP-like) compress far better under the second
    time difference (the first diff is still strongly correlated:
    measured +5% on band-limited noise, +55% on oscillatory LFP);
    noise-dominated bands lose (the second diff doubles white-noise
    variance: measured -11..-13%). The spatial diff wins on
    channel-correlated data (smooth LFP fields +10%, common-mode
    artifacts +19% measured) and loses on independent channels for the
    same variance-doubling reason. A 2% margin over the reference
    transform (``(orders[0], spatials[0])``) keeps borderline files on
    it; exact ties prefer the less aggressive candidate (the tuple
    tie-break: lower order, then spatial off).

    ``Writer`` probes chunk 0 of the memmap, and each adaptive window's
    leader chunk.
    """
    if len(orders) == 1 and len(spatials) == 1:
        # Degenerate grid (everything explicit): nothing to probe.
        return orders[0], bool(spatials[0])
    base = diff_along_axis(probe, axis=0) if do_time_diff else probe
    sizes = {}
    for order in orders:
        d = base if order == 1 else diff_along_axis(base, axis=0)
        for spatial in spatials:
            dsp = diff_along_axis(d, axis=1 if spatial else None)
            sizes[(order, spatial)] = len(
                codec.encode(dsp, order=chunk_order))
    ref = (orders[0], spatials[0])      # reference transform
    best = min(sizes, key=lambda k: (sizes[k], k))
    if best != ref and sizes[best] >= 0.98 * sizes[ref]:
        best = ref
    logger.debug("transform auto probe: %s -> order %d, spatial %s.",
                 {k: v for k, v in sorted(sizes.items())},
                 best[0], best[1])
    return best


class Writer:
    """Compress a raw multichannel binary file into ``.cbin`` + ``.ch``.

    Configuration keys (merged through ``read_config``): chunk_duration,
    algorithm ('zlib' legacy / 'ans' v2), comp_level (recorded only),
    do_time_diff, do_spatial_diff, chunk_order, n_threads,
    check_after_compress, device ('cuda', 'cpu' or 'none': where ans
    batches encode).

    ``before_check`` is a hook invoked between writing and the automatic
    integrity check (used by fault-injection tests; reference
    mtscomp.py:241, 499).
    """

    def __init__(self, before_check=None, **kwargs):
        self.quiet = kwargs.pop('quiet', False)
        config = read_config(**kwargs)
        self.config = config
        self.chunk_duration = config.chunk_duration
        self.algorithm = config.algorithm
        self.comp_level = config.comp_level
        self.do_time_diff = config.do_time_diff
        self.do_spatial_diff = config.do_spatial_diff
        if isinstance(self.do_spatial_diff, str):
            if self.do_spatial_diff != 'auto':
                raise ValueError("do_spatial_diff must be a boolean or "
                                 "'auto' (got %r)."
                                 % (self.do_spatial_diff,))
        else:
            self.do_spatial_diff = bool(self.do_spatial_diff)
        self.time_diff_order = config.get('time_diff_order', 'auto')
        if self.time_diff_order not in (1, 2, 'auto'):
            raise ValueError("time_diff_order must be 1, 2 or 'auto' "
                             "(got %r)." % (self.time_diff_order,))
        self.transform_adapt = int(config.get('transform_adapt', 0) or 0)
        if self.transform_adapt < 0:
            raise ValueError("transform_adapt must be >= 0 (got %r)."
                             % (self.transform_adapt,))
        if self.transform_adapt and self.algorithm != 'ans':
            raise ValueError(
                "transform_adapt requires algorithm='ans' (zlib output "
                "must stay byte-identical to the reference).")
        self._adapt_cache = {}
        self._adapt_lock = threading.Lock()
        # As-configured transform settings: open() resolves 'auto'
        # in place (probing the opened file), so a REUSED writer must
        # restart each open from these, not from the previous file's
        # resolution.
        self._cfg_time_diff_order = self.time_diff_order
        self._cfg_do_spatial_diff = self.do_spatial_diff
        self.chunk_order = config.chunk_order
        self.n_threads = max(1, int(config.n_threads))
        self.check_after_compress = config.check_after_compress
        self.before_check = before_check or (lambda w: None)
        self.codec = get_codec(
            self.algorithm, seg_log2=config.get('ans_seg_log2', 16),
            channel_aligned=config.get('ans_channel_segments', True),
            table_mode=config.get('ans_table_mode', 'segment'))
        self.device = configured_device(config.device) \
            if self.algorithm == 'ans' else None
        self.data = None
        self._pool = None

    # -- setup --------------------------------------------------------------

    def open(self, data_path, sample_rate=None, n_channels=None, dtype=None,
             offset=None, mmap=True):
        """Memmap the raw file and compute the chunk layout."""
        self.data_path = Path(data_path)
        sample_rate = sample_rate or self.config.get('sample_rate', None)
        if not sample_rate:
            raise ValueError("Please provide a sample rate (-s option in the "
                             "command-line).")

        if str(data_path).endswith('.npy'):
            self.data = np.load(data_path, mmap_mode='r')
            self.shape = self.data.shape
            if self.data.ndim >= 3:
                # Flatten leading axes; the original shape is kept in .ch.
                self.data = np.reshape(self.data, (-1, self.data.shape[-1]))
            self.dtype = self.data.dtype
            n_channels = self.data.shape[1]
        else:
            n_channels = n_channels or self.config.get('n_channels', None)
            if not n_channels:
                raise ValueError("Please provide n_channels (-n option in the "
                                 "command-line).")
            dtype = dtype or self.config.get('dtype', None)
            if not dtype:
                raise ValueError("Please provide a dtype (-d option in the "
                                 "command-line).")
            self.dtype = np.dtype(dtype)
            self.data = load_raw_data(
                data_path, n_channels=n_channels, dtype=self.dtype,
                offset=offset, mmap=mmap)
            self.shape = self.data.shape

        # Byte-exact floats (v2 only): code the IEEE bit pattern as the
        # same-width integer — the modular int diff/cumsum pair is an
        # exact inverse, unlike float arithmetic (the reference's float
        # round trips are only allclose, mtscomp.py:880-886, and its
        # automatic check can fail outright near zero crossings). The
        # bitcast also compresses smooth float signals ~5% better
        # (neighboring floats share sign/exponent/high-mantissa bytes,
        # so the zigzag diff planes concentrate near zero). Recorded in
        # the sidecar as ``float_bitcast``; files without the key (v1,
        # or v2 written before the key existed) decode float-domain.
        self.float_bitcast = (self.algorithm == 'ans'
                              and self.dtype.kind == 'f'
                              and self.dtype.itemsize in (2, 4, 8))
        self.code_dtype = (np.dtype('int%d' % (self.dtype.itemsize * 8))
                           if self.float_bitcast else self.dtype)
        self.sample_rate = float(sample_rate)
        assert self.sample_rate > 0
        assert self.data.ndim == 2
        self.n_samples, self.n_channels = self.data.shape
        assert self.n_samples > 0
        assert self.n_channels > 0
        assert n_channels == self.n_channels
        self.file_size = self.data.size * self.data.itemsize
        logger.info("Opening %s, duration %.1fs, %d channels.", data_path,
                    self.n_samples / self.sample_rate, self.n_channels)

        self.chunk_bounds = compute_chunk_bounds(
            self.n_samples, self.sample_rate, self.chunk_duration)
        self.n_chunks = len(self.chunk_bounds) - 1
        self.batch_size = self.n_threads
        self.n_batches = math.ceil(self.n_chunks / self.batch_size)
        # Second-order time prediction and the auto spatial decision are
        # ans (v2) extensions; zlib output must stay byte-identical to
        # the reference ('auto' resolves to the reference transform).
        self.time_diff_order = self._cfg_time_diff_order
        self.do_spatial_diff = self._cfg_do_spatial_diff
        if self.algorithm != 'ans':
            self.time_diff_order = 1
            if self.do_spatial_diff == 'auto':
                self.do_spatial_diff = False
        else:
            if not self.do_time_diff:
                self.time_diff_order = 1
            # Candidate grids for the transform probe, captured BEFORE
            # 'auto' resolves: adaptive windows re-probe the same grid
            # the chunk-0 probe searched (a fixed order/spatial setting
            # stays fixed — adaptation never overrides an explicit
            # user choice, it only re-runs the open decisions).
            self._adapt_orders = (
                [1, 2] if self.time_diff_order == 'auto'
                else [self.time_diff_order]) if self.do_time_diff else [1]
            self._adapt_spatials = (
                [False, True] if self.do_spatial_diff == 'auto'
                else [bool(self.do_spatial_diff)])
            if (self.time_diff_order == 'auto'
                    or self.do_spatial_diff == 'auto'):
                order, spatial = self._pick_transform()
                self.time_diff_order = order
                self.do_spatial_diff = spatial
            if self.transform_adapt:
                # Fresh cache per open(): a reused Writer must probe
                # the NEW file's windows, not return another
                # recording's cached choices. Window 0's leader is
                # chunk 0 — same probe as the resolution above, same
                # result; seed it so it never re-runs.
                self._adapt_cache = {0: (self.time_diff_order,
                                         bool(self.do_spatial_diff))}
        # SHA1 accumulators are (re)seeded per write() call.

    def _pick_transform(self):
        """Probe chunk 0: encode a slice under each candidate transform
        (time-diff order x spatial diff), keep the winner
        (:func:`probe_transform`)."""
        return self._probe_chunk_transform(0)

    def _probe_chunk_transform(self, chunk_idx):
        """Run the candidate-grid probe on one chunk's leading slice."""
        ns = min(self.chunk_bounds[chunk_idx + 1]
                 - self.chunk_bounds[chunk_idx], TRANSFORM_PROBE_SAMPLES)
        probe = np.ascontiguousarray(self.get_chunk(chunk_idx)[:ns])
        return probe_transform(probe, self.codec, self.chunk_order,
                               self.do_time_diff, self._adapt_orders,
                               self._adapt_spatials)

    def _chunk_transform(self, chunk_idx):
        """Effective ``(time_diff_order, spatial)`` for one chunk.

        Adaptive mode: chunks are grouped in fixed windows of
        ``transform_adapt`` chunks; the window LEADER's probe decides
        for the whole window. The rule depends only on chunk content
        and absolute indices — bytes are identical whatever the thread
        schedule, batch size, or multi-host part split (leaders are
        probed lazily from the memmap by whichever worker needs them
        first).
        """
        if not self.transform_adapt:
            return self.time_diff_order, bool(self.do_spatial_diff)
        leader = (chunk_idx // self.transform_adapt) * self.transform_adapt
        with self._adapt_lock:
            got = self._adapt_cache.get(leader)
        if got is None:
            # Probe OUTSIDE the lock: a probe is several sub-chunk
            # encodes, and holding the global lock across it would
            # serialize every pool worker — including cached lookups —
            # whenever any window is being decided. Concurrent
            # duplicate probes are deterministic and idempotent, so a
            # double-checked insert is safe (last writer stores the
            # same value).
            got = self._probe_chunk_transform(leader)
            logger.debug("transform adapt: window leader %d -> "
                         "order %d, spatial %s.", leader, *got)
            with self._adapt_lock:
                self._adapt_cache[leader] = got
        return got

    # -- per-chunk pipeline ---------------------------------------------------

    def get_chunk(self, chunk_idx):
        """Raw data of one chunk, shape ``(n_samples_chunk, n_channels)``.

        Under ``float_bitcast`` the returned array is the same-width
        integer view of the chunk (identical bytes — the raw SHA1 and
        the ratio accounting are unaffected); every compression path
        downstream transforms and codes that integer view.
        """
        assert 0 <= chunk_idx < self.n_chunks
        i0, i1 = self.chunk_bounds[chunk_idx], self.chunk_bounds[chunk_idx + 1]
        chunk = self.data[i0:i1, :]
        return chunk.view(self.code_dtype) if self.float_bitcast else chunk

    def _transform_chunk(self, chunk, order=None, spatial=None):
        """Delta stage: time diff (order 1 or 2), then spatial diff."""
        if order is None:
            order = self.time_diff_order
        if spatial is None:
            spatial = self.do_spatial_diff
        chunkd = diff_along_axis(chunk, axis=0 if self.do_time_diff else None)
        if self.do_time_diff and order == 2:
            chunkd = diff_along_axis(chunkd, axis=0)
        chunkd = diff_along_axis(chunkd, axis=1 if spatial else None)
        assert chunkd.shape == chunk.shape
        assert chunkd.dtype == chunk.dtype
        return chunkd

    def _compress_chunk(self, chunk_idx):
        """Transform + entropy-code one chunk; returns (idx, (raw, payload))."""
        chunk = self.get_chunk(chunk_idx)
        assert chunk.ndim == 2 and chunk.shape[1] == self.n_channels
        if self.transform_adapt:
            t_order, t_spatial = self._chunk_transform(chunk_idx)
            # Stamp the container (flags bit5): every adaptive chunk is
            # self-describing; decoders honor it over the sidecar.
            tdesc = (t_order if self.do_time_diff else 0, t_spatial)
        else:
            t_order, t_spatial = self.time_diff_order, self.do_spatial_diff
            tdesc = None
        # Prefer the parts form (a list of byte-like container pieces):
        # the write-back loop streams parts straight to the file, so
        # the multi-MB per-chunk container join never happens.
        enc = getattr(self.codec, 'encode_parts', self.codec.encode)
        if (self.algorithm == 'ans' and self.do_time_diff
                and not t_spatial):
            # The ANS codec fuses the axis-0 diff into its native prep
            # pass (byte-identical output; saves a memory round trip —
            # and reads the memmap pages directly instead of through a
            # diffed copy). Order 2: the first diff runs here, the
            # second fuses into the prep — still one extra pass total.
            src = (diff_along_axis(chunk, axis=0)
                   if t_order == 2 else chunk)
            payload = enc(src, order=self.chunk_order,
                          time_diff_pending=True, transform=tdesc)
        else:
            chunkd = self._transform_chunk(chunk, t_order, t_spatial)
            if tdesc is not None:
                payload = enc(chunkd, order=self.chunk_order,
                              transform=tdesc)
            else:
                payload = enc(chunkd, order=self.chunk_order)
        size = (sum(len(p) for p in payload)
                if isinstance(payload, list) else len(payload))
        logger.debug("Chunk %d/%d: -%.3f%%.", chunk_idx + 1, self.n_chunks,
                     100 - 100 * size / (chunk.size * chunk.itemsize))
        return chunk_idx, (chunk, payload)

    def _use_device(self):
        """Whether batches encode through the port's
        :class:`DeviceBatchEncoder`: every ans batch, unless
        ``device='none'`` asks for the host codec (the same bytes)."""
        return self.device is not None

    def _host_chunks(self, ids):
        """Host-codec encodes of chunks ``ids`` that the device route
        leaves to the host, counted in the pipeline's
        ``host_encoded_chunks``; returns idx -> (raw, payload)."""
        pipeline.host_encoded_chunks += len(ids)
        if self.n_threads > 1 and self._pool is not None:
            return dict(self._pool.map(self._compress_chunk, ids))
        return dict(self._compress_chunk(i) for i in ids)

    def _compress_batch_device(self, ids, chunks):
        """Device-encode one equal-shape batch; returns idx -> (raw,
        payload).

        Adaptive writers split the batch into uniform-transform window
        runs; each run encodes as its own device batch with the
        window's transform and the bit5 stamp (byte-identical to the
        host path's containers). Runs shorter than
        ``MIN_DEVICE_SUBBATCH``, batches that ``supported()`` declines
        and runs that ``encode_batch`` declines go to the host codec;
        runs already encoded on the device are kept (the JAX package
        re-encodes the whole batch on the host when a later run
        declines: the same bytes, twice the work).
        """
        ids = list(ids)
        # supported() is transform-independent (dtype/geometry only):
        # checked BEFORE any window probes run.
        if not DeviceBatchEncoder(self, device=self.device).supported(
                chunks[0].shape[0]):
            return self._host_chunks(ids)
        if self.transform_adapt:
            runs = []
            for j, i in enumerate(ids):
                tr = self._chunk_transform(i)
                if runs and runs[-1][0] == tr:
                    runs[-1][1].append(j)
                else:
                    runs.append((tr, [j]))
        else:
            runs = [(None, list(range(len(ids))))]
        out, rest = {}, []
        for tr, js in runs:
            if tr is not None and len(js) < MIN_DEVICE_SUBBATCH:
                rest.extend(ids[j] for j in js)
                continue
            payloads = DeviceBatchEncoder(
                self, transform=tr, device=self.device).encode_batch(
                    np.stack([np.asarray(chunks[j]) for j in js]))
            if payloads is None:
                rest.extend(ids[j] for j in js)
                continue
            for j, p in zip(js, payloads):
                out[ids[j]] = (chunks[j], p)
        if rest:
            out.update(self._host_chunks(rest))
        return out

    def compress_batch(self, first_chunk, last_chunk):
        """Compress chunks ``[first_chunk, last_chunk)``; returns idx->result.

        On the device route, each run of consecutive equal-shape chunks
        (a file's shorter last chunk is a run of its own) encodes as
        one device batch.
        """
        assert 0 <= first_chunk < last_chunk <= self.n_chunks
        ids = range(first_chunk, last_chunk)
        if self._use_device():
            runs = []
            for i in ids:
                chunk = self.get_chunk(i)
                if runs and runs[-1][1][0].shape == chunk.shape:
                    runs[-1][0].append(i)
                    runs[-1][1].append(chunk)
                else:
                    runs.append(([i], [chunk]))
            out = {}
            for run_ids, chunks in runs:
                out.update(self._compress_batch_device(run_ids, chunks))
            return out
        if hasattr(self.codec, 'encode_batch'):
            # Native batch path: one FFI call deflates the whole batch with
            # C++ worker threads (no Python thread pool in the hot loop).
            chunks = [self.get_chunk(i) for i in ids]
            chunkds = [self._transform_chunk(c) for c in chunks]
            payloads = self.codec.encode_batch(
                chunkds, order=self.chunk_order, n_threads=self.n_threads)
            return {i: (c, p) for i, c, p in zip(ids, chunks, payloads)}
        if self.n_threads == 1 or self._pool is None:
            results = [self._compress_chunk(i) for i in ids]
        else:
            results = list(self._pool.map(self._compress_chunk, ids))
        return dict(results)

    # -- output ---------------------------------------------------------------

    def write(self, out, outmeta, first_chunk=0, last_chunk=None):
        """Write ``.cbin`` + ``.ch``; returns compressed/raw size ratio.

        With ``first_chunk``/``last_chunk`` only chunks
        ``[first_chunk, last_chunk)`` are written — the output is a
        fully valid standalone file of that sample range (rebased
        chunk_bounds, its own offset table and SHA1s) whose sidecar
        records ``part: [first, last]``. Ranges are the multi-host
        parallelism unit (each host compresses a disjoint range over
        DCN-shared storage; chunks are independent so no communication
        is needed) and the crash-resume unit.
        """
        first_chunk = int(first_chunk)
        last_chunk = self.n_chunks if last_chunk is None else int(last_chunk)
        if not 0 <= first_chunk < last_chunk <= self.n_chunks:
            raise ValueError(
                "Invalid chunk range [%d, %d): the file has %d chunks."
                % (first_chunk, last_chunk, self.n_chunks))
        partial = (first_chunk, last_chunk) != (0, self.n_chunks)
        n_range = last_chunk - first_chunk
        n_batches = math.ceil(n_range / self.batch_size)
        out, outmeta = default_compressed_paths(self.data_path, out, outmeta)
        Path(out).parent.mkdir(exist_ok=True, parents=True)
        offset = 0
        self.chunk_offsets = [0]
        self._part = (first_chunk, last_chunk) if partial else None
        self._pool = (ThreadPoolExecutor(self.batch_size)
                      if self.n_threads > 1 else None)
        logger.info("Starting compression with %d thread(s), algorithm=%s.",
                    self.n_threads, self.algorithm)

        def bounds(batch):
            return (first_chunk + self.batch_size * batch,
                    min(first_chunk + self.batch_size * (batch + 1),
                        last_chunk))

        # Double-buffered pipeline: batch b+1 compresses (C++ workers /
        # device) while batch b's ordered write-back (file IO) runs —
        # the reference is strictly batch-synchronous here
        # (mtscomp.py:461-483). The two SHA1 streams hash on their own
        # threads (hashlib releases the GIL above 2 KB): each stream is
        # inherently serial at ~1 GB/s, so on multi-core hosts keeping
        # them off the write-back thread removes them from the critical
        # path. One in-flight task per stream, joined before the next
        # batch submits, preserves update order and bounds the payload
        # backlog to two batches.
        self.sha1_compressed = hashlib.sha1()
        self.sha1_uncompressed = hashlib.sha1()
        prefetch = ThreadPoolExecutor(1)
        hasher = ThreadPoolExecutor(2)

        def _update_all(sha, bufs):
            for b in bufs:
                sha.update(b)

        hash_pending = []
        try:
            with open(out, 'wb') as fb:
                fut = (prefetch.submit(self.compress_batch, *bounds(0))
                       if n_batches else None)
                for batch in progress(range(n_batches),
                                      desc='Compressing',
                                      disable=self.quiet):
                    compressed = fut.result()
                    if batch + 1 < n_batches:
                        fut = prefetch.submit(self.compress_batch,
                                              *bounds(batch + 1))
                    first, last = bounds(batch)
                    assert set(compressed) == set(range(first, last))
                    # Ordered write-back: payload order defines the
                    # offset table.
                    raws, payloads = [], []
                    for idx in sorted(compressed):
                        chunk, payload = compressed[idx]
                        parts = (payload if isinstance(payload, list)
                                 else (payload,))
                        for part in parts:
                            fb.write(part)
                            offset += len(part)
                            # Hash the parts in byte order (identical
                            # digest to hashing the joined container).
                            payloads.append(part)
                        self.chunk_offsets.append(offset)
                        # Contiguous memmap slices hash zero-copy.
                        raws.append(np.ascontiguousarray(chunk))
                    for f in hash_pending:
                        f.result()
                    hash_pending = [
                        hasher.submit(_update_all, self.sha1_uncompressed,
                                      raws),
                        hasher.submit(_update_all, self.sha1_compressed,
                                      payloads),
                    ]
                for f in hash_pending:
                    f.result()
                hash_pending = []
                csize = fb.tell()
        finally:
            for f in hash_pending:  # pragma: no cover - error path
                f.cancel()
            prefetch.shutdown()
            hasher.shutdown()
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None
        assert self.chunk_offsets[-1] == csize
        i0 = self.chunk_bounds[first_chunk]
        i1 = self.chunk_bounds[last_chunk]
        raw_size = (i1 - i0) * self.n_channels * self.dtype.itemsize
        ratio = csize / raw_size
        logger.info("Wrote %s (%.1f GB, -%.3f%%).", out, csize / 1024 ** 3,
                    100 - 100 * ratio)
        write_cmeta(outmeta, self.get_cmeta())
        if self.check_after_compress:
            self.before_check(self)
            try:
                check(self.data[i0:i1], out, outmeta)
            except AssertionError:
                raise RuntimeError(CRITICAL_ERROR_MSG)
            logger.debug("Automatic integrity check after compression PASSED.")
        return ratio

    def get_cmeta(self):
        """The ``.ch`` sidecar dictionary."""
        extra = {}
        if self.algorithm == 'ans':
            extra['ans_seg_log2'] = self.codec.seg_log2
            if self.codec.table_mode != 'plane':
                extra['ans_table_mode'] = self.codec.table_mode
            if self.float_bitcast:
                extra['float_bitcast'] = True
            if self.do_time_diff and self.time_diff_order == 2:
                # Sidecar extension (same pattern as float_bitcast):
                # readers apply the inverse time cumsum twice. Absent
                # key = order 1 (every pre-existing file).
                extra['time_diff_order'] = 2
            if self.transform_adapt:
                # Informational + resume state (the writer setting and
                # its probe grid); decoding NEVER depends on these —
                # every adaptive chunk self-describes via the
                # container's flags bit5, so the keys are deliberately
                # NOT decode-identity (mixing adaptive and static
                # chunks/parts is safe).
                extra['transform_adapt'] = int(self.transform_adapt)
                extra['transform_adapt_grid'] = [
                    list(self._adapt_orders),
                    [bool(s) for s in self._adapt_spatials]]
        part = getattr(self, '_part', None)
        bounds = self.chunk_bounds
        shape = self.shape
        if part is not None:
            # Ranged write: rebase sample bounds to the part's origin so
            # the part is a standalone valid file; record provenance.
            first, last = part
            base = self.chunk_bounds[first]
            bounds = [b - base for b in self.chunk_bounds[first:last + 1]]
            # A part is always 2-D (an original >=3-D .npy shape cannot
            # be restored from a sample sub-range).
            shape = (bounds[-1], self.n_channels)
            extra['part'] = [first, last]
            # Total chunk count of the source: lets merge_parts require
            # full coverage (a missing tail part must not merge into a
            # sidecar indistinguishable from a complete recording).
            extra['part_of'] = self.n_chunks
        return build_cmeta(
            algorithm=self.algorithm, comp_level=self.comp_level,
            do_time_diff=self.do_time_diff,
            do_spatial_diff=self.do_spatial_diff,
            dtype=self.dtype, n_channels=self.n_channels,
            sample_rate=self.sample_rate, chunk_bounds=bounds,
            chunk_offsets=self.chunk_offsets, chunk_order=self.chunk_order,
            sha1_compressed=self.sha1_compressed.hexdigest(),
            sha1_uncompressed=self.sha1_uncompressed.hexdigest(),
            shape=shape, extra=extra)

    def close(self):
        """Release the input memmap."""
        if self.data is not None and hasattr(self.data, '_mmap'):
            self.data._mmap.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Reader:
    """Random-access reader over a compressed ``.cbin`` + ``.ch`` pair.

    Implements the NumPy array protocol subset of the reference
    (mtscomp.py:798-856): slices with positive steps, (row, col) tuples,
    scalar ints (negatives wrap), clipping out-of-range slice bounds.
    Decoded chunks are LRU-cached per instance.

    Bulk decodes of ans files (``to_array``, ``tofile``) run the port's
    batched decode on ``device`` (the ``device`` key: ``'cuda'``, or
    ``'cpu'`` for the plain twins; ``'none'`` keeps them on the host
    codec), and ``to_tensor`` returns decoded samples on the device.
    """

    def __init__(self, **kwargs):
        self.pool = None
        self.cdata = None
        self.quiet = kwargs.pop('quiet', False)
        self.config = read_config(**kwargs)
        self.cache_size = self.config.cache_size
        self.check_after_decompress = self.config.check_after_decompress
        #: Set by :meth:`open`, once the file's algorithm is known.
        self.device = None
        self._chunk_decode_threads = max(1, int(self.config.n_threads))

    def open(self, cdata, cmeta=None):
        """Open the compressed file and parse its sidecar."""
        if cmeta is None:
            cmeta = cmeta_sidecar_path(cdata)
        self.cmeta = read_cmeta(cmeta)
        self.n_channels = self.cmeta.n_channels
        self.sample_rate = self.cmeta.sample_rate
        self.dtype = np.dtype(self.cmeta.dtype)
        self.chunk_offsets = self.cmeta.chunk_offsets
        self.chunk_bounds = self.cmeta.chunk_bounds
        self.chunk_order = self.cmeta.get('chunk_order', 'F')
        self.algorithm = self.cmeta.get('algorithm', 'zlib')
        # Only ans files decode on a device: a zlib file opens and decodes
        # on a host without a GPU whatever the configured device is, as it
        # compresses there (Writer).
        self.device = configured_device(self.config.device) \
            if self.algorithm == 'ans' else None
        # Sidecar flag written by v2 float compressions: chunk payloads
        # hold the same-width integer view of the IEEE bit patterns
        # (exact modular transform). Only meaningful for float dtypes;
        # absent on v1 files and on v2 files written before the flag
        # existed (those decode float-domain).
        self.float_bitcast = (bool(self.cmeta.get('float_bitcast', False))
                              and self.dtype.kind == 'f')
        self.code_dtype = (np.dtype('int%d' % (self.dtype.itemsize * 8))
                           if self.float_bitcast else self.dtype)
        # Sidecar extension (v2): second-order time prediction — the
        # inverse applies the modular cumsum twice. Absent key = 1.
        self.time_diff_order = int(self.cmeta.get('time_diff_order', 1))
        # Informational: the writer's adaptive-window setting. Decoding
        # does NOT consult it — per-chunk transforms ride the payload
        # header (flags bit5), which every inverse site peeks.
        self.transform_adapt = int(self.cmeta.get('transform_adapt', 0)
                                   or 0)
        self.codec = get_codec(self.algorithm,
                               seg_log2=self.cmeta.get('ans_seg_log2', 16))
        self.n_samples = self.chunk_bounds[-1]
        self.n_chunks = len(self.chunk_bounds) - 1
        self.shape = (self.n_samples, self.n_channels)
        self.ndim = 2
        self.batch_size = max(1, int(self.config.n_threads))
        self.n_batches = math.ceil(self.n_chunks / self.batch_size)
        self._owns_fd = isinstance(cdata, (str, Path))
        if self._owns_fd:
            if Path(cdata).suffix in ('.bin', '.dat'):  # pragma: no cover
                logger.error("File to decompress has unexpected extension %s.",
                             Path(cdata).suffix)
            cdata = open(cdata, 'rb')
        self.cdata = cdata
        self.set_cache_size()

    def set_cache_size(self, cache_size=None):
        """(Re)wrap ``read_chunk`` with a fresh LRU cache."""
        if cache_size != self.cache_size or not hasattr(self.read_chunk,
                                                        'cache_info'):
            cache_size = cache_size or self.cache_size
            assert cache_size > 0
            self.read_chunk = lru_cache(maxsize=cache_size)(
                Reader.read_chunk.__get__(self))
            self.cache_size = cache_size

    # -- chunk access ---------------------------------------------------------

    def iter_chunks(self, first_chunk=0, last_chunk=None):
        """Yield ``(chunk_idx, byte_start, byte_length)`` tuples."""
        last_chunk = self.n_chunks - 1 if last_chunk is None else last_chunk
        for idx in range(first_chunk, last_chunk + 1):
            i0, i1 = self.chunk_offsets[idx], self.chunk_offsets[idx + 1]
            yield idx, i0, i1 - i0

    def read_chunk(self, chunk_idx, chunk_start, chunk_length):
        """Read + entropy-decode + inverse-transform one chunk."""
        cbuffer = pread_exact(self.cdata, chunk_length, chunk_start)
        i0, i1 = self.chunk_bounds[chunk_idx:chunk_idx + 2]
        ns = i1 - i0
        try:
            # Random access decodes one chunk at a time, so the native
            # decoder may thread across the chunk's GROUPS; pooled bulk
            # paths set _chunk_decode_threads to 1 (they already run
            # one chunk per pool worker).
            chunkd = self.codec.decode(cbuffer, ns, self.n_channels,
                                       self.code_dtype, order=self.chunk_order,
                                       n_threads=self._chunk_decode_threads)
        except IOError:
            raise
        except Exception:
            raise IOError("Compressed chunk #%d is corrupted." % chunk_idx)
        # inplace: codec.decode output is a private buffer (or a
        # read-only view, which the helper detects and copies).
        chunki = self._inverse_transform(chunkd, cbuffer)
        assert chunki.dtype == self.code_dtype
        assert chunki.shape == (ns, self.n_channels)
        chunki = np.ascontiguousarray(chunki)
        # Bitcast files: the inverse transform ran in integer space;
        # reinterpret (zero-copy) back to the user dtype.
        return chunki.view(self.dtype) if self.float_bitcast else chunki

    def _inverse_time(self, chunki):
        """Inverse time transform: the in-dtype modular cumsum, applied
        ``time_diff_order`` times (in place where the buffer allows)."""
        if not self.cmeta.do_time_diff:
            return chunki
        chunki = cumsum_along_axis(chunki, axis=0, inplace=True)
        if self.time_diff_order == 2:
            chunki = cumsum_along_axis(chunki, axis=0, inplace=True)
        return chunki

    def _payload_transform(self, cbuffer):
        """Per-chunk transform descriptor from the container header
        (flags bit5), or None for static chunks. Honored over the
        sidecar so adaptive chunks decode correctly everywhere — even
        in merged files whose sidecar predates/ignores adaptation."""
        if self.algorithm != 'ans':
            return None
        from .codec.ans import peek_transform
        return peek_transform(cbuffer)

    def _inverse_transform(self, chunkd, cbuffer):
        """Spatial cumsum then time cumsum(s), per this chunk's
        effective transform (payload descriptor or sidecar global)."""
        desc = self._payload_transform(cbuffer)
        if desc is None:
            chunki = cumsum_along_axis(
                chunkd, axis=1 if self.cmeta.do_spatial_diff else None)
            return self._inverse_time(chunki)
        t_order, t_spatial = desc
        chunki = cumsum_along_axis(chunkd, axis=1 if t_spatial else None)
        for _ in range(t_order):
            chunki = cumsum_along_axis(chunki, axis=0, inplace=True)
        return chunki

    def _decompress_chunk(self, chunk_idx):
        assert 0 <= chunk_idx < self.n_chunks
        start = self.chunk_offsets[chunk_idx]
        length = self.chunk_offsets[chunk_idx + 1] - start
        return chunk_idx, self.read_chunk(chunk_idx, start, length)

    def read_chunk_channels(self, chunk_idx, cols):
        """Decode only ``cols`` (sorted unique channel indices) of one
        chunk — the entropy stage runs only for the rANS groups whose
        channel-aligned segments cover those columns (the reference
        must always inflate whole chunks). Returns ``(ns, len(cols))``
        or ``None`` when unsupported (non-ans, spatial diff couples
        channels, non-aligned container): callers fall back to the
        full-chunk path. Bypasses the LRU cache (partial results would
        poison full-chunk entries).
        """
        if (self.algorithm != 'ans' or self.cmeta.do_spatial_diff
                or not hasattr(self.codec, 'decode_channels')):
            return None
        start = self.chunk_offsets[chunk_idx]
        length = self.chunk_offsets[chunk_idx + 1] - start
        cbuffer = pread_exact(self.cdata, length, start)
        desc = self._payload_transform(cbuffer)
        if desc is not None and desc[1]:
            # This chunk was adaptively spatial-diffed: columns are
            # coupled, full-chunk fallback.
            return None
        i0, i1 = self.chunk_bounds[chunk_idx:chunk_idx + 2]
        ns = i1 - i0
        try:
            part = self.codec.decode_channels(
                cbuffer, ns, self.n_channels, self.code_dtype, cols,
                n_threads=self._chunk_decode_threads)
        except IOError:
            raise
        except Exception:
            raise IOError("Compressed chunk #%d is corrupted." % chunk_idx)
        if part is None:
            return None
        # Columns are independent under the time diff: the per-column
        # modular cumsum is the exact inverse restricted to ``cols``.
        if desc is not None:
            for _ in range(desc[0]):
                part = cumsum_along_axis(part, axis=0, inplace=True)
        else:
            part = self._inverse_time(part)
        return part.view(self.dtype) if self.float_bitcast else part

    def decompress_chunks(self, chunk_ids, pool=None):
        """Decode several chunks (optionally on a thread pool)."""
        if pool is None:
            out = dict(self._decompress_chunk(i) for i in chunk_ids)
        else:
            out = dict(pool.map(self._decompress_chunk, chunk_ids))
        assert set(out) == set(chunk_ids)
        return out

    def _decompress_chunks_batch(self, chunk_ids, outs=None):
        """Bulk decode path: native batch inflate + vectorized inverse.

        Bypasses the LRU cache (bulk reads would only thrash it) and the
        Python thread pool (the batch loop runs in C++ workers).
        ``outs`` maps chunk id -> destination array: matching chunks are
        decoded and inverse-transformed in place there (the bulk slice
        path passes views of one span-wide array); results may still be
        fresh arrays when a fallback path declines, so callers check
        identity.
        """
        chunk_ids = list(chunk_ids)
        payloads = [pread_exact(self.cdata,
                                self.chunk_offsets[i + 1] - self.chunk_offsets[i],
                                self.chunk_offsets[i])
                    for i in chunk_ids]
        shapes = [(self.chunk_bounds[i + 1] - self.chunk_bounds[i],
                   self.n_channels) for i in chunk_ids]
        # Bitcast files decode + inverse-transform in integer space; the
        # codec then writes into integer views of the caller's float
        # destinations (same memory).
        outs_c = outs
        if outs and self.float_bitcast:
            outs_c = {i: (o.view(self.code_dtype) if o is not None else None)
                      for i, o in outs.items()}
        try:
            chunkds = self.codec.decode_batch(
                payloads, shapes, self.code_dtype, order=self.chunk_order,
                n_threads=self.batch_size,
                outs=[outs_c.get(i) for i in chunk_ids] if outs else None)
        except IOError:
            raise
        except Exception:
            raise IOError("A compressed chunk in %s..%s is corrupted."
                          % (chunk_ids[0], chunk_ids[-1]))
        out = {}
        for i, chunkd, payload in zip(chunk_ids, chunkds, payloads):
            chunki = self._inverse_transform(chunkd, payload)
            chunki = np.ascontiguousarray(chunki)
            if self.float_bitcast:
                # Keep the caller's in-place identity contract: when the
                # whole pipeline ran inside the caller's buffer, hand
                # back the caller's own float view object.
                if outs and outs.get(i) is not None and chunki is outs_c[i]:
                    chunki = outs[i]
                else:
                    chunki = chunki.view(self.dtype)
            out[i] = chunki
        return out

    def bounded_batch_size(self):
        """Batch size for loops that hold a whole decoded batch at once,
        bounded by bytes (256 MB of decoded chunks) as well as by
        worker count — ``batch_size`` follows cpu_count, and on
        many-core hosts with ~23 MB Neuropixels chunks an unbounded
        batch would stage multi-GB transients."""
        chunk_bytes = max(
            int(np.max(np.diff(self.chunk_bounds))) * self.n_channels
            * self.dtype.itemsize, 1)
        return max(1, min(self.batch_size, (1 << 28) // chunk_bytes))

    def _read_span_bulk(self, first_chunk, last_chunk):
        """Decode a multi-chunk span straight into one fresh array.

        Slice reads wider than the LRU capacity (and at least
        ``_BULK_SPAN_CHUNKS`` chunks) skip the chunk cache — they could
        only thrash it — and hand the whole span to the codec's batch
        decoder with per-chunk destination views of the result, so the
        native workers parallelize across chunks and the per-chunk
        concatenate copy of the cached path disappears.
        """
        n0 = self.chunk_bounds[first_chunk]
        arr = np.empty((self.chunk_bounds[last_chunk + 1] - n0,
                        self.n_channels), dtype=self.dtype)
        views = {i: arr[self.chunk_bounds[i] - n0:
                        self.chunk_bounds[i + 1] - n0]
                 for i in range(first_chunk, last_chunk + 1)}
        decoded = self._decompress_chunks_batch(list(views), outs=views)
        for i, res in decoded.items():
            if res is not views[i]:
                views[i][...] = res
        return arr

    # -- index machinery --------------------------------------------------------

    def _validate_index(self, i, value_for_none=0):
        if i is None:
            i = value_for_none
        elif i < 0:
            i += self.n_samples
        i = clip(i, 0, self.n_samples)
        assert 0 <= i <= self.n_samples
        return int(i)

    def _chunks_for_interval(self, i0, i1):
        """First and last chunk indices covering samples ``[i0, i1]``."""
        i0 = clip(i0, 0, self.n_samples - 1)
        i1 = clip(i1, i0, self.n_samples - 1)
        first_chunk = clip(bisect.bisect_right(self.chunk_bounds, i0) - 1,
                           0, self.n_chunks - 1)
        assert self.chunk_bounds[first_chunk] <= i0 < self.chunk_bounds[first_chunk + 1]
        last_chunk = clip(
            bisect.bisect_right(self.chunk_bounds, i1, lo=first_chunk) - 1,
            0, self.n_chunks - 1)
        assert self.chunk_bounds[last_chunk] <= i1 <= self.chunk_bounds[last_chunk + 1]
        assert 0 <= first_chunk <= last_chunk <= self.n_chunks - 1
        return first_chunk, last_chunk

    # -- bulk paths ---------------------------------------------------------------

    def start_thread_pool(self):
        if self.pool is None:
            self.pool = ThreadPoolExecutor(self.batch_size)
            self._chunk_decode_threads = 1
        return self.pool

    def stop_thread_pool(self):
        if self.pool is not None:
            self.pool.shutdown()
            self.pool = None
            self._chunk_decode_threads = max(1, int(self.config.n_threads))

    def _use_device(self):
        """Whether bulk decodes go through the port's batched decode:
        ans files, unless ``device='none'``."""
        return self.algorithm == 'ans' and self.device is not None

    def _column_window(self, rows, cols):
        """``r[rows, cols]`` via column-restricted decode (None = fall
        back to the materialize-then-slice path).

        Engaged when few channels are selected (<= 1/4 of the probe):
        the entropy stage then only decodes the groups covering them —
        plotting a handful of channels of a 385-channel recording stops
        paying for the other ~380. Any input the fast path does not
        replicate bit-for-bit (negative steps, out-of-range indices,
        bool masks, unsupported containers) falls back, so indexing
        semantics — including exceptions — stay identical to NumPy's.
        """
        if not isinstance(rows, slice) or (rows.step or 1) <= 0:
            return None
        C = self.n_channels
        scalar_col = isinstance(cols, (int, np.integer)) \
            and not isinstance(cols, bool)
        if scalar_col:
            c = int(cols)
            if not -C <= c < C:
                return None      # generic path raises numpy's IndexError
            sel = np.array([c % C], dtype=np.int64)
        elif isinstance(cols, slice):
            sel = np.arange(*cols.indices(C), dtype=np.int64)
        elif isinstance(cols, (list, np.ndarray)):
            sel = np.asarray(cols)
            if sel.ndim != 1 or sel.size == 0 or sel.dtype.kind not in 'iu':
                return None      # bool masks / empty / nd: generic path
            sel = sel.astype(np.int64)
            if ((sel < -C) | (sel >= C)).any():
                return None      # generic path raises numpy's IndexError
            sel = np.where(sel < 0, sel + C, sel)
        else:
            return None
        uniq = np.unique(sel)
        if uniq.size == 0 or uniq.size > C // 4:
            return None          # wide selections: full decode is faster
        i0 = self._validate_index(rows.start, 0)
        i1 = self._validate_index(rows.stop, self.n_samples)
        if i1 <= i0:
            return None
        first_chunk, last_chunk = self._chunks_for_interval(i0, i1)
        parts = []
        for idx in range(first_chunk, last_chunk + 1):
            part = self.read_chunk_channels(idx, uniq)
            if part is None:
                return None      # unsupported container for this file
            parts.append(part)
        arr = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        a = i0 - self.chunk_bounds[first_chunk]
        out = arr[a:a + (i1 - i0):rows.step]
        assert out.shape[0] == len(range(i0, i1, rows.step or 1))
        if scalar_col:
            return np.ascontiguousarray(out[:, 0])
        if uniq.size == sel.size and np.array_equal(uniq, sel):
            return np.ascontiguousarray(out)
        # Restore the caller's order/duplicates (numpy fancy-index
        # semantics); searchsorted maps each requested col to its
        # position in the decoded unique set.
        return out[:, np.searchsorted(uniq, sel)]

    def to_array(self, first_chunk=0, last_chunk=None, writable=True):
        """Bulk-decode chunks [first, last] into one ndarray.

        Ans files decode through the port's batched decode on the
        reader's device (:func:`~.parallel.pipeline.decompress_to_array`),
        other files, and ``device='none'``, on the host codec.
        ``writable=False`` lets read-only consumers (``tofile``) take the
        device route's fetched buffer as it comes, with no copy.
        """
        last_chunk = self.n_chunks - 1 if last_chunk is None else last_chunk
        if self._use_device():
            return decompress_to_array(self, first_chunk, last_chunk,
                                       writable=writable, device=self.device)
        ids = range(first_chunk, last_chunk + 1)
        if hasattr(self.codec, 'decode_batch'):
            # Native batch decode (and no LRU traffic — bulk reads
            # would only thrash the random-access cache). Both built-in
            # codecs provide decode_batch; the per-chunk branch below
            # is the contract for codecs that don't.
            decoded = self._decompress_chunks_batch(ids)
        else:
            decoded = dict(self._decompress_chunk(i) for i in ids)
        return np.concatenate([decoded[i] for i in ids], axis=0)

    def to_tensor(self, first_chunk=0, last_chunk=None):
        """Chunks [first, last] as one (n, C) tensor on the reader's
        device, in the reader's dtype; nothing is copied to the host."""
        # A zlib file's reader holds no device: resolve it now.
        device = self.device if self.algorithm == 'ans' \
            else configured_device(self.config.device)
        if device is None:
            raise ValueError("to_tensor needs a device ('cuda' or 'cpu'); "
                             "this reader's configuration gives none "
                             "(device=%r)." % self.config.device)
        return decompress_to_tensor(self, first_chunk, last_chunk,
                                    device=device)

    def tofile(self, out, overwrite=False):
        """Decompress everything to a flat binary file (batched, threaded)."""
        if out is None:
            out = Path(self.cdata.name).with_suffix('.bin')
        out = Path(out)
        if out.exists():
            if not overwrite:
                raise ValueError(
                    "The output file %s already exists, use --overwrite or "
                    "specify another output path." % out)
            out.unlink()
        use_device = self._use_device()
        # The device pipeline amortizes per-batch overhead over bigger
        # chunk batches than the CPU thread pool would use; an explicit
        # config.batch_chunks is honored as-is (it bounds staged device
        # memory), 0 = auto.
        batch_size = self.batch_size
        if use_device:
            batch_size = int(self.config.batch_chunks) \
                or max(batch_size, 8)
        n_batches = math.ceil(self.n_chunks / batch_size)
        self.start_thread_pool()

        def produce(batch):
            """Decoded arrays of one batch, in chunk order."""
            first = batch_size * batch
            last = min(batch_size * (batch + 1), self.n_chunks)
            if use_device:
                return [self.to_array(first, last - 1, writable=False)]
            if hasattr(self.codec, 'decode_batch'):
                decoded = self._decompress_chunks_batch(range(first, last))
            else:
                decoded = self.decompress_chunks(range(first, last),
                                                 self.pool)
            return [decoded[i] for i in sorted(decoded)]

        # Double-buffered pipeline: batch b+1 reads + decodes while
        # batch b's file write runs (the reference is strictly
        # batch-synchronous, mtscomp.py:720-734).
        prefetch = ThreadPoolExecutor(1)
        try:
            with open(out, 'wb') as fb:
                fut = prefetch.submit(produce, 0) if n_batches else None
                for batch in progress(range(n_batches),
                                      desc='Decompressing',
                                      disable=self.quiet):
                    arrays = fut.result()
                    if batch + 1 < n_batches:
                        fut = prefetch.submit(produce, batch + 1)
                    for arr in arrays:
                        fb.write(np.ascontiguousarray(arr))
                dsize = fb.tell()
        finally:
            prefetch.shutdown()
            self.stop_thread_pool()
        assert dsize == self.n_samples * self.n_channels * self.dtype.itemsize
        logger.info("Wrote %s (%.1f GB).", out, dsize / 1024 ** 3)
        if self.check_after_decompress:
            decompressed = load_raw_data(out, n_channels=self.n_channels,
                                         dtype=self.dtype)
            check(decompressed, self.cdata, self.cmeta)
            logger.debug("Automatic integrity check after decompression PASSED.")

    def chop(self, n_chunks, out=None):
        """Truncate to the first ``n_chunks`` chunks without decompressing.

        Byte-copies the payload prefix and rewrites the sidecar with
        truncated tables, nulled SHA1s and ``chopped=True`` (reference:
        mtscomp.py:750-796).
        """
        # Real exceptions, not asserts: user input must stay validated
        # under ``python -O``.
        n_chunks = int(n_chunks)
        if n_chunks <= 0:
            raise ValueError(
                "The number of chunks to keep must be positive (got %d)."
                % n_chunks)
        if n_chunks >= self.n_chunks:  # pragma: no cover
            logger.warning("Cannot chop more chunks than the file contains.")
            return
        if out is None:
            raise ValueError("The output path must be specified.")
        out = Path(out)
        if out.suffix != '.cbin':
            raise ValueError(
                "The output path must end in .cbin (got %s)." % out)
        if out.exists():  # pragma: no cover
            raise IOError("File %s already exists." % out)
        out.parent.mkdir(exist_ok=True, parents=True)
        with open(out, 'wb') as f:
            offset = 0
            for i in range(n_chunks):
                length = self.chunk_offsets[i + 1] - self.chunk_offsets[i]
                f.write(pread_exact(self.cdata, length, offset))
                offset += length
        outmeta = out.with_suffix('.ch')
        if outmeta.exists():  # pragma: no cover
            raise IOError("File %s already exists." % outmeta)
        cmeta = Bunch(self.cmeta.copy())
        cmeta['chunk_bounds'] = cmeta['chunk_bounds'][:n_chunks + 1]
        cmeta['chunk_offsets'] = cmeta['chunk_offsets'][:n_chunks + 1]
        assert cmeta['chunk_offsets'][-1] == offset
        cmeta['sha1_compressed'] = None
        cmeta['sha1_uncompressed'] = None
        cmeta['chopped'] = True
        # A chopped file no longer covers the range its part provenance
        # claims — keeping part/part_of would let merge_parts accept a
        # silently truncated 'complete' set. A chop of a live snapshot
        # is likewise a complete standalone file, not an in-progress
        # stream.
        cmeta.pop('part', None)
        cmeta.pop('part_of', None)
        cmeta.pop('streaming', None)
        write_cmeta(outmeta, cmeta)

    # -- NumPy protocol -----------------------------------------------------------

    def __getitem__(self, item):
        fallback = np.zeros((0, self.n_channels), dtype=self.dtype)
        if isinstance(item, slice):
            i0 = self._validate_index(item.start, 0)
            i1 = self._validate_index(item.stop, self.n_samples)
            if i1 <= i0:
                return fallback
            first_chunk, last_chunk = self._chunks_for_interval(i0, i1)
            single = None
            n_span = last_chunk - first_chunk + 1
            if (n_span >= _BULK_SPAN_CHUNKS and n_span > self.cache_size
                    and hasattr(self.codec, 'decode_batch')):
                # Wide spans: batch-decode into one array (no LRU, no
                # per-chunk concat copy; C++ workers span the chunks).
                arr = self._read_span_bulk(first_chunk, last_chunk)
            else:
                chunks = [self.read_chunk(idx, start, length)
                          for idx, start, length
                          in self.iter_chunks(first_chunk, last_chunk)]
                single = chunks[0] if len(chunks) == 1 else None
                arr = (np.concatenate(chunks, axis=0)
                       if len(chunks) > 1 else chunks[0])
            assert arr.shape[0] == (self.chunk_bounds[last_chunk + 1]
                                    - self.chunk_bounds[first_chunk])
            a = i0 - self.chunk_bounds[first_chunk]
            b = i1 - self.chunk_bounds[first_chunk]
            assert 0 <= a <= b <= arr.shape[0]
            out = arr[a:b:item.step, :]
            assert out.shape[0] == len(range(i0, i1, item.step or 1))
            if single is not None:
                # Never hand out views of LRU-cached chunks: the
                # reference always returns fresh arrays (concatenate
                # with out=, mtscomp.py:815-819), so results must stay
                # safely writable by callers.
                out = out.copy()
            return out
        elif isinstance(item, tuple):
            if len(item) == 1:
                return self[item[0]]
            elif len(item) == 2 and np.isscalar(item[0]):
                return self[item[0]][item[1]]
            elif len(item) == 2:
                win = self._column_window(item[0], item[1])
                if win is not None:
                    return win
                return self[item[0]][:, item[1]]
        elif isinstance(item, (int, np.integer)):
            item = int(item)
            if item < 0:
                k = -int(math.floor(item / self.n_samples))
                item += self.n_samples * k
            if not 0 <= item < self.n_samples:
                raise IndexError(
                    "index %d is out of bounds for axis 0 with size %d"
                    % (item, self.n_samples))
            return self[item:item + 1][0]
        elif isinstance(item, (list, np.ndarray)):
            raise NotImplementedError(
                "Indexing with multiple values is currently unsupported.")
        return fallback  # pragma: no cover

    def __array__(self, dtype=None, copy=None):
        """NumPy protocol: ``np.asarray(reader)`` materializes the full
        recording (beyond-reference convenience; the reference Reader
        exposes only shape/ndim/dtype/__getitem__)."""
        arr = self[:]
        if dtype is not None and arr.dtype != np.dtype(dtype):
            arr = arr.astype(dtype)
        return arr

    def close(self):
        # Only close handles we opened ourselves: a Reader may be given an
        # already-open file object (e.g. by check() during tofile), and
        # closing it would break the caller.
        if self.cdata and getattr(self, '_owns_fd', True):
            self.cdata.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # pragma: no cover
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- functional API ----------------------------------------------------------------

def check(data, out, outmeta):
    """Verify that the compressed file round-trips to ``data``.

    Integer dtypes must match byte-for-byte, and so must v2 float files
    (their ``float_bitcast`` transform is exact); legacy float files
    only to within ``CHECK_ATOL`` (the in-dtype diff/cumsum of floats
    is not exactly associative).
    """
    unc = decompress(out, outmeta, device='none')

    def chunks():
        """Decoded chunks, batch-decoded when the codec supports it
        (the C++ workers then span each batch instead of the serial
        per-chunk loop — this check runs by default after every
        compress, so its speed is part of the write path)."""
        if not hasattr(unc, '_decompress_chunks_batch') \
                or not hasattr(unc.codec, 'decode_batch'):
            for chunk_idx, start, length in unc.iter_chunks():
                yield chunk_idx, unc.read_chunk(chunk_idx, start, length)
            return
        batch = unc.bounded_batch_size()
        for first in range(0, unc.n_chunks, batch):
            ids = list(range(first, min(first + batch, unc.n_chunks)))
            decoded = unc._decompress_chunks_batch(ids)
            for i in ids:
                yield i, decoded[i]

    try:
        for chunk_idx, chunk in progress(
                chunks(), total=unc.n_chunks, desc='Checking',
                disable=getattr(unc, 'quiet', False)):
            i0, i1 = unc.chunk_bounds[chunk_idx], unc.chunk_bounds[chunk_idx + 1]
            expected = data[i0:i1]
            assert chunk.dtype == expected.dtype
            assert chunk.shape == expected.shape
            if np.issubdtype(chunk.dtype, np.integer):
                assert np.array_equal(chunk, expected)
            elif getattr(unc, 'float_bitcast', False):
                # Exact float round trip: compare bit patterns (a float
                # compare would pass NaN-free corruption and fail NaNs).
                u = 'u%d' % chunk.dtype.itemsize
                assert np.array_equal(chunk.view(u),
                                      np.asarray(expected).view(u))
            else:
                assert np.allclose(chunk, expected, atol=CHECK_ATOL)
    finally:
        unc.close()


def compress(path, out=None, outmeta=None, sample_rate=None, n_channels=None,
             dtype=None, **kwargs):
    """One-call compression; returns the compressed/raw size ratio."""
    w = Writer(**kwargs)
    w.open(path, sample_rate=sample_rate, n_channels=n_channels, dtype=dtype)
    ratio = w.write(out, outmeta)
    w.close()
    return ratio


def decompress(cdata, cmeta=None, out=None, write_output=False,
               overwrite=False, **kwargs):
    """Open a compressed dataset; optionally write the decompressed file.

    Returns a :class:`Reader` supporting NumPy-style slicing.
    """
    if out:
        write_output = True
    r = Reader(**kwargs)
    r.open(cdata, cmeta)
    if write_output:
        r.tofile(out, overwrite=overwrite)
    return r
