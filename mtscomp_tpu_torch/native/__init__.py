"""First-party native (C++) runtime: chunk-parallel deflate/inflate and rANS.

The reference's hot loops run in third-party native code driven from a
Python ThreadPool (zlib via mtscomp.py:394/619). Here the batch loops
themselves are native: ``libmtsnative`` (built from ``mtsnative.cpp``)
compresses/decompresses many chunks with C++ worker threads and no GIL
round trips. Python falls back transparently when the library has not
been built (outputs are byte-identical either way — same zlib).

The library is built at first use with ``g++`` into the package's
ignored ``_build/`` directory, beside the CUDA kernels' library, under
a name keyed on a hash of the source and the flags: an edited source
rebuilds, an unchanged one reuses the last build.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

logger = logging.getLogger('mtscomp_tpu_torch')

_HERE = Path(__file__).parent
_SRC = _HERE / 'mtsnative.cpp'
_BUILD_DIR = _HERE.parent / '_build'
_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')
_lib = None
_load_attempted = False
_load_lock = threading.Lock()


def library_path():
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(' '.join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / ('libmtsnative_%s.so' % h.hexdigest()[:16])


def build_library(force=False):
    """Compile the native library with g++ (idempotent).

    Compiles to a per-process temp name and ``os.replace``s it into
    place: concurrent first-use builds (multiple processes sharing the
    checkout — e.g. hosts compressing ranges over shared storage, or
    parallel test workers) then race benignly instead of interleaving
    writes into a half-written or already-dlopen'ed .so.
    """
    path = library_path()
    if path.exists() and not force:
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / ('libmtsnative.%d.tmp.so' % os.getpid())
    # Baseline x86-64 codegen on purpose: hosts may SHARE this .so over
    # a network checkout, so it must run on the oldest CPU among them.
    # The hot kernels select wider ISAs at runtime instead (AVX-512
    # target attributes on the rANS spans, target_clones on the
    # transform passes).
    cmd = ['g++', *_FLAGS, str(_SRC), '-o', str(tmp), '-lz', '-pthread']
    logger.debug("Building native library: %s", ' '.join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, path)
    except subprocess.CalledProcessError as e:  # pragma: no cover
        # Surface the compiler's message: a silent fallback to the
        # pure-Python coder costs ~10x and is hard to diagnose.
        logger.warning("Native library build failed (falling back to "
                       "Python codecs):\n%s",
                       (e.stderr or b'').decode(errors='replace'))
        raise
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _load():
    """Load (building if needed) the native library; None on failure."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _load_lock:
        if _lib is not None or _load_attempted:  # pragma: no cover - race
            return _lib
        return _load_locked()


def _load_locked():
    global _lib, _load_attempted
    _load_attempted = True
    try:
        lib = ctypes.CDLL(str(build_library()))
    except Exception as e:  # pragma: no cover
        logger.debug("Native library unavailable (%s); using Python fallback.", e)
        return None
    # int mts_deflate_batch(int n, const uint8_t** in, const size_t* in_len,
    #                       uint8_t** out, size_t* out_cap, size_t* out_len,
    #                       int n_threads)
    lib.mts_deflate_batch.restype = ctypes.c_int
    lib.mts_deflate_batch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int]
    lib.mts_inflate_batch.restype = ctypes.c_int
    lib.mts_inflate_batch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    lib.mts_deflate_bound.restype = ctypes.c_size_t
    lib.mts_deflate_bound.argtypes = [ctypes.c_size_t]
    lib.mts_rans_encode_batch.restype = ctypes.c_int
    lib.mts_rans_encode_batch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    lib.mts_cumsum_axis0.restype = ctypes.c_int
    lib.mts_cumsum_axis0.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]
    lib.mts_prepare2_i16.restype = ctypes.c_int
    lib.mts_prepare2_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.mts_prepare2d_i16.restype = ctypes.c_int
    lib.mts_prepare2d_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.mts_hist_u8_segments.restype = ctypes.c_int
    lib.mts_hist_u8_segments.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p]
    lib.mts_quantize_freqs_batch.restype = ctypes.c_int
    lib.mts_quantize_freqs_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p]
    lib.mts_fuse2_i16.restype = ctypes.c_int
    lib.mts_fuse2_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p]
    lib.mts_rans_decode_batch.restype = ctypes.c_int
    lib.mts_rans_decode_batch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    lib.mts_crc32.restype = ctypes.c_uint32
    lib.mts_crc32.argtypes = [
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
    _lib = lib
    return _lib


def available():
    return _load() is not None


def crc32(data, crc=0):
    """zlib-compatible CRC32 (PCLMUL-folded, ~6x zlib); None if no lib.

    Accepts any contiguous buffer (bytes, memoryview, uint8 ndarray).
    Small inputs are cheaper through zlib.crc32 directly — callers
    (codec/ans.py ``_crc32``) route on size; this function is the raw
    binding.
    """
    import numpy as np
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(data, dtype=np.uint8)
    return int(lib.mts_crc32(crc & 0xFFFFFFFF, arr.ctypes.data, arr.size))


def deflate_batch(buffers, n_threads=1):
    """zlib-compress a list of byte buffers in parallel; None if no lib."""
    lib = _load()
    if lib is None or not buffers:
        return None
    n = len(buffers)
    in_ptrs = (ctypes.c_void_p * n)()
    in_lens = (ctypes.c_size_t * n)()
    out_ptrs = (ctypes.c_void_p * n)()
    out_caps = (ctypes.c_size_t * n)()
    out_lens = (ctypes.c_size_t * n)()
    outs = []
    keepalive = []
    for i, buf in enumerate(buffers):
        b = buf if isinstance(buf, bytes) else bytes(buf)
        keepalive.append(b)
        in_ptrs[i] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
        in_lens[i] = len(b)
        cap = lib.mts_deflate_bound(len(b))
        ob = ctypes.create_string_buffer(cap)
        outs.append(ob)
        out_ptrs[i] = ctypes.cast(ob, ctypes.c_void_p)
        out_caps[i] = cap
    rc = lib.mts_deflate_batch(n, in_ptrs, in_lens, out_ptrs, out_caps,
                               out_lens, int(n_threads))
    if rc != 0:  # pragma: no cover
        return None
    return [outs[i].raw[:out_lens[i]] for i in range(n)]


def inflate_batch(payloads, out_sizes, n_threads=1):
    """zlib-decompress payloads into exact-size buffers; None if no lib.

    Returns uint8 ndarrays (zero-copy views of the inflate
    destinations): ctypes string buffers would pay a memset on
    allocation plus a full ``.raw`` copy on return — two extra memory
    passes over multi-MB chunks.
    """
    import numpy as np
    lib = _load()
    if lib is None or not payloads:
        return None
    n = len(payloads)
    in_ptrs = (ctypes.c_void_p * n)()
    in_lens = (ctypes.c_size_t * n)()
    out_ptrs = (ctypes.c_void_p * n)()
    out_lens = (ctypes.c_size_t * n)()
    outs = []
    keepalive = []
    for i, (buf, size) in enumerate(zip(payloads, out_sizes)):
        b = buf if isinstance(buf, bytes) else bytes(buf)
        keepalive.append(b)
        in_ptrs[i] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
        in_lens[i] = len(b)
        ob = np.empty(size if size > 0 else 1, dtype=np.uint8)
        outs.append(ob)
        out_ptrs[i] = ctypes.c_void_p(ob.ctypes.data)
        out_lens[i] = size
    rc = lib.mts_inflate_batch(n, in_ptrs, in_lens, out_ptrs, out_lens,
                               int(n_threads))
    if rc != 0:
        return None
    return [outs[i][:out_sizes[i]] for i in range(n)]


def rans_encode_groups(groups, n_threads=1):
    """Encode rANS groups natively; None if the library is unavailable.

    ``groups``: list of (rows, freq_rows) where rows is a list of
    contiguous uint8 arrays and freq_rows a (R, 256) uint16 array.
    Returns a list of (states (R,128) uint32, words uint16).
    """
    import numpy as np
    lib = _load()
    if lib is None or not groups:
        return None
    n_rows_total = sum(len(rows) for rows, _ in groups)
    n = len(groups)
    offs = (ctypes.c_int * (n + 1))()
    row_ptrs = (ctypes.c_void_p * max(n_rows_total, 1))()
    row_counts = (ctypes.c_int * max(n_rows_total, 1))()
    row_freqs = (ctypes.c_void_p * max(n_rows_total, 1))()
    states_out = (ctypes.c_void_p * n)()
    words_out = (ctypes.c_void_p * n)()
    words_cap = (ctypes.c_size_t * n)()
    words_len = (ctypes.c_size_t * n)()
    keepalive = []
    results = []
    ri = 0
    for g, (rows, freq_rows) in enumerate(groups):
        offs[g] = ri
        freq_rows = np.ascontiguousarray(freq_rows, dtype=np.uint16)
        keepalive.append(freq_rows)
        total = 0
        for r, row in enumerate(rows):
            row = np.ascontiguousarray(row, dtype=np.uint8)
            keepalive.append(row)
            row_ptrs[ri] = row.ctypes.data
            row_counts[ri] = row.size
            row_freqs[ri] = freq_rows[r:r + 1].ctypes.data
            total += row.size
            ri += 1
        states = np.empty((len(rows), 128), dtype=np.uint32)
        words = np.empty(max(total, 1), dtype=np.uint16)
        results.append((states, words))
        states_out[g] = states.ctypes.data
        words_out[g] = words.ctypes.data
        words_cap[g] = words.size
    offs[n] = ri
    rc = lib.mts_rans_encode_batch(n, offs, row_ptrs, row_counts, row_freqs,
                                   states_out, words_out, words_cap,
                                   words_len, int(n_threads))
    if rc != 0:  # pragma: no cover
        return None
    return [(states, words[:words_len[g]])
            for g, (states, words) in enumerate(results)]


def rans_decode_groups(groups, n_threads=1):
    """Decode rANS groups natively; None if the library is unavailable.

    ``groups``: list of ``(states, words, freq_rows, row_outs)`` where
    ``states`` is (R, 128) uint32, ``words`` a uint16 array,
    ``freq_rows`` (R, 256) uint16, and ``row_outs`` a list of R
    contiguous writable uint8 arrays (the decoded symbols land there —
    callers pass views into the plane buffers for zero-copy scatter).
    Returns the per-group consumed word counts (the corruption check),
    or None when the library is missing / a stream is corrupt.
    """
    import numpy as np
    lib = _load()
    if lib is None or not groups:
        return None
    n = len(groups)
    n_rows_total = sum(len(outs) for _, _, _, outs in groups)
    offs = (ctypes.c_int * (n + 1))()
    states_p = (ctypes.c_void_p * n)()
    words_p = (ctypes.c_void_p * n)()
    n_words = (ctypes.c_size_t * n)()
    row_freqs = (ctypes.c_void_p * max(n_rows_total, 1))()
    row_counts = (ctypes.c_int * max(n_rows_total, 1))()
    row_out = (ctypes.c_void_p * max(n_rows_total, 1))()
    words_used = (ctypes.c_size_t * n)()
    keepalive = []
    ri = 0
    for g, (states, words, freq_rows, row_outs) in enumerate(groups):
        offs[g] = ri
        states = np.ascontiguousarray(states, dtype=np.uint32)
        words = np.ascontiguousarray(words, dtype=np.uint16)
        freq_rows = np.ascontiguousarray(freq_rows, dtype=np.uint16)
        keepalive += [states, words, freq_rows]
        states_p[g] = states.ctypes.data
        words_p[g] = words.ctypes.data
        n_words[g] = words.size
        for r, out in enumerate(row_outs):
            if out.dtype != np.uint8 or not out.flags.c_contiguous:
                return None     # caller falls back to the NumPy coder
            row_freqs[ri] = freq_rows[r:r + 1].ctypes.data
            row_counts[ri] = out.size
            row_out[ri] = out.ctypes.data
            ri += 1
    offs[n] = ri
    rc = lib.mts_rans_decode_batch(n, offs, states_p, words_p, n_words,
                                   row_freqs, row_counts, row_out,
                                   words_used, int(n_threads))
    if rc != 0:
        return None
    return [int(words_used[g]) for g in range(n)]


def cumsum_axis0_inplace(arr):
    """In-place axis-0 modular cumsum of a C-contiguous 2-D int array.

    Returns True on success; False when the library is unavailable or
    the dtype/layout is unsupported (caller falls back to NumPy).
    Bit-identical to ``np.cumsum(arr, axis=0, out=arr)`` for integer
    dtypes (both wrap mod 2**bits).
    """
    lib = _load()
    if lib is None:
        return False
    if arr.ndim != 2 or not arr.flags.c_contiguous \
            or not arr.flags.writeable \
            or arr.dtype.kind not in 'iu' \
            or arr.dtype.itemsize not in (1, 2, 4, 8) \
            or arr.dtype.byteorder not in '<=|':
        return False
    rc = lib.mts_cumsum_axis0(arr.ctypes.data, arr.shape[0], arr.shape[1],
                              arr.dtype.itemsize)
    return rc == 0


def fuse2_i16(lo, hi, C, tp, tcs, out_body):
    """Fused combine+unzigzag+transpose for 2-byte aligned containers.

    ``lo``/``hi``: per-plane (kind, operand) pairs — (0, padded uint8
    stream), (1, unpadded raw uint8 bytes), (2, int constant value).
    ``out_body`` is the (tcs, C) int16-compatible view at chunk row 1.
    Returns True on success; False -> caller uses the NumPy path.
    """
    lib = _load()
    if lib is None:
        return False
    import numpy as np
    args = []
    for kind, operand in (lo, hi):
        if kind == 2:
            args += [None, 2, int(operand)]
        else:
            if operand.dtype != np.uint8 or not operand.flags.c_contiguous:
                return False
            args += [operand.ctypes.data, int(kind), 0]
    if not out_body.flags.c_contiguous or out_body.dtype.itemsize != 2:
        return False
    rc = lib.mts_fuse2_i16(*args, C, tp, tcs, out_body.ctypes.data)
    return rc == 0


def hist_u8_segments(stream, seg):
    """Per-segment 256-bin histograms of a contiguous uint8 stream.

    Returns ``(n_segs, 256)`` int64 (bit-equal to numpy bincount per
    ``seg``-sized slice), or None when the library is unavailable.
    Banked counting runs ~5x faster than the bincount loop, which
    matters because segment-table clustering histograms the whole
    coded stream once per RANS plane.
    """
    import numpy as np
    lib = _load()
    if lib is None:
        return None
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    n = stream.size
    if n == 0 or seg <= 0:
        return None
    n_segs = -(-n // seg)
    out = np.empty((n_segs, 256), dtype=np.uint32)
    rc = lib.mts_hist_u8_segments(stream.ctypes.data, n, seg,
                                  out.ctypes.data)
    if rc != 0:  # pragma: no cover
        return None
    return out.astype(np.int64)


_PREP_SCRATCH = None


def _prep_scratch(n):
    """Per-thread reusable (lo, hi) uint8 buffers of ``n`` bytes."""
    import threading
    import numpy as np
    global _PREP_SCRATCH
    if _PREP_SCRATCH is None:
        _PREP_SCRATCH = threading.local()
    bufs = getattr(_PREP_SCRATCH, 'bufs', None)
    if bufs is None or bufs[0].size != n:
        bufs = (np.empty(n, dtype=np.uint8), np.empty(n, dtype=np.uint8))
        _PREP_SCRATCH.bufs = bufs
    return bufs


def prepare2_i16(body, tp, hists=True, diff=False, seg_k=0):
    """Fused encode prep for 2-byte aligned containers.

    ``body``: the diffed chunk minus its head row — (tcs, C) int16/
    uint16, C-contiguous — or, with ``diff=True``, the RAW chunk
    (tcs+1, C) whose head row is kept verbatim while the time diff is
    applied on the fly inside the same blocked pass (bit-identical to
    ``np.diff``'s same-dtype wraparound; kills the separate diff pass
    and its memory round trip).

    Returns ``(lo, hi, hist_lo, hist_hi)`` — the two zero-padded
    channel-major (C*tp,) uint8 plane streams and the per-plane 256-bin
    histograms of the DATA symbols (pads excluded) — or None when the
    library is unavailable or the layout unsupported.

    ``seg_k > 0`` (channels per aligned segment) switches the histogram
    pass to per-segment counting: the last two elements are then
    (ceil(C/seg_k), 256) int64 arrays of DATA symbol counts per segment
    (callers add the per-channel pad zeros — codec/ans.py encode).
    ``hists=False`` skips counting entirely and returns None histograms.
    """
    import numpy as np
    lib = _load()
    if lib is None:
        return None
    if body.ndim != 2 or not body.flags.c_contiguous \
            or body.dtype.itemsize != 2 or body.dtype.kind not in 'iu' \
            or body.dtype.byteorder not in '<=':
        return None
    tcs, C = body.shape
    if diff:
        if tcs < 1:
            return None
        tcs -= 1
    # Reused per-thread scratch: the C pass writes every data byte and
    # zeroes the pad tails itself, so dirty buffers are fine — fresh
    # np.zeros of 2x C*tp per chunk costs ~2x the pass in page faults.
    # Safe because codec.encode never lets the plane views escape the
    # call (streams are copied into the container bytes).
    lo, hi = _prep_scratch(C * tp)
    if not hists:
        rc = lib.mts_prepare2d_i16(body.ctypes.data, C, tp, tcs,
                                   int(diff), lo.ctypes.data,
                                   hi.ctypes.data, 0, None, None, None,
                                   None)
        if rc != 0:  # pragma: no cover
            return None
        return lo, hi, None, None
    if seg_k > 0:
        n_segs = -(-C // seg_k)
        seg_lo = np.zeros((n_segs, 256), dtype=np.uint32)
        seg_hi = np.zeros((n_segs, 256), dtype=np.uint32)
        rc = lib.mts_prepare2d_i16(body.ctypes.data, C, tp, tcs,
                                   int(diff), lo.ctypes.data,
                                   hi.ctypes.data, seg_k, None, None,
                                   seg_lo.ctypes.data, seg_hi.ctypes.data)
        if rc != 0:  # pragma: no cover
            return None
        return lo, hi, seg_lo.astype(np.int64), seg_hi.astype(np.int64)
    hist_lo = np.zeros(256, dtype=np.uint32)
    hist_hi = np.zeros(256, dtype=np.uint32)
    rc = lib.mts_prepare2d_i16(body.ctypes.data, C, tp, tcs,
                               int(diff), lo.ctypes.data, hi.ctypes.data,
                               0, hist_lo.ctypes.data, hist_hi.ctypes.data,
                               None, None)
    if rc != 0:  # pragma: no cover
        return None
    return lo, hi, hist_lo.astype(np.int64), hist_hi.astype(np.int64)


def quantize_freqs_batch(counts_rows, scale, min_freq):
    """Row-batched frequency quantization (bit-identical to the
    normative models/rans.py quantize_freqs per row).

    ``counts_rows``: (K, 256) nonnegative counts, every row with >= 2
    present symbols. Returns (K, 256) uint16, or None when the library
    is unavailable or a row falls outside the native contract (the
    caller's NumPy path handles those). Exists because segment-table
    clustering quantizes many small candidate stacks per Lloyd
    iteration, where the vectorized NumPy form is call-overhead bound.
    """
    import numpy as np
    lib = _load()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts_rows, dtype=np.int64)
    if counts.ndim != 2 or counts.shape[1] != 256 or counts.shape[0] == 0:
        return None
    out = np.empty(counts.shape, dtype=np.uint16)
    rc = lib.mts_quantize_freqs_batch(counts.ctypes.data, counts.shape[0],
                                      int(scale), int(min_freq),
                                      out.ctypes.data)
    if rc != 0:
        return None
    return out
