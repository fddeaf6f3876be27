"""Legacy zlib chunk codec (format v1.0, byte-identical to the reference).

The payload of a chunk is exactly ``zlib.compress(chunkd.tobytes(order))``
with the library default compression level — the reference never forwards
its ``comp_level`` setting to zlib (quirk at mtscomp.py:394; ``comp_level``
is recorded in the sidecar but does not affect the stream), and we
reproduce that so outputs stay byte-identical.

When the native extension is available, batches of chunks are deflated /
inflated by C++ worker threads (the package's ``native``), replacing the
reference's Python ``ThreadPool`` + GIL-released ``zlib`` hot loop with a
first-party native runtime. Single-chunk calls fall back to Python zlib,
which produces identical bytes (same zlib library underneath).
"""

import zlib

import numpy as np

from .buffers import dest_matches


class ZlibCodec:
    """Deflate/inflate one diffed chunk."""

    name = 'zlib'
    format_version = '1.0'

    def __init__(self, **kwargs):
        # comp_level intentionally unused (see module docstring).
        pass

    def encode(self, chunkd, order='F'):
        """Compress a diffed chunk; returns the raw zlib stream."""
        return zlib.compress(chunkd.tobytes(order=order))

    def decode(self, payload, n_samples, n_channels, dtype, order='F',
               n_threads=1):
        """Inflate a payload back into the diffed chunk array.

        ``n_threads`` is accepted for codec-interface parity and
        ignored: one zlib stream is inherently sequential (the very
        limitation the ans format's grouped lanes remove).
        """
        try:
            raw = zlib.decompress(payload)
        except Exception as e:
            raise IOError("Corrupted zlib chunk payload (%s)." % (e,))
        flat = np.frombuffer(raw, dtype=dtype)
        if flat.size != n_samples * n_channels:
            raise IOError(
                "Decompressed chunk has %d elements, expected %d."
                % (flat.size, n_samples * n_channels))
        return flat.reshape((n_samples, n_channels), order=order)

    # --- batch hooks (native acceleration wired in ..native) ---

    def encode_batch(self, chunks, order='F', n_threads=1):
        """Compress several diffed chunks; returns list of payloads."""
        from ..native import deflate_batch
        bufs = [np.asarray(c).tobytes(order=order) for c in chunks]
        out = deflate_batch(bufs, n_threads=n_threads)
        if out is not None:
            return out
        return [zlib.compress(b) for b in bufs]

    def decode_batch(self, payloads, shapes, dtype, order='F', n_threads=1,
                     outs=None):
        """Inflate several payloads; ``shapes`` is a list of (ns, nc).

        ``outs`` (optional) is a per-chunk list of destination arrays:
        matching C-contiguous destinations receive the diffed chunk in
        place (sparing the caller's later concatenate/contiguity copy);
        non-matching or None entries get fresh views as before.
        """
        if len(payloads) != len(shapes):
            raise ValueError("decode_batch got %d payloads but %d shapes."
                             % (len(payloads), len(shapes)))
        from ..native import inflate_batch
        sizes = [ns * nc * np.dtype(dtype).itemsize for ns, nc in shapes]
        raws = inflate_batch(payloads, sizes, n_threads=n_threads)
        if raws is None:
            # Native path refused (unavailable, corrupt stream, or size
            # mismatch); the Python fallback re-derives a precise error.
            try:
                raws = [zlib.decompress(p) for p in payloads]
            except Exception as e:
                raise IOError("Corrupted zlib chunk payload (%s)." % (e,))
        if outs is None:
            outs = [None] * len(payloads)
        out = []
        for k, (raw, (ns, nc), dest) in enumerate(zip(raws, shapes, outs)):
            flat = np.frombuffer(raw, dtype=dtype)
            if flat.size != ns * nc:
                raise IOError(
                    "Decompressed chunk (batch item %d) has %d elements, "
                    "expected %d." % (k, flat.size, ns * nc))
            chunk = flat.reshape((ns, nc), order=order)
            if dest_matches(dest, chunk.shape, chunk.dtype):
                np.copyto(dest, chunk)
                chunk = dest
            out.append(chunk)
        return out
