"""Host-side file I/O: raw array loading, atomic positioned reads, naming.

Parity: ``load_raw_data`` matches the reference loader semantics
(mtscomp.py:115-140): shape inference from file size, divisibility
validation, empty-file -> ``(0, n_channels)``, memmap by default, and
``NotImplementedError`` for ``mmap=False`` with a nonzero offset.

``pread_exact`` is the thread-safe positioned read used by concurrent
chunk decoding (reference: mtscomp.py:602-615).
"""

import os
import threading
from pathlib import Path

import numpy as np

# Fallback lock for platforms without os.pread, and for seek+read pairs
# that must be atomic (reference uses a module-level Lock, mtscomp.py:33).
_read_lock = threading.Lock()


def load_raw_data(path=None, n_channels=None, dtype=None, offset=None, mmap=True):
    """Open a flat binary file as a ``(n_samples, n_channels)`` array.

    ``n_samples`` is inferred from the file size; a size that is not a
    whole number of frames raises ``ValueError``. Empty files produce an
    empty ``(0, n_channels)`` array.
    """
    path = Path(path)
    assert path.exists(), "File %s does not exist." % path
    assert dtype, "The data type must be provided."
    n_channels = n_channels or 1
    offset = int(offset or 0)
    item_size = np.dtype(dtype).itemsize
    payload = os.path.getsize(str(path)) - offset
    if payload < 0:
        raise ValueError("Offset %d is beyond the end of %s (%d bytes)."
                         % (offset, path, payload + offset))
    n_samples = payload // (item_size * n_channels)
    if n_samples * n_channels * item_size != payload:
        raise ValueError(
            "The file size (%d bytes) is incompatible with the specified "
            "parameters (n_channels=%d, dtype=%s, offset=%d)."
            % (payload + offset, n_channels, dtype, offset))
    if n_samples == 0:
        return np.zeros((0, n_channels), dtype=dtype)
    if mmap:
        # Read-only mapping: numpy's default mode 'r+' would both fail
        # on read-only storage (archival/shared datasets) and make
        # accidental writes mutate the user's original file.
        return np.memmap(str(path), dtype=dtype, mode='r',
                         shape=(n_samples, n_channels), offset=offset)
    if offset > 0:  # pragma: no cover
        raise NotImplementedError()
    return np.fromfile(str(path), dtype).reshape((n_samples, n_channels))


def pread_exact(fileobj, length, start):
    """Read exactly ``length`` bytes at byte position ``start``.

    Uses the atomic ``os.pread`` syscall where available so concurrent
    readers never interleave seek/read pairs; otherwise serializes a
    seek+read under a lock.
    """
    if hasattr(os, 'pread'):
        buf = os.pread(fileobj.fileno(), length, start)
    else:  # pragma: no cover
        with _read_lock:
            fileobj.seek(start)
            buf = fileobj.read(length)
    if len(buf) != length:
        raise IOError("Short read: wanted %d bytes at offset %d, got %d."
                      % (length, start, len(buf)))
    return buf


def default_compressed_paths(data_path, out=None, outmeta=None):
    """Default output names: ``x.bin -> x.cbin`` / ``x.npy -> x.cnpy``,
    sidecar ``x.ch`` (reference naming, mtscomp.py:445-449)."""
    data_path = Path(data_path)
    if not out:
        out = data_path.with_suffix('.c' + data_path.suffix[1:])
    if not outmeta:
        outmeta = data_path.with_suffix('.ch')
    return Path(out), Path(outmeta)
