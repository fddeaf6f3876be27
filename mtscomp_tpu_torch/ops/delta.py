"""Delta transform and its exact inverse (host/NumPy entry points).

The codec's transform stage: first-order difference along time (axis 0)
and/or space (axis 1), keeping the leading row/column verbatim so each
chunk stays self-contained (reference semantics: mtscomp.py:143-169).

Exactness contract: for integer dtypes both the diff and the cumsum are
computed **in the array dtype**, so both wrap modulo 2**bits and the
round trip is byte-exact. For floats the round trip is only close to
within ``CHECK_ATOL`` (reference: mtscomp.py:59, 880-886).

The device encode's torch counterparts (``diff_time``, ``diff_space``)
live in ``ops/device_delta.py``.
"""

import numpy as np


def diff_along_axis(chunk, axis=None):
    """First-order diff along ``axis``; slice 0 is kept verbatim.

    ``axis=None`` is the identity (used when a diff direction is
    disabled). Works for any ndim/axis, like the reference
    (mtscomp.py:143-159).
    """
    if axis is None:
        return chunk
    assert 0 <= axis < chunk.ndim
    out = np.empty_like(chunk, subok=False)

    def ax(sl):
        full = [slice(None)] * chunk.ndim
        full[axis] = sl
        return tuple(full)

    out[ax(slice(0, 1))] = chunk[ax(slice(0, 1))]
    np.subtract(chunk[ax(slice(1, None))], chunk[ax(slice(None, -1))],
                out=out[ax(slice(1, None))])
    return out


def cumsum_along_axis(chunk, axis=None, inplace=False):
    """Inverse of :func:`diff_along_axis`: in-dtype cumulative sum.

    The accumulation dtype equals the input dtype on purpose — modular
    wraparound is what makes the integer round trip byte-exact.

    For the hot shape — axis 0 of a C-contiguous 2-D integer array —
    the sum runs in the native runtime, which walks memory row-major
    (NumPy's axis-0 cumsum strides column-by-column, cache-hostile at
    hundreds of channels; the native loop is ~10x faster on the
    385-channel decode path and bit-identical). ``inplace=True`` lets a
    caller that owns the buffer (the decode path: codec output is
    private) skip the defensive copy; the input may then be mutated and
    returned.
    """
    if axis is None:
        return chunk
    assert 0 <= axis < chunk.ndim
    if axis == 0 and chunk.ndim == 2 and chunk.dtype.kind in 'iu':
        from .. import native
        if native.available():
            if inplace and chunk.flags.c_contiguous \
                    and chunk.flags.writeable:
                if native.cumsum_axis0_inplace(chunk):
                    return chunk
            out = np.ascontiguousarray(chunk)
            # shares_memory, not `is`: ascontiguousarray of an ndarray
            # SUBCLASS (np.memmap!) returns a distinct object aliasing
            # the same bytes — mutating it would corrupt the caller's
            # backing file (or segfault on a read-only mapping).
            if np.shares_memory(out, chunk):
                out = out.copy()
            if native.cumsum_axis0_inplace(out):
                return out
    out = np.empty_like(chunk, subok=False)
    np.cumsum(chunk, axis=axis, out=out)
    return out
