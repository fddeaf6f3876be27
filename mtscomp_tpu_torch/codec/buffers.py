"""Shared helpers for codec output buffers."""


def dest_matches(dest, shape, dtype):
    """Whether ``dest`` can receive a decoded chunk in place.

    The ``outs=`` contract of the batch decoders: a destination is used
    only when it is exactly the chunk's layout (C-contiguous, writable,
    same shape/dtype); anything else falls back to a fresh array, which
    callers detect by identity. Both codecs must agree on this
    predicate or the Reader's identity-check protocol would behave
    differently per algorithm.
    """
    return (dest is not None and dest.flags.c_contiguous
            and dest.flags.writeable and dest.shape == shape
            and dest.dtype == dtype)
