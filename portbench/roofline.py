"""The device's peaks and the least work of the decode, frozen with the
benchmark so that a roofline share means the same in every later run.

A decode must read each compressed payload byte once and write each
decoded byte once; no kernel that implements it can move less. So its
least time is those bytes at the card's memory bandwidth, whatever
kernels do the work.
"""

#: NVIDIA H100 SXM5 80 GB (HBM3) data sheet: memory bandwidth, at the
#: card's full power limit of 700 W.
HBM_BYTES_PER_S = 3.35e12


def decode_bytes(payload_bytes, decoded_bytes):
    """Bytes the decode of ``payload_bytes`` into ``decoded_bytes`` must
    move at least."""
    return payload_bytes + decoded_bytes


def decode_least_s(payload_bytes, decoded_bytes):
    return decode_bytes(payload_bytes, decoded_bytes) / HBM_BYTES_PER_S
