"""A rig's merged read (``decompress_multi``): decoded GB of every probe
of every call of the window, over the time from the window's start to
the last call's completion, as ``decode_gbps`` reads a bulk read of one
probe. Per layer: two sets of six seeds spread 16.2 and 10.9 % on an
H100, over half the end-to-end bound."""


def read(run):
    return run.bytes / 1e9 / run.span_s
