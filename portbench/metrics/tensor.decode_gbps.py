"""A decode onto the card (``to_tensor``): decoded GB of every call of the
window, over the time from the window's start to the last call's
completion, as ``decode_gbps`` reads a bulk read into host memory. Per
layer: this read is bound by one host thread, whose speed drifts with
the host's load by more than an end-to-end bound can hold."""


def read(run):
    return run.bytes / 1e9 / run.span_s
