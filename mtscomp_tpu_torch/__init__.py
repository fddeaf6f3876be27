"""mtscomp_tpu_torch: the mtscomp_tpu decoder ported to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package ``mtscomp_tpu`` stays the reference; this package shares
its JAX-free parts (container format, normative coder, native host
runtime, host ``Reader``) and replaces its device layer. It never
imports JAX. See ``README.md`` ("PyTorch / H100 port") for what it
covers.
"""

from .api import Reader, decompress
from .device import resolve_device
from .ops import device_delta, rans_decode
from .parallel import pipeline
from .parallel.pipeline import (DeviceBatchDecoder, decompress_to_array,
                                decompress_to_tensor)

__all__ = ('Reader', 'decompress', 'resolve_device', 'DeviceBatchDecoder',
           'decompress_to_array', 'decompress_to_tensor', 'launch_counts',
           'reset_launch_counts')


def launch_counts():
    """Kernel launches so far in this process, by kernel form (K1 by
    lookup, K4 by element type and mode, K5 by element type), plus the
    chunks the pipeline sent to the host codec."""
    return dict(rans_decode.launches, **device_delta.launches,
                host_fallback_chunks=pipeline.host_fallback_chunks)


def reset_launch_counts():
    """Set every count of :func:`launch_counts` to 0."""
    for counts in (rans_decode.launches, device_delta.launches):
        counts.update(dict.fromkeys(counts, 0))
    pipeline.host_fallback_chunks = 0
