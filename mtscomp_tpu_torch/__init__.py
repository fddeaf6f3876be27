"""mtscomp_tpu_torch: the mtscomp_tpu codec ported to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package ``mtscomp_tpu`` stays the reference. This package keeps
its own copies of the JAX-free host layer (container format, normative
coder, host codec and native C++ runtime, ``Writer`` and ``Reader``)
and replaces the device layer: ans (v2) files compress through the
device encode (K6) and decode through the batched device decode (K1 to
K5), in bulk and window by window. The tools (``verify_file``,
``transcode``, ``StreamWriter``/``StreamReader``, the chunk-range
compress of ``parallel/distributed.py`` and the command line of
``cli.py``) are the JAX package's. It imports neither JAX nor anything
of ``mtscomp_tpu``. See
``README.md`` ("PyTorch / H100 port") for what it covers.
"""

# On-disk format versions (the JAX package's): v1.0 is bit-compatible
# with the reference mtscomp, v2.0 is the rANS container.
FORMAT_VERSION = '1.0'
FORMAT_VERSION_ANS = '2.0'

from .api import Reader, Writer, check, compress, decompress  # noqa: E402
from .config import (CONFIG_PATH, config_path, read_config,  # noqa: E402
                     write_config)
from .device import resolve_device  # noqa: E402
from .io_host import load_raw_data  # noqa: E402
from .ops import device_delta, rans_decode, rans_encode  # noqa: E402
from .ops.delta import cumsum_along_axis, diff_along_axis  # noqa: E402
from .parallel import pipeline  # noqa: E402
from .utils.misc import Bunch, add_default_handler  # noqa: E402
from .parallel.pipeline import (DeviceBatchDecoder,  # noqa: E402
                                DeviceBatchEncoder, DeviceChunkCache,
                                decompress_multi, decompress_to_array,
                                decompress_to_tensor)
from .stream import StreamReader, StreamWriter  # noqa: E402
from .transcode import transcode  # noqa: E402
from .verify import verify_file  # noqa: E402

__all__ = ('load_raw_data', 'Writer', 'Reader', 'compress', 'decompress',
           'check', 'StreamWriter', 'StreamReader', 'transcode',
           'verify_file', 'read_config', 'write_config', 'Bunch',
           'add_default_handler', 'diff_along_axis', 'cumsum_along_axis',
           'resolve_device', 'DeviceBatchDecoder', 'DeviceBatchEncoder',
           'DeviceChunkCache', 'decompress_multi', 'decompress_to_array',
           'decompress_to_tensor', 'launch_counts', 'reset_launch_counts')


def launch_counts():
    """Kernel launches so far in this process, by kernel form (K1 by
    lookup, K4 by element type and mode, K5 by element type, K6), plus
    the chunks the pipeline sent to the host codec: in decodes
    (``host_fallback_chunks``) and in the Writer's device encodes
    (``host_encoded_chunks``)."""
    return dict(rans_decode.launches, **device_delta.launches,
                **rans_encode.launches,
                host_fallback_chunks=pipeline.host_fallback_chunks,
                host_encoded_chunks=pipeline.host_encoded_chunks)


def reset_launch_counts():
    """Set every count of :func:`launch_counts` to 0."""
    for counts in (rans_decode.launches, device_delta.launches,
                   rans_encode.launches):
        counts.update(dict.fromkeys(counts, 0))
    pipeline.host_fallback_chunks = 0
    pipeline.host_encoded_chunks = 0
