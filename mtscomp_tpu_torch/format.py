"""On-disk container logic: chunk geometry and the ``.ch`` metadata schema.

The container is two files (reference format, mtscomp.py:341-358, 460-495):

- ``.cbin``: per-chunk compressed payloads concatenated back-to-back with
  **no framing of its own** — the byte extents live in the sidecar.
- ``.ch``: JSON sidecar holding dtype/shape/sample_rate, ``chunk_bounds``
  (sample offsets, ``n_chunks+1`` entries), ``chunk_offsets`` (byte
  offsets into ``.cbin``), the algorithm and transform flags, and SHA1
  hashes of both streams.

Format v1.0 (``algorithm='zlib'``) is byte-compatible with the reference.
Format v2.0 (``algorithm='ans'``) uses the same sidecar schema (plus rANS
parameters) with each chunk payload being a self-contained interleaved
rANS container (see ``codec/ans.py``).
"""

import json
from pathlib import Path

import numpy as np

from . import FORMAT_VERSION, FORMAT_VERSION_ANS
from .utils.misc import Bunch


# Every sidecar key that changes how payload bytes map to decoded
# samples: two files may only share decode state when their identities
# are equal. Any new decode-semantic sidecar extension must be added here
# (v2 extensions are absent from old sidecars: absent key = default).
# ``ans_seg_log2``/``ans_table_mode`` are not identity: every chunk
# payload is self-describing (codec/ans.py container header), the
# sidecar copies are encode defaults only.
DECODE_IDENTITY_KEYS = (
    'algorithm', 'dtype', 'n_channels', 'chunk_order',
    'do_time_diff', 'do_spatial_diff', 'time_diff_order', 'float_bitcast')


def decode_identity(cmeta):
    """Normalized decode-identity mapping of a sidecar dict/Bunch.

    Values are normalized (bool flags, int order, canonical dtype
    string; absent v2 extension keys get their defaults) so files
    written by different library versions compare correctly.
    """
    return {
        'algorithm': cmeta.get('algorithm'),
        'dtype': str(np.dtype(cmeta.get('dtype'))),
        'n_channels': int(cmeta.get('n_channels')),
        'chunk_order': cmeta.get('chunk_order', 'F'),
        'do_time_diff': bool(cmeta.get('do_time_diff', True)),
        'do_spatial_diff': bool(cmeta.get('do_spatial_diff', False)),
        'time_diff_order': int(cmeta.get('time_diff_order') or 1),
        'float_bitcast': bool(cmeta.get('float_bitcast', False)),
    }


def compute_chunk_bounds(n_samples, sample_rate, chunk_duration):
    """Sample offsets delimiting fixed-duration chunks.

    ``chunk_size = round(chunk_duration * sample_rate)`` and the final
    chunk may be shorter (reference: mtscomp.py:324-339). Returns a list
    of ``n_chunks + 1`` ints starting at 0 and ending at ``n_samples``.
    """
    chunk_size = int(np.round(chunk_duration * sample_rate))
    assert chunk_size > 0
    bounds = list(range(0, n_samples, chunk_size)) or [0]
    if bounds[-1] < n_samples:
        bounds.append(n_samples)
    assert bounds[0] == 0 and bounds[-1] == n_samples
    return bounds


def build_cmeta(*, algorithm, comp_level, do_time_diff, do_spatial_diff,
                dtype, n_channels, sample_rate, chunk_bounds, chunk_offsets,
                chunk_order, sha1_compressed, sha1_uncompressed, shape,
                extra=None):
    """Assemble the ``.ch`` dictionary (key set of reference get_cmeta,
    mtscomp.py:341-358; v2 adds algorithm parameters under the same
    flat namespace)."""
    version = FORMAT_VERSION if algorithm == 'zlib' else FORMAT_VERSION_ANS
    cmeta = {
        'version': version,
        'algorithm': algorithm,
        'comp_level': comp_level,
        'do_time_diff': do_time_diff,
        'do_spatial_diff': do_spatial_diff,
        'dtype': str(np.dtype(dtype)),
        'n_channels': int(n_channels),
        'sample_rate': float(sample_rate),
        'chunk_bounds': [int(b) for b in chunk_bounds],
        'chunk_offsets': [int(o) for o in chunk_offsets],
        'chunk_order': chunk_order,
        'sha1_compressed': sha1_compressed,
        'sha1_uncompressed': sha1_uncompressed,
        'shape': tuple(int(s) for s in shape),
    }
    if extra:
        cmeta.update(extra)
    return cmeta


def write_cmeta(path, cmeta):
    """Serialize the sidecar exactly as the reference does
    (``json.dump(indent=2, sort_keys=True)``, mtscomp.py:494-495)."""
    with open(path, 'w') as f:
        json.dump(cmeta, f, indent=2, sort_keys=True)


def read_cmeta(cmeta):
    """Load a ``.ch`` sidecar from a path or pass through a dict."""
    if not isinstance(cmeta, dict):
        with open(cmeta, 'r') as f:
            cmeta = json.load(f)
    assert isinstance(cmeta, dict)
    return Bunch(cmeta)


def cmeta_sidecar_path(cdata):
    """Default sidecar path for a compressed file (same stem, ``.ch``)."""
    return Path(cdata).with_suffix('.ch')
