"""Three-level configuration: built-in defaults < user JSON file < call kwargs.

Parity: reproduces the reference's config system (mtscomp.py:46-57,
176-209) — including the ``None``-skipping merge (198-199) that lets CLI
flags that were not passed fall through to file defaults — and extends it
with the ans format's keys and the port's device (``'cuda'`` runs the
hand-written kernels, ``'cpu'`` their plain PyTorch twins, ``'none'``
the host codec; ``'auto'``, the value a config file written for the JAX
package may hold, means ``'cuda'`` where a GPU is visible, else
``'none'``).

The user file is ``~/.mtscomp`` so that defaults configured for the
reference library apply here unchanged (drop-in behavior).
"""

import json
import multiprocessing
from pathlib import Path

from .utils.misc import Bunch

#: Default configuration. Stored as an immutable tuple of items so the
#: module-level default can never be mutated in place (the reference uses
#: the same trick with a list, mtscomp.py:46-57).
DEFAULT_CONFIG = (
    # --- keys shared with the reference (mtscomp.py:46-57) ---
    ('algorithm', 'zlib'),          # 'zlib' (legacy v1.0) or 'ans' (TPU v2.0)
    ('cache_size', 10),             # decoded chunks kept in the Reader LRU
    ('check_after_compress', True),
    ('check_after_decompress', True),
    ('chunk_duration', 1.0),        # seconds per chunk
    ('chunk_order', 'F'),           # column-major serialization (demux channels)
    ('comp_level', -1),             # recorded in .ch; zlib always uses default
                                    # level (quirk preserved from mtscomp.py:394)
    ('do_spatial_diff', 'auto'),    # False | True | 'auto' — channel-axis
                                    # diff after the time diff. 'auto'
                                    # probes chunk 0 (ans files only:
                                    # wins on channel-correlated bands —
                                    # +10% smooth LFP fields, +19%
                                    # common-mode artifacts measured —
                                    # loses on independent channels);
                                    # zlib resolves to False (reference
                                    # byte-identity, whose default is
                                    # False: mtscomp.py:52)
    ('do_time_diff', True),
    ('n_threads', multiprocessing.cpu_count()),
    # --- ans (v2) and device extensions ---
    ('device', 'cuda'),             # 'cuda' (kernels; raises without a GPU)
                                    # | 'cpu' (their twins) | 'none' (host
                                    # codec only) | 'auto' ('cuda' if a GPU
                                    # is visible, else 'none'); 'cuda:N'
                                    # picks a card. Only ans files use it.
    ('ans_seg_log2', 16),           # log2 symbols per rANS segment (128 lanes each)
    ('ans_channel_segments', True),  # channel-aligned segments (TPU fast layout)
    ('ans_table_mode', 'segment'),  # 'segment' (default: clustered per-segment
                                    # tables — up to +13% ratio on channel-
                                    # heterogeneous bands for ~10% encode
                                    # cost; decode speed unchanged) | 'plane'
    ('batch_chunks', 0),            # 0 = auto batch size for the device pipeline
    ('time_diff_order', 'auto'),    # 1 | 2 | 'auto' — time-diff prediction
                                    # order for ans files ('auto' probes the
                                    # first chunk both ways: order 2 wins big
                                    # on oversampled/LFP-like bands, loses on
                                    # noise-dominated ones; zlib stays order 1
                                    # for reference byte-identity)
    ('transform_adapt', 0),         # 0 = off; N > 0 re-probes the transform
                                    # every N chunks (ans only): each window
                                    # leader is probed over the order x
                                    # spatial grid and its choice applies to
                                    # the window, stamped per chunk in the
                                    # container (flags bit5) so drifting
                                    # recordings (e.g. LFP onset mid-file)
                                    # keep the best transform throughout.
                                    # Deterministic bytes regardless of
                                    # thread count or part splits.
)

CHECK_ATOL = 1e-16  # float comparison tolerance (reference mtscomp.py:59)

CRITICAL_ERROR_MSG = (
    "CRITICAL ERROR: automatic check failed when compressing the data. "
    "Please report this, attaching the .ch file."
)


def config_path():
    """Path of the user configuration JSON file."""
    return (Path('~') / '.mtscomp').expanduser()


CONFIG_PATH = config_path()


def read_config(**kwargs):
    """Merge defaults, the user config file, and kwargs (skipping Nones)."""
    params = dict(DEFAULT_CONFIG)
    if CONFIG_PATH.exists():
        with CONFIG_PATH.open('r') as f:
            user = json.load(f)
    else:
        user = {}
    for source in (user, kwargs):
        params.update({k: v for k, v in source.items() if v is not None})
    return Bunch(params)


def write_config(**kwargs):
    """Persist the merged configuration to the user config file."""
    config = read_config(**kwargs)
    CONFIG_PATH.parent.mkdir(exist_ok=True, parents=True)
    with CONFIG_PATH.open('w') as f:
        json.dump(config, f, indent=2, sort_keys=True)
    return config
