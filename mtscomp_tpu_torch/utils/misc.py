"""Small shared utilities: attribute-dict, scalar clamp, the package
logger and an optional progress bar.

Parity notes: mirrors the reference's utility layer (mtscomp.py:64-108):
``Bunch`` (mtscomp.py:99-104) and ``_clip`` (107-108).
"""

import logging

logger = logging.getLogger('mtscomp_tpu_torch')
logger.setLevel(logging.INFO)
logger.addHandler(logging.NullHandler())


class Bunch(dict):
    """Dictionary whose keys are also attributes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def clip(x, lo, hi):
    """Clamp a scalar to [lo, hi]."""
    return max(lo, min(hi, x))


class progress:
    """Minimal tqdm-compatible progress wrapper (falls back to no-op).

    The reference displays tqdm bars in write/tofile/check loops
    (mtscomp.py:461, 720, 871); we keep the same UX when tqdm is present
    but never require it.
    """

    def __new__(cls, iterable, desc=None, total=None, disable=False):
        if disable:
            return iterable
        try:
            from tqdm import tqdm
        except ImportError:  # pragma: no cover
            return iterable
        return tqdm(iterable, desc=desc, total=total)
