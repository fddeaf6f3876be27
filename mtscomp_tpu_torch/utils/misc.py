"""Small shared utilities: attribute-dict, scalar clamp, the package
logger with its default handler, and an optional progress bar.

Parity notes: mirrors the reference's utility layer (mtscomp.py:64-108):
``Bunch`` (mtscomp.py:99-104), ``_clip`` (107-108), and the colorized
single-letter-level log formatter + ``add_default_handler`` (68-96).
"""

import copy
import logging
import os.path as op

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


_ANSI = {'D': '90', 'I': '0', 'W': '33', 'E': '31', 'C': '31'}


class _ColorFormatter(logging.Formatter):
    """Compact formatter: time, level initial, caller file:line, message.

    Never mutates the shared LogRecord (other handlers attached to the
    logger format the same record object).
    """

    def format(self, record):
        record = copy.copy(record)
        record.levelname = record.levelname[:1]
        src = op.splitext(op.basename(record.pathname))[0]
        record.caller = ('%s:%d' % (src, record.lineno)).ljust(22)
        msg = super().format(record)
        code = _ANSI.get(record.levelname, '7')
        return '\33[%sm%s\33[0m' % (code, msg)


def add_default_handler(level='INFO', logger=logger):
    """Attach a stream handler with the compact colorized format.

    Also lowers the LOGGER's level when the handler asks for more
    detail than it currently passes: otherwise Logger.isEnabledFor
    drops DEBUG records before any handler sees them.
    """
    handler = logging.StreamHandler()
    handler.setLevel(level)
    want = level if isinstance(level, int) \
        else logging.getLevelName(level)
    if isinstance(want, int) and want < logger.getEffectiveLevel():
        logger.setLevel(want)
    handler.setFormatter(_ColorFormatter(
        fmt='%(asctime)s.%(msecs)03d [%(levelname)s] %(caller)s %(message)s',
        datefmt='%H:%M:%S'))
    logger.addHandler(handler)
    return handler


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
