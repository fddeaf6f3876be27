"""The plain reference that decides ``correct``: NumPy only, importing
nothing of the program. The guarantee of every configuration is
lossless storage, so the answer a call must give is the source itself,
which the harness made from the seed; a file the program wrote is
decoded by :mod:`.decode`, the frozen decoder of the format."""

import numpy as np


def samples_wrong(got, want):
    """Samples of ``want`` that ``got`` does not hold: every one of them
    where ``got`` is missing or its shape or dtype differs."""
    if got is None or got.shape != want.shape or got.dtype != want.dtype:
        return int(want.size)
    return int(np.count_nonzero(got != want))
