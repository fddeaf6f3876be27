"""Host-side decode tables, re-housed as plain numpy.

The JAX package builds these in ``mtscomp_tpu/ops/pallas_rans.py``
(``pack_device_tables``, ``WINDOW_ROWS``), a module that imports Pallas
when it loads; the port needs the identical arrays without JAX. The
packed arrays are bit-identical to the JAX package's (a test holds the
two against each other for every table of real containers).
"""

import numpy as np

from ..models.rans import GROUP_ROWS, SCALE_BITS


#: Slack word rows after each group's stream: what one step of a 32-row
#: group can span in the TPU kernel's word window (8 alignment rows, 1
#: row of in-row offset, 32 rows of ranks, 1 boundary row). The port's
#: kernel needs no slack; it keeps the rows so that its staged word
#: buffers equal the JAX package's shape for shape.
WINDOW_ROWS = GROUP_ROWS + 10


def pack_device_tables(freqs):
    """Packed decode tables from a (256,) frequency table.

    Returns ``(coarse_pk (2,128) int32, dense_pk (2,128) int32,
    needs_second_fixup bool, octet_pk (128,) int32 | None)``:

    - ``dense_pk[i]`` (flattened to 256) packs the i-th present symbol as
      ``value << 24 | freq << 12 | cum``;
    - a coarse entry packs the first dense id of its 16-slot bucket and
      both fixup boundaries, ``((up1-1) << 20) | ((up0-1) << 8) | id0``;
    - ``needs_second_fixup`` is True when some bucket holds 3 symbols;
    - ``octet_pk`` holds, 4 per int32 (little-endian bytes), the dense id
      of each 8-slot octet for 8-aligned tables (what this codec's
      ``quantize_freqs`` writes); None for tables with unaligned
      boundaries.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    present = np.flatnonzero(freqs)
    f_d = freqs[present]
    upper_d = np.cumsum(f_d)
    cum_d = upper_d - f_d
    dense = np.zeros(256, dtype=np.int64)
    dense[:present.size] = (present << 24) | (f_d << 12) | cum_d
    id0 = np.searchsorted(upper_d, np.arange(256) * 16, side='right')
    up0 = upper_d[id0]
    up1 = np.where(id0 + 1 < present.size,
                   upper_d[np.minimum(id0 + 1, present.size - 1)],
                   1 << SCALE_BITS)
    coarse = ((up1 - 1) << 20) | ((up0 - 1) << 8) | id0
    needs2 = bool(np.any(up1 < (np.arange(256) + 1) * 16))

    octet_pk = None
    if not np.any(f_d & 7):
        ids = np.searchsorted(upper_d, 8 * np.arange(512), side='right')
        octet_pk = (ids[0::4] | (ids[1::4] << 8) | (ids[2::4] << 16)
                    | (ids[3::4] << 24)).astype(np.uint32).view(np.int32)

    def to_i32(a):
        return a.astype(np.uint32).view(np.int32).reshape(2, 128)

    return to_i32(coarse), to_i32(dense), needs2, octet_pk
