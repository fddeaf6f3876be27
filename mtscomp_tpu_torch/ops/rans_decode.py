"""K1: grouped rANS decode, the port's counterpart of
``mtscomp_tpu/ops/pallas_rans.py`` (``decode_groups_pallas``).

Two entry points reach the hand-written CUDA kernel
(``csrc/rans_decode.cu``) for CUDA tensors and run their plain PyTorch
twins for CPU tensors; nothing else selects between them:

- ``decode_groups`` (twin ``decode_groups_ref``) takes octet tables, one
  dense id per 8-slot octet: every table this codec's writer emits;
- ``decode_groups_coarse`` (twin ``decode_groups_coarse_ref``) takes the
  coarse/fixup tables that tables from other writers need (boundaries
  off the 8-slot grid), with one or two fixups.

Both are bit-identical to the normative coder
``models/rans.py::rans_decode_group`` on every live symbol
(step * 128 + lane below the row's count) and on the words consumed.

``decode_tables`` (twin ``decode_tables_ref``, kernel
``csrc/decode_tables.cu``) builds K1's octet and dense tables on the card
from each segment row's frequency table, bit-identical to
``ops/tables.py::pack_device_tables`` for 8-aligned tables: the packer's
route for every batch whose tables all are.

torch has almost no uint32/uint16 arithmetic, so the uint32 states and
uint16 words travel as int32/int16 tensors holding the same bits: the
kernel reads them as unsigned, and the twins widen to int64 and mask.
"""

import torch

from ..models.rans import GROUP_ROWS, LANES, SCALE_BITS

from . import _build

#: Kernel launches in this process, by lookup form (CUDA calls only; the
#: twins never count): the octet form through :func:`decode_groups`, the
#: coarse forms through :func:`decode_groups_coarse`, and the table
#: builder through :func:`decode_tables`.
launches = {'rans_decode_octet': 0, 'rans_decode_coarse_1fixup': 0,
            'rans_decode_coarse_2fixups': 0, 'decode_tables': 0}
#: K1's forms, indexed by the fixup count.
_FORMS = ('rans_decode_octet', 'rans_decode_coarse_1fixup',
          'rans_decode_coarse_2fixups')

_M32 = 0xFFFFFFFF


def _check_args(states, words, lookup, dense_pk, counts, n_steps, fixups):
    N = states.shape[0]
    name = 'coarse_pk' if fixups else 'octet_pk'
    width = 256 if fixups else LANES
    want = {'states': (states, torch.int32, (N, GROUP_ROWS, LANES)),
            name: (lookup, torch.int32, (N, GROUP_ROWS, width)),
            'dense_pk': (dense_pk, torch.int32, (N, GROUP_ROWS, 256)),
            'counts': (counts, torch.int32, (N, GROUP_ROWS))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError("decode_groups: %s must be %s %s, got %s %s"
                             % (name, dtype, shape, t.dtype, tuple(t.shape)))
    if (words.dtype != torch.int16 or words.dim() != 2
            or words.shape[0] != N or words.shape[1] < 1):
        raise ValueError("decode_groups: words must be int16 (N, W>=1), "
                         "got %s %s" % (words.dtype, tuple(words.shape)))
    if n_steps < 0:
        raise ValueError("decode_groups: n_steps must be >= 0")
    tensors = (states, words, lookup, dense_pk, counts)
    if any(t.device != states.device for t in tensors):
        raise ValueError("decode_groups: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_groups: inputs must be contiguous")


def decode_groups(states, words, octet_pk, dense_pk, counts, n_steps):
    """Decode N groups of 32 rANS segment rows x 128 interleaved lanes.

    states   (N, 32, 128) int32  uint32 decoder start states (bits)
    words    (N, W) int16        each group's merged uint16 word stream
                                 (bits), zero-padded to W
    octet_pk (N, 32, 128) int32  per-row octet tables (``octet_pk`` of
                                 :func:`..tables.pack_device_tables`)
    dense_pk (N, 32, 256) int32  per-row dense tables (``dense_pk``)
    counts   (N, 32) int32       symbols in each row (<= n_steps * 128)

    Returns ``(syms, used)``: (N, 32, n_steps * 128) uint8 row-linear
    symbols (``syms[n, r, s*128 + j]`` is row r's symbol s*128 + j, the
    layout of ``decode_groups_pallas``; columns at or past a row's count
    hold unspecified bytes) and the (N,) int32 words each group consumed
    (callers compare them to the stored stream lengths).
    """
    return _decode(states, words, octet_pk, dense_pk, counts, n_steps, 0)


def decode_groups_coarse(states, words, coarse_pk, dense_pk, counts,
                         n_steps, one_fixup):
    """:func:`decode_groups` for tables without an octet form.

    ``coarse_pk`` (N, 32, 256) int32 holds each row's 256 coarse bucket
    entries (``coarse_pk`` of :func:`..tables.pack_device_tables`,
    flattened). ``one_fixup`` drops the second compare-increment; it is
    exact only when no table has a 16-slot bucket holding three symbols
    (no ``needs_second_fixup``).
    """
    return _decode(states, words, coarse_pk, dense_pk, counts, n_steps,
                   1 if one_fixup else 2)


def decode_groups_ref(states, words, octet_pk, dense_pk, counts, n_steps):
    """Plain PyTorch twin of :func:`decode_groups` (any device)."""
    return _decode_ref(states, words, octet_pk, dense_pk, counts, n_steps,
                       0)


def decode_groups_coarse_ref(states, words, coarse_pk, dense_pk, counts,
                             n_steps, one_fixup):
    """Plain PyTorch twin of :func:`decode_groups_coarse` (any device)."""
    return _decode_ref(states, words, coarse_pk, dense_pk, counts, n_steps,
                       1 if one_fixup else 2)


def _decode(states, words, lookup, dense_pk, counts, n_steps, fixups):
    _check_args(states, words, lookup, dense_pk, counts, n_steps, fixups)
    if states.device.type == 'cpu':
        return _decode_ref(states, words, lookup, dense_pk, counts, n_steps,
                           fixups)
    return _launch(states, words, lookup, dense_pk, counts, n_steps, fixups)


def _launch(states, words, lookup, dense_pk, counts, n_steps, fixups):
    if states.device.type != 'cuda':
        raise ValueError("decode_groups runs on CUDA or CPU tensors, not %s"
                         % states.device)
    for t in (states, words, lookup, dense_pk):
        if t.data_ptr() % 16:
            raise ValueError("decode_groups: inputs must be 16-byte aligned")
    N, W = words.shape
    dev = states.device
    syms = torch.empty((N, GROUP_ROWS, n_steps * LANES), dtype=torch.uint8,
                       device=dev)
    used = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return syms, used
    lib = _build.library()
    rc = lib.mts_rans_decode_groups(
        dev.index, states.data_ptr(), words.data_ptr(), lookup.data_ptr(),
        dense_pk.data_ptr(), counts.data_ptr(), syms.data_ptr(),
        used.data_ptr(), _build.stream_handle(states), N, W, n_steps, fixups)
    _build.check(lib, rc, 'rans_decode_groups')
    launches[_FORMS[fixups]] += 1
    return syms, used


def _decode_ref(states, words, lookup, dense_pk, counts, n_steps, fixups):
    """The twins' decode, vectorized over groups, rows and lanes; one
    iteration per step. The renorm ranks are an exclusive cumsum over the
    row-major (row, lane) flattening, the order the encoder emitted the
    words in. ``fixups`` 0 reads octet tables, 1 or 2 coarse tables.
    """
    N, R, L = states.shape
    dev = states.device
    x = states.reshape(N, R * L).to(torch.int64) & _M32
    w16 = words.to(torch.int64) & 0xFFFF
    W = words.shape[1]
    if fixups:
        coarse = lookup.to(torch.int64) & _M32
    else:
        octet = lookup.contiguous().view(torch.uint8).reshape(
            N, R, 4 * L).to(torch.int64)
    dense = dense_pk.to(torch.int64) & _M32
    cnt = counts.to(torch.int64)[:, :, None]
    lane = torch.arange(L, device=dev)
    syms = torch.empty((N, R, n_steps * L), dtype=torch.uint8, device=dev)
    pos = torch.zeros(N, dtype=torch.int64, device=dev)
    for s in range(n_steps):
        x3 = x.view(N, R, L)
        active = (s * L + lane) < cnt
        slot = x3 & 4095
        if fixups:
            cp = torch.gather(coarse, 2, slot >> 4)
            did = (cp & 255) + (slot > ((cp >> 8) & 4095))
            if fixups == 2:
                did = did + (slot > (cp >> 20))
            did = did & 255
        else:
            did = torch.gather(octet, 2, slot >> 3)
        pk = torch.gather(dense, 2, did)
        syms[:, :, s * L:(s + 1) * L] = (pk >> 24).to(torch.uint8)
        upd = (((pk >> 12) & 4095) * (x3 >> SCALE_BITS) + slot
               - (pk & 4095)) & _M32
        x = torch.where(active, upd, x3).reshape(N, R * L)
        need = (active.reshape(N, R * L) & (x < (1 << 16)))
        idx = pos[:, None] + torch.cumsum(need, 1) - need.to(torch.int64)
        w = torch.gather(w16, 1, idx.clamp(max=W - 1))
        w = torch.where(idx < W, w, 0)
        x = torch.where(need, ((x << 16) | w) & _M32, x)
        pos += need.sum(1)
    return syms, pos.to(torch.int32)


def decode_tables(freqs, rows):
    """K1's octet and dense tables of each segment row, built on the
    tensors' device from the rows' frequency tables.

    freqs (U, 256) int16   uint16 frequency tables (bits)
    rows  (N, 32) int32    each segment row's table in ``freqs``; -1 for a
                           row without a segment

    Returns ``(octet_pk (N, 32, 128) int32, dense_pk (N, 32, 256) int32)``:
    for a row of table u, the ``octet_pk`` and ``dense_pk`` (flattened)
    that :func:`..tables.pack_device_tables` gives ``freqs[u]``, bit for
    bit where the table is 8-aligned (the octet form is defined only
    there); zeros for a row of -1 or of an index outside ``freqs``.
    """
    _check_table_args(freqs, rows)
    if freqs.device.type == 'cpu':
        return decode_tables_ref(freqs, rows)
    if freqs.device.type != 'cuda':
        raise ValueError("decode_tables runs on CUDA or CPU tensors, not %s"
                         % freqs.device)
    dev = freqs.device
    N = rows.shape[0]
    octet = torch.empty((N, GROUP_ROWS, LANES), dtype=torch.int32,
                        device=dev)
    dense = torch.empty((N, GROUP_ROWS, 256), dtype=torch.int32, device=dev)
    if N == 0:
        return octet, dense
    lib = _build.library()
    rc = lib.mts_decode_tables(
        dev.index, freqs.data_ptr(), rows.data_ptr(), octet.data_ptr(),
        dense.data_ptr(), _build.stream_handle(freqs), N * GROUP_ROWS,
        freqs.shape[0])
    _build.check(lib, rc, 'decode_tables')
    launches['decode_tables'] += 1
    return octet, dense


def _check_table_args(freqs, rows):
    if (freqs.dtype != torch.int16 or freqs.dim() != 2
            or freqs.shape[1] != 256):
        raise ValueError("decode_tables: freqs must be int16 (U, 256), got "
                         "%s %s" % (freqs.dtype, tuple(freqs.shape)))
    if (rows.dtype != torch.int32 or rows.dim() != 2
            or rows.shape[1] != GROUP_ROWS):
        raise ValueError("decode_tables: rows must be int32 (N, %d), got "
                         "%s %s" % (GROUP_ROWS, rows.dtype,
                                    tuple(rows.shape)))
    if rows.device != freqs.device:
        raise ValueError("decode_tables: freqs and rows must be on one "
                         "device")
    if not (freqs.is_contiguous() and rows.is_contiguous()):
        raise ValueError("decode_tables: inputs must be contiguous")


def decode_tables_ref(freqs, rows):
    """Plain PyTorch twin of :func:`decode_tables` (any device): each
    table built once, then gathered by row."""
    dev = freqs.device
    U = freqs.shape[0]
    f = freqs.to(torch.int64) & 0xFFFF
    present = f > 0
    upper = torch.cumsum(f, 1)
    ranks = torch.cumsum(present, 1)
    sym = torch.arange(256, device=dev)
    entry = ((sym << 24) | (f << 12) | (upper - f)) & _M32
    # The i-th present symbol's entry at i; absent symbols go to a column
    # that is dropped.
    dense = torch.zeros((U, 257), dtype=torch.int64, device=dev)
    dense.scatter_(1, torch.where(present, ranks - 1, 256), entry)
    dense = dense[:, :256]
    # searchsorted(upper bounds of the present symbols, 8 * o, 'right'):
    # the symbols whose upper bound is <= 8 * o are a prefix of all 256
    # (the bounds never fall), and the present ones among them count.
    slots = (8 * torch.arange(512, device=dev)).expand(U, 512).contiguous()
    j = torch.searchsorted(upper, slots, right=True)
    ids = torch.gather(torch.nn.functional.pad(ranks, (1, 0)), 1, j)
    octet = (ids[:, 0::4] | (ids[:, 1::4] << 8) | (ids[:, 2::4] << 16)
             | (ids[:, 3::4] << 24)) & _M32
    # Rows of no table read an all-zero row appended at index U.
    idx = rows.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < U), idx, U)
    zero = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    return (_as_i32(torch.cat([octet, zero.expand(1, 128)])[idx]),
            _as_i32(torch.cat([dense, zero.expand(1, 256)])[idx]))


def _as_i32(a):
    """int64 values in [0, 2**32) -> the int32 tensor of the same bits."""
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)
