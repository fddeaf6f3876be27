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

torch has almost no uint32/uint16 arithmetic, so the uint32 states and
uint16 words travel as int32/int16 tensors holding the same bits: the
kernel reads them as unsigned, and the twins widen to int64 and mask.
"""

import torch

from ..models.rans import GROUP_ROWS, LANES, SCALE_BITS

from . import _build

#: Kernel launches in this process, by lookup form (CUDA calls only; the
#: twins never count): the octet form through :func:`decode_groups`, the
#: coarse forms through :func:`decode_groups_coarse`.
launches = {'rans_decode_octet': 0, 'rans_decode_coarse_1fixup': 0,
            'rans_decode_coarse_2fixups': 0}
_FORMS = tuple(launches)                  # indexed by the fixup count

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
