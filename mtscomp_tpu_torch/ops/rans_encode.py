"""K6: grouped rANS encode, the port's counterpart of
``mtscomp_tpu/ops/pallas_rans_enc.py`` (``encode_groups_pallas``) and of
the XLA scan encoder ``mtscomp_tpu/ops/device_rans.py``
(``encode_groups`` + ``compact_words``).

:func:`encode_groups` launches the hand-written CUDA kernel
(``csrc/rans_encode.cu``) for CUDA tensors and runs its plain PyTorch
twin :func:`encode_groups_ref` for CPU tensors; nothing else selects
between them. Both are bit-identical to the normative coder
``models/rans.py::rans_encode_group``: the same decoder start states,
the same merged word stream and the same word count.

The stream of each group is written right-anchored in a region of
``cap`` words (the kernel encodes backward, and a word's decoder-order
place is known only from the stream's end): group n's stream is
``words[n, cap - n_words[n]:]``. At most one word is emitted per live
symbol, so ``cap`` = the largest group's symbol count always suffices;
a count beyond the region can only mean a fault, and raises.

torch has almost no uint32/uint16 arithmetic, so the uint32 tables and
states and the uint16 words travel as int32/int16 tensors holding the
same bits: the kernel reads them as unsigned, the twin widens to int64
and masks.
"""

import numpy as np
import torch

from ..device import to_host
from ..models.rans import GROUP_ROWS, LANES, RANS_L, encoder_tables
from . import _build
from .device_delta import wrap_to

#: Kernel launches in this process (CUDA calls only; the twin never
#: counts).
launches = {'rans_encode': 0}

_M32 = 0xFFFFFFFF


def pack_encoder_tables(freqs):
    """(..., 256) frequency tables -> ``(pk, rcp)`` int32 arrays of the
    same shape holding :func:`~..models.rans.encoder_tables`' uint32
    bits (``pk = rcp_shift << 25 | cmpl << 12 | cum``; ``rcp`` the
    round-up reciprocal), the kernel's table input."""
    pk, rcp = encoder_tables(freqs)
    return pk.view(np.int32), rcp.view(np.int32)


def symbol_capacity(counts):
    """Words to provision per group for (N, 32) row ``counts``: the
    largest group's symbol count (at least 1)."""
    counts = np.asarray(counts, dtype=np.int64)
    return max(int(counts.sum(axis=1).max(initial=0)), 1)


def _check_args(symbols, pk, rcp, counts, cap):
    N = symbols.shape[0] if symbols.dim() == 3 else -1
    if (symbols.dtype != torch.uint8 or symbols.dim() != 3
            or symbols.shape[1] != GROUP_ROWS or symbols.shape[2] % LANES):
        raise ValueError("encode_groups: symbols must be uint8 (N, 32, "
                         "S*128), got %s %s" % (symbols.dtype,
                                                tuple(symbols.shape)))
    want = {'pk': (pk, (N, GROUP_ROWS, 256)),
            'rcp': (rcp, (N, GROUP_ROWS, 256)),
            'counts': (counts, (N, GROUP_ROWS))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError("encode_groups: %s must be int32 %s, got %s %s"
                             % (name, shape, t.dtype, tuple(t.shape)))
    if cap < 1:
        raise ValueError("encode_groups: cap must be >= 1")
    tensors = (symbols, pk, rcp, counts)
    if any(t.device != symbols.device for t in tensors):
        raise ValueError("encode_groups: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("encode_groups: inputs must be contiguous")


def encode_groups(symbols, pk, rcp, counts, cap):
    """Encode N groups of 32 rANS segment rows x 128 interleaved lanes.

    symbols (N, 32, S*128) uint8  row-linear segment rows (row r's symbol
                                  i at ``[n, r, i]``), zero-padded
    pk      (N, 32, 256) int32    per-row packed tables, ``rcp`` (N, 32,
                                  256) int32 the reciprocals
                                  (:func:`pack_encoder_tables`)
    counts  (N, 32) int32         symbols in each row (<= S*128)
    cap     int                   words per group region (at least the
                                  largest group's symbol count:
                                  :func:`symbol_capacity`)

    Returns ``(states, words, n_words)``: (N, 32, 128) int32 decoder
    start states (uint32 bits; rows with count 0 keep the initial
    state), (N, cap) int16 right-anchored streams (uint16 bits; outside
    ``words[n, cap - n_words[n]:]`` the kernel leaves unspecified
    values, the twin zeros) and the (N,) int32 word counts. Raises
    ``RuntimeError`` when a count exceeds ``cap``.
    """
    _check_args(symbols, pk, rcp, counts, cap)
    if symbols.device.type == 'cpu':
        out = encode_groups_ref(symbols, pk, rcp, counts, cap)
    else:
        out = _launch(symbols, pk, rcp, counts, cap)
    n_max = int(out[2].max()) if out[2].numel() else 0
    if n_max > cap:
        raise RuntimeError("encode_groups: a group emitted %d words into a "
                           "%d-word region" % (n_max, cap))
    return out


def _launch(symbols, pk, rcp, counts, cap):
    if symbols.device.type != 'cuda':
        raise ValueError("encode_groups runs on CUDA or CPU tensors, not %s"
                         % symbols.device)
    for t in (symbols, pk, rcp):
        if t.data_ptr() % 16:
            raise ValueError("encode_groups: inputs must be 16-byte aligned")
    N = symbols.shape[0]
    dev = symbols.device
    states = torch.empty((N, GROUP_ROWS, LANES), dtype=torch.int32,
                         device=dev)
    words = torch.empty((N, cap), dtype=torch.int16, device=dev)
    n_words = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return states, words, n_words
    lib = _build.library()
    rc = lib.mts_rans_encode_groups(
        dev.index, symbols.data_ptr(), pk.data_ptr(), rcp.data_ptr(),
        counts.data_ptr(), states.data_ptr(), words.data_ptr(),
        n_words.data_ptr(), _build.stream_handle(symbols), N,
        symbols.shape[2] // LANES, cap)
    _build.check(lib, rc, 'rans_encode_groups')
    launches['rans_encode'] += 1
    return states, words, n_words


def _mulhi32(x, r):
    """High 32 bits of the uint32 product of int64 ``x`` and ``r`` (both
    in [0, 2^32)), in 16-bit limbs so that no partial product leaves
    int64."""
    xh, xl = x >> 16, x & 0xFFFF
    rh, rl = r >> 16, r & 0xFFFF
    return xh * rh + ((xh * rl + xl * rh + ((xl * rl) >> 16)) >> 16)


def encode_groups_ref(symbols, pk, rcp, counts, cap):
    """Plain PyTorch twin of :func:`encode_groups` (any device): the
    kernel's arithmetic, vectorized over (N, 32, 128) with one iteration
    per step, backward; then the words are compacted in decoder order
    (steps ascending, row-major within a step) to the right end of each
    group's region."""
    _check_args(symbols, pk, rcp, counts, cap)
    N, R, SK = symbols.shape
    S = SK // LANES
    dev = symbols.device
    pk64 = pk.to(torch.int64) & _M32
    rcp64 = rcp.to(torch.int64) & _M32
    cnt = counts.to(torch.int64)[:, :, None]
    lane = torch.arange(LANES, device=dev)
    x = torch.full((N, R, LANES), RANS_L, dtype=torch.int64, device=dev)
    word_steps = torch.zeros((S, N, R * LANES), dtype=torch.int32,
                             device=dev)
    emit_steps = torch.zeros((S, N, R * LANES), dtype=torch.bool, device=dev)
    for s in range(S - 1, -1, -1):
        active = (s * LANES + lane) < cnt
        sy = symbols[:, :, s * LANES:(s + 1) * LANES].to(torch.int64)
        p = torch.gather(pk64, 2, sy)
        r = torch.gather(rcp64, 2, sy)
        cmpl = (p >> 12) & 8191
        emit = active & ((x >> 20) >= 4096 - cmpl)
        word_steps[s] = (x & 0xFFFF).to(torch.int32).reshape(N, R * LANES)
        emit_steps[s] = emit.reshape(N, R * LANES)
        x = torch.where(emit, x >> 16, x)
        t = _mulhi32(x, r)
        q = (((x - t) >> 1) + t) >> (p >> 25)
        x = torch.where(active, (x + (p & 4095) + q * cmpl) & _M32, x)
    e = emit_steps.permute(1, 0, 2).reshape(N, S * R * LANES)
    w = word_steps.permute(1, 0, 2).reshape(N, S * R * LANES)
    n_words = e.sum(dim=1)
    rank = torch.cumsum(e, dim=1) - 1
    pos = cap - n_words[:, None] + rank
    words = torch.zeros((N, cap), dtype=torch.int16, device=dev)
    flat = (torch.arange(N, device=dev)[:, None] * cap + pos)[e & (pos >= 0)]
    words.view(-1)[flat] = wrap_to(w[e & (pos >= 0)].to(torch.int64),
                                   torch.int16)
    return wrap_to(x, torch.int32), words, n_words.to(torch.int32)


def left_align(words, n_words):
    """The right-anchored streams of :func:`encode_groups` as host arrays:
    ``(flat, n_words)`` with ``flat`` the concatenated uint16 streams in
    group order (group n's at ``flat[off[n]:off[n] + n_words[n]]``) and
    ``n_words`` the (N,) host counts. One slice per group on the device,
    then one fetch of the used words."""
    nw = to_host(n_words).astype(np.int64)
    cap = words.shape[1]
    if nw.size == 0 or not nw.any():
        return np.zeros(0, np.uint16), nw
    used = torch.cat([words[n, cap - k:] for n, k in enumerate(nw.tolist())])
    return to_host(used).view(np.uint16), nw
