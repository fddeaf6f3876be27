"""Batched GPU decode and encode: ``mtscomp_tpu/parallel/pipeline.py``
ported to PyTorch.

Decode.

A batch of B chunk containers is parsed on the host, staged as tensors
(:meth:`DeviceBatchDecoder.pack`: the JAX package's arrays, with word
buffers of the card's size), and decoded by eager calls into the port's
kernels. K1
(grouped rANS decode, ``ops/rans_decode.py``) writes each group's
row-linear byte rows; then one of two routes, the JAX package's
``_build_decode_fn`` branches:

- **fuse8**: int16/uint16 F-order chunks with a first-order time diff
  (or second: K5 follows), no spatial diff, channel-aligned segments and
  one rANS-coded low byte plane under a constant high byte. K1's rows ARE
  channels, and the fused finalize (K2/K3, ``ops/device_delta.py``) turns
  them into the (B, T, C) samples. Unlike the JAX package, any segment
  width, step count and ragged tail takes it (``_fuse8_geom``).
- **generic**: everything else that ``supported()`` accepts (1-, 2-, 4-
  and 8-byte integers and bitcast floats, rANS/CONST/RAW planes in any
  mix, C or F order, spatial diff, first- or second-order time diff,
  flags bit6 without the tail packing). 2-byte F-order time-diff chunks
  without a spatial diff whose rANS planes sit in K1's rows as whole
  channel-aligned segments (``Layout.plane_form``) go from K1 straight
  into K4's plane form, which reads the byte planes in place, combines
  them, undoes the zigzag, scans and transposes. For every other layout
  the byte planes are reassembled and combined and the inverse zigzag
  applied in plain torch; then K4's element form (fused transpose + time
  scan) for F-order time-diff chunks without a spatial diff, and
  otherwise the layout, spatial cumsum and K5 passes. 8-byte elements
  take the int64 forms of K4 and K5, which the JAX package lacks (JAX
  without x64 has no int64 tensor, so it decodes them on its host
  codec).

K1 uses octet tables when every table of the batch is 8-aligned (what
this codec's writer emits), built on the card from the containers'
frequency tables (``decode_tables``, ``csrc/decode_tables.cu``), and its
coarse/fixup form, packed on the host, otherwise. Unlike
the JAX package, the port always runs K1: the TPU's switch to a scan
decoder for word streams beyond its VMEM window has no cause on the
H100.

Chunks ``supported()`` declines even alone (a non-native byte order, a
head that is not one full row) decode on the host codec, and the module
counts them (``host_fallback_chunks``).

Encode (:class:`DeviceBatchEncoder`, the Writer's route for ans files):
a batch of equal-shape chunks is uploaded once; diffs, zigzag, the
F-order transpose, the byte planes and their histograms run in plain
torch (``_build_transform_fn``); the plane decisions and segment tables
are made on the host by the codec's own ``decide_plane``; the coded
planes are gathered into (N, 32, S*128) segment rows; K6 (grouped rANS
encode, ``ops/rans_encode.py``) writes each group's states and
right-anchored word stream; the streams are left-aligned and fetched
once, and the containers assembled on the host, byte-identical to the
host codec's. It takes 1-, 2-, 4- and 8-byte elements, every layout and
table mode and mode-uniform sub-batches of any length; chunks
``supported()`` declines go to the host codec and are counted
(``host_encoded_chunks``).
"""

import collections
import dataclasses
import functools
import json
import math
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_all

import numpy as np
import torch

from ..codec import ans as ans_mod
from ..codec.ans import (MODE_CONST, MODE_RANS, MODE_RAW, peek_desc,
                         segment_counts)
from ..codec.ans import seg_freqs as ans_seg_freqs
from ..device import resolve_device, to_device, to_host
from ..format import decode_identity
from ..io_host import pread_exact
from ..models import rans
from ..models.rans import GROUP_ROWS, LANES, RANS_L
from ..ops.delta import cumsum_along_axis
from ..ops.device_delta import (cumsum_space, cumsum_time,
                                cumsum_time_transposed,
                                cumsum_time_transposed_planes,
                                cumsum_time_transposed_u8,
                                cumsum_time_transposed_u8_tail,
                                diff_space, diff_time, zigzag_decode,
                                zigzag_encode)
from ..ops.device_hist import histogram256
from ..ops.rans_decode import (decode_groups, decode_groups_coarse,
                                decode_tables)
from ..ops.rans_encode import (encode_groups, left_align,
                               pack_encoder_tables, symbol_capacity)
from ..ops.tables import pack_device_tables
from ..utils.misc import logger
from ..utils.trace import count, phase
from .mesh import mesh_devices, on_device

#: Chunks decoded on the host codec because ``supported()`` declined
#: their batch (the codec's documented semantics, as in the JAX package).
host_fallback_chunks = 0

#: Chunks the Writer's device route encoded on the host codec (the same
#: bytes): batches ``DeviceBatchEncoder.supported()`` declines (a
#: non-native byte order, 65536 channels or more).
host_encoded_chunks = 0

#: Tensor dtype holding a coding dtype's bits, by item size (unsigned
#: dtypes travel as the signed bits of their width: uint64 as int64).
_BITS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.int16),
         4: (torch.int32, np.int32), 8: (torch.int64, np.int64)}


# --- measured profiles of the 'auto' route ---------------------------------

#: CUDA device index -> measured ``(sync_latency_s, device->host
#: bytes_per_s)``, filled by :func:`link_profile`.
_LINK_PROFILE = {}


def link_profile(refresh=False, device='cuda'):
    """Measured ``(sync_latency_s, device->host_bytes_per_s)`` of the
    link to ``device``; cached per CUDA device index after the first
    call, in this process and on disk (24 h).

    ``'auto'`` routing (``Writer._use_device`` / ``Reader._use_device``)
    must know what a sync and a fetch cost, because every decoded byte a
    caller sees crosses this link. Measured, not configured: the best of
    3 round trips of a tiny device reduction fetched with ``.item()``
    bounds the latency, and 256 KB of fresh host-random words, uploaded
    and xor'd on the card at each rep so that no fetch reads a buffer it
    already copied, fetched with ``.cpu()`` into pageable memory (a
    pageable fetch; ``to_array()`` fetches through a pinned staging
    ring, :class:`StagingRing`), bound the bandwidth. A CPU device reports
    (0, inf): its tensors are host memory already.
    """
    dev = torch.device(device)
    # The device type BEFORE the caches: a CPU device never reads a
    # profile measured for a card.
    if dev.type == 'cpu':
        return (0.0, float('inf'))
    index = dev.index
    if index is None:
        # 'cuda' is the current device: 0 until CUDA is initialized.
        index = torch.cuda.current_device() \
            if torch.cuda.is_initialized() else 0
    if not refresh:
        if index in _LINK_PROFILE:
            return _LINK_PROFILE[index]
        cached = _load_profile_cache('link_profile_cuda%d.json' % index,
                                     _LINK_KEYS)
        if cached is not None:
            _LINK_PROFILE[index] = cached
            return cached
    dev = torch.device('cuda', index)
    small = torch.zeros((8, LANES), dtype=torch.float32, device=dev)
    small.sum().item()                      # first launch and fetch
    lat = min(_timed(lambda: small.sum().item()) for _ in range(3))
    payload = np.random.default_rng(0).integers(
        0, 1 << 32, size=(1 << 16,), dtype=np.uint32).view(np.int32)
    fetches = []
    for i in range(3):
        fresh = torch.from_numpy(payload).to(dev) ^ (i + 1)
        fetches.append(_timed(lambda d=fresh: d.cpu()))
    bw = payload.nbytes / max(min(fetches) - lat, 1e-7)
    _LINK_PROFILE[index] = (lat, bw)
    logger.debug("Link profile of cuda:%d: sync %.3f ms, fetch %.0f MB/s.",
                 index, lat * 1e3, bw / 1e6)
    _store_profile_cache('link_profile_cuda%d.json' % index, _LINK_KEYS,
                         (lat, bw))
    return (lat, bw)


_PROFILE_CACHE_TTL = 24 * 3600.0
_LINK_KEYS = ('latency_s', 'bytes_per_s')


def _profile_cache_path(name):
    """The port's own cache: the JAX package's ``~/.cache/mtscomp_tpu``
    holds the profile of the link it saw, which says nothing of a card."""
    return os.path.join(os.path.expanduser('~/.cache/mtscomp_tpu_torch'),
                        name)


def _load_profile_cache(name, keys):
    """Probing costs time (a CUDA context for the link, ~100 ms of codec
    work for the host): one measured profile serves every process on the
    machine for a day. A stale entry only costs speed, never
    correctness (every route is byte-exact)."""
    try:
        path = _profile_cache_path(name)
        if time.time() - os.stat(path).st_mtime > _PROFILE_CACHE_TTL:
            return None
        with open(path) as f:
            d = json.load(f)
        return tuple(float(d[k]) for k in keys)
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _store_profile_cache(name, keys, values):
    try:
        path = _profile_cache_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = '%s.%d.tmp' % (path, os.getpid())
        with open(tmp, 'w') as f:
            json.dump(dict(zip(keys, values)), f)
        os.replace(tmp, path)
    except OSError:  # pragma: no cover - the cache is best-effort
        pass


_HOST_PROFILE = None
_HOST_KEYS = ('encode_bytes_per_s', 'decode_bytes_per_s')
#: Used if the measurement itself fails (never expected): ~300 MB/s
#: encode and ~250 MB/s decode per core, the JAX package's estimates.
_HOST_FALLBACK = (300e6, 250e6)


def host_profile(refresh=False):
    """Measured ``(encode_bytes_per_s, decode_bytes_per_s)`` of ONE host
    core running the ans codec on a synthetic Neuropixels-like block;
    cached in this process and on disk (24 h, beside the link profiles).

    ``'auto'`` routing weighs the link against the host codec; timing
    the codec's own entry points on a 4 MB block (~100 ms with the C++
    runtime) makes the decision derive from two measurements, and sees
    whether the native runtime is loaded.
    """
    global _HOST_PROFILE
    if _HOST_PROFILE is not None and not refresh:
        return _HOST_PROFILE
    if not refresh:
        cached = _load_profile_cache('host_profile.json', _HOST_KEYS)
        if cached is not None:
            _HOST_PROFILE = cached
            return _HOST_PROFILE
    _HOST_PROFILE = _measure_host_rates()
    logger.debug("Host codec profile: encode %.0f MB/s, decode %.0f MB/s "
                 "per core.", _HOST_PROFILE[0] / 1e6, _HOST_PROFILE[1] / 1e6)
    _store_profile_cache('host_profile.json', _HOST_KEYS, _HOST_PROFILE)
    return _HOST_PROFILE


def _measure_host_rates():
    """Single-thread codec rates on a 4 MB chunk (16384 x 128 int16),
    best of 3: encode with the fused time-diff prep (what
    ``Writer._compress_chunk`` runs) and decode + in-place inverse cumsum
    (what ``Reader.read_chunk`` runs). The routes it separates differ by
    far more than scheduler jitter."""
    try:
        ns, nc = 16384, 128
        rng = np.random.default_rng(0)
        arr = np.ascontiguousarray(np.cumsum(
            rng.normal(0.0, 6.0, size=(ns, nc)), axis=0).astype(np.int16))
        codec = ans_mod.AnsCodec()
        enc_t = dec_t = float('inf')
        payload = None
        for _ in range(3):
            t0 = time.perf_counter()
            payload = codec.encode(arr, order='F', time_diff_pending=True)
            enc_t = min(enc_t, time.perf_counter() - t0)
        for _ in range(3):
            t0 = time.perf_counter()
            out = codec.decode(payload, ns, nc, arr.dtype, order='F')
            cumsum_along_axis(out, axis=0, inplace=True)
            dec_t = min(dec_t, time.perf_counter() - t0)
        return (arr.nbytes / max(enc_t, 1e-7), arr.nbytes / max(dec_t, 1e-7))
    except Exception:  # pragma: no cover - fallback only
        logger.debug("Host codec rate probe failed; using fallback "
                     "estimates.", exc_info=True)
        return _HOST_FALLBACK


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _fuse8_geom(modes, dtype, zigzag, order, do_time_diff, do_spatial_diff,
                seg, tp, S, aligned, has_head):
    """``(fuse8, k)``: whether a batch takes the fused u8 route, and its
    channels per segment.

    One rANS-coded low byte plane under a CONST high byte of 2-byte
    F-order time-diff chunks without a spatial diff, whose segments are
    whole rows of ``k`` channels (``seg_eff == seg``: K1's row of S * 128
    symbols is then exactly k channel rows of ``tp``, so its output views
    as the finalize's (B, channels, tp) block with no copy). The JAX
    package also asks for a Pallas step block (a divisor of S in 8..128),
    a 128-lane channel tile (k a multiple of 4) and tp >= T: K1 on the
    card has no step blocks, the finalize takes any channel stride and
    T <= tp + 1 samples (``FINALIZE_EDGE_CASES`` holds it on the card at
    odd channel counts and at T = tp + 1).
    """
    rans_planes = [p for p, m in enumerate(modes) if m == MODE_RANS]
    const_planes = [p for p, m in enumerate(modes) if m == MODE_CONST]
    raw_planes = [p for p, m in enumerate(modes) if m == MODE_RAW]
    k = (seg // tp) if aligned and tp else 0
    seg_eff = min(seg, S * LANES) if rans_planes else 0
    i16_kind = dtype in (np.dtype(np.int16), np.dtype(np.uint16))
    fuse8 = (bool(rans_planes) and aligned and has_head
             and rans_planes == [0] and not raw_planes
             and len(const_planes) == 1
             and i16_kind and zigzag
             and order == 'F' and do_time_diff and not do_spatial_diff
             and seg_eff == seg)
    return fuse8, k


def _k1(states, words, lookup, dense_pk, counts, S, fixups):
    """K1 with the batch's table form: octet (0) or 1/2 fixups."""
    if fixups:
        return decode_groups_coarse(states, words, lookup, dense_pk, counts,
                                    S, one_fixup=fixups == 1)
    return decode_groups(states, words, lookup, dense_pk, counts, S)


def _decode_fuse8(states, words, lookup, dense_pk, counts, const_vals,
                  _raw_vals, heads, *, B, T, G, S, k, tp, tail, fixups,
                  diff_order):
    """Eager fuse8 decode -> ``((B, T, C) int16, (B*G,) int32 words used)``.

    ``tail`` is the packer's ragged-tail decision: None, or ``(rem, ctB,
    rows_n)`` when each chunk's last group holds only the ``rem``
    leftover channels as sub-rows of ``rows_n`` symbols, packed after
    all full groups.
    """
    syms, used = _k1(states, words, lookup, dense_pk, counts, S, fixups)
    bulk, tail_block = fuse8_planes(syms, B=B, G=G, k=k, tp=tp, tail=tail)
    hi = const_vals[:, 0]
    if tail is None:
        out = cumsum_time_transposed_u8(bulk, heads, hi, n_samples=T)
    else:
        cA = bulk.shape[1]                 # == C - rem
        out = cumsum_time_transposed_u8_tail(bulk, tail_block, heads[:, :cA],
                                             heads[:, cA:], hi, n_samples=T)
        # Back to chunk-major group order for the word audit.
        NF = B * (G - 1)
        used = torch.cat([used[:NF].view(B, G - 1), used[NF:].view(B, 1)],
                         dim=1).reshape(-1)
    # The finalize inverted the second diff (d2 -> d1); one more carried
    # scan restores the samples.
    for _ in range(diff_order - 1):
        out = cumsum_time(out)
    return out, used


def fuse8_planes(syms, *, B, G, k, tp, tail):
    """K1's row-linear symbols as the finalize's channel blocks.

    Returns ``(bulk, tail_block)``: a (B, channels, tp) no-copy view of
    the full groups, and the (B, rem, tp) ragged-tail channels gathered
    from their sub-rows (None without a ragged tail).
    """
    if tail is None:
        return syms.view(B, G * GROUP_ROWS * k, tp), None
    rem, _ctB, rows_n = tail
    NF = B * (G - 1)                       # full groups, chunk-major
    bulk = syms[:NF].view(B, (G - 1) * GROUP_ROWS * k, tp)
    tail_block = torch.cat([syms[NF:, r, :n] for r, n in enumerate(rows_n)],
                           dim=1).view(B, rem, tp)
    return bulk, tail_block


@dataclasses.dataclass(frozen=True)
class Layout:
    """One batch's geometry on the generic route (what the JAX package
    keys its compiled ``_build_decode_fn`` on)."""

    B: int                      # chunks
    T: int                      # samples per chunk
    C: int                      # channels
    itemsize: int               # bytes per element (1, 2, 4 or 8)
    modes: tuple                # per byte plane: MODE_RAW/RANS/CONST
    n_seg: int                  # segments per rANS plane
    seg: int                    # symbols per segment
    G: int                      # groups per chunk
    S: int                      # K1 steps (row width / 128)
    order: str                  # 'F' or 'C'
    do_time_diff: bool
    diff_order: int             # 1 or 2
    do_spatial_diff: bool
    zigzag: bool
    has_head: bool              # the first sample is stored verbatim
    aligned: bool               # channel-aligned segments (flags bit2)
    tail_split: int             # flags bit6 sub-rows (1 = off)
    fixups: int                 # K1 lookup: 0 octet, 1 or 2 coarse

    def planes(self, mode):
        return [p for p, m in enumerate(self.modes) if m == mode]

    @property
    def Tc(self):
        """Coded samples per channel (the head row is stored apart)."""
        return self.T - 1 if self.has_head else self.T

    @property
    def tp(self):
        """Per-channel stream length, padded to 128 (aligned layouts)."""
        return -(-self.Tc // LANES) * LANES if self.aligned else 0

    @property
    def n_stream(self):
        return self.C * self.tp if self.aligned else self.Tc * self.C

    @property
    def plane_form(self):
        """Whether K4's plane form decodes the batch: 2-byte elements of
        F-order time-diff chunks without a spatial diff, whose rANS
        planes lie in K1's rows as whole channel-aligned segments (no
        bit6 sub-rows, a row exactly one segment), so that each plane is
        a strided view of those rows."""
        return (self.itemsize == 2 and self.order == 'F'
                and self.do_time_diff and not self.do_spatial_diff
                and self.aligned and self.tail_split == 1
                and bool(self.planes(MODE_RANS))
                and self.seg == self.S * LANES)


def _decode_generic(states, words, lookup, dense_pk, counts, const_vals,
                    raw_vals, heads, *, lay):
    """Eager generic decode -> ``((B, T, C) bits, words used)``; the
    samples come as the coding dtype's bits (``_BITS``)."""
    if lay.planes(MODE_RANS):
        syms, used = _k1(states, words, lookup, dense_pk, counts, lay.S,
                         lay.fixups)
    else:
        syms = None
        used = torch.zeros((lay.B,), dtype=torch.int32, device=heads.device)
    if lay.plane_form:
        lo, hi = generic_planes(syms, const_vals, raw_vals, lay)
        out = cumsum_time_transposed_planes(
            lo, hi, heads if lay.has_head else None, n_samples=lay.T,
            zigzag=lay.zigzag)
        for _ in range(lay.diff_order - 1):
            out = cumsum_time(out)
        return out, used
    elems = generic_elems(syms, const_vals, raw_vals, lay)
    return generic_samples(elems, heads, lay), used


def generic_planes(syms, const_vals, raw_vals, lay):
    """The two byte planes of a ``lay.plane_form`` batch as K4's plane
    form takes them, with no copy: a rANS plane is the (B, C, Tc) view of
    K1's rows (plane j starts at row ``j * n_seg``, channel c at ``c *
    tp`` within it; the ``tp - Tc`` pad bytes are never read), a RAW
    plane the (B, C, Tc) view of its staged bytes, a CONST plane its (B,)
    values."""
    B, C, Tc, tp = lay.B, lay.C, lay.Tc, lay.tp
    flat = None if syms is None else syms.view(B, -1)
    planes = []
    for p, mode in enumerate(lay.modes):
        j = lay.planes(mode).index(p)
        if mode == MODE_RANS:
            start = j * lay.n_seg * lay.seg
            planes.append(flat[:, start:start + C * tp].view(B, C, tp)
                          [:, :, :Tc])
        elif mode == MODE_RAW:
            planes.append(raw_vals[:, j].view(B, C, Tc))
        else:
            planes.append(const_vals[:, j])
    return planes


def generic_elems(syms, const_vals, raw_vals, lay):
    """K1's rows (None without a rANS plane) and the CONST/RAW planes ->
    the (B, Tc*C) coded elements in F or C order (plane combine, inverse
    zigzag), as the coding dtype's bits."""
    B, C, Tc = lay.B, lay.C, lay.Tc
    n_elems = Tc * C
    acc = torch.empty((B, n_elems, lay.itemsize), dtype=torch.uint8,
                      device=const_vals.device)
    rans = lay.planes(MODE_RANS)
    if rans:
        planes = _rans_planes(syms, lay)
        for j, p in enumerate(rans):
            acc[:, :, p] = planes[:, j]
    for j, p in enumerate(lay.planes(MODE_CONST)):
        acc[:, :, p] = const_vals[:, j:j + 1]
    for j, p in enumerate(lay.planes(MODE_RAW)):
        acc[:, :, p] = raw_vals[:, j]
    # Little-endian byte planes, LSB first: the element's bits.
    elems = acc.view(_BITS[lay.itemsize][0]).view(B, n_elems)
    return zigzag_decode(elems) if lay.zigzag else elems


def _rans_planes(syms, lay):
    """(B*G, 32, S*128) row-linear symbols -> (B, n_rans, Tc*C) plane
    streams: the row reshape (or, with flags bit6, the reassembly of each
    row's real symbol range), then the drop of each channel's zero pad."""
    B, n_rans = lay.B, len(lay.planes(MODE_RANS))
    rows = syms.view(B, lay.G * GROUP_ROWS, lay.S * LANES)
    n_stream = lay.n_stream
    if lay.tail_split > 1:
        # The flat segment list is not uniform (the ragged tail is M
        # sub-rows): concatenate each row's real symbols.
        seg_list = segment_counts(n_stream, lay.seg, lay.modes,
                                  lay.tail_split)
        planes = torch.cat([rows[:, r, :n] for r, (_p, _s, n)
                            in enumerate(seg_list)], dim=1)
        planes = planes.view(B, n_rans, n_stream)
    else:
        seg_eff = min(lay.seg, lay.S * LANES)
        planes = rows[:, :n_rans * lay.n_seg, :seg_eff].reshape(
            B, n_rans, lay.n_seg * seg_eff)[:, :, :n_stream]
    if lay.aligned:
        planes = planes.reshape(B, n_rans, lay.C, lay.tp)[:, :, :, :lay.Tc]
    return planes.reshape(B, n_rans, lay.Tc * lay.C)


def generic_samples(elems, heads, lay):
    """(B, Tc*C) decoded elements + (B, C) heads -> the (B, T, C) samples
    (bits), for the layouts K4's plane form does not take
    (``Layout.plane_form``): K4's element form for F-order time-diff
    chunks without a spatial diff (the head seeds its exclusive scan in
    place of the JAX package's head concatenation: same bytes), else
    layout, head row, spatial cumsum and K5 passes. 1-byte data is
    widened to int16, scanned modulo 2^16 and its low byte kept (mod 256
    is a quotient of mod 2^16)."""
    B, T, C, Tc = lay.B, lay.T, lay.C, lay.Tc
    one_byte = lay.itemsize == 1

    def widen(a):
        return a.to(torch.int16) if one_byte else a

    def narrow(a):
        return (a & 255).to(torch.uint8) if one_byte else a

    if lay.order == 'F' and lay.do_time_diff and not lay.do_spatial_diff:
        out = cumsum_time_transposed(
            widen(elems).view(B, C, Tc),
            widen(heads) if lay.has_head else None, n_samples=T)
        for _ in range(lay.diff_order - 1):
            out = cumsum_time(out)
        return narrow(out)
    if lay.order == 'F':
        chunks = elems.view(B, C, Tc).transpose(1, 2)
    else:
        chunks = elems.view(B, Tc, C)
    if lay.has_head:
        chunks = torch.cat([heads[:, None, :], chunks], dim=1)
    if lay.do_spatial_diff:
        chunks = cumsum_space(chunks)
    if lay.do_time_diff:
        x = widen(chunks)
        for _ in range(lay.diff_order):
            x = cumsum_time(x)
        chunks = narrow(x)
    return chunks.contiguous()


def _to_tensors(states, words, lookup, dense_pk, counts, const_vals,
                raw_vals, heads, device):
    """Staged numpy arrays -> the decode fn's tensors on ``device``:
    ``(states, words, lookup, dense_pk, counts, const_vals, raw_vals,
    heads)``.

    uint32 states and uint16 words travel as int32/int16 tensors holding
    the same bits (torch has almost no unsigned arithmetic); heads as the
    coding dtype's bits (``_BITS``). ``lookup`` and ``dense_pk`` may be
    tensors on ``device`` already (built there by ``decode_tables``).
    """
    N = states.shape[0]

    def put(a, view):
        if torch.is_tensor(a):
            return a
        return to_device(np.ascontiguousarray(a).view(view), device)

    return (put(states, np.int32), put(words.reshape(N, -1), np.int16),
            put(lookup, np.int32), put(dense_pk, np.int32),
            put(counts, np.int32), put(const_vals, np.uint8),
            put(raw_vals, np.uint8),
            put(heads, _BITS[heads.dtype.itemsize][1]))


def args_from_jax_pack(raw_args, device, rows=None):
    """The port's decode tensors from the JAX package's staged batch.

    ``raw_args`` are the ten arrays ``mtscomp_tpu``'s
    ``DeviceBatchDecoder.pack`` stages (``states, words, freqs, counts,
    coarse_pk, dense_pk, counts_b, const_vals, raw_vals, heads``), as
    numpy or anything ``np.array`` takes. That pack puts octet rows in
    ``coarse_pk[:, :, 0]`` when its Pallas kernel runs (a rANS plane
    is present and the word buffer fits its 16384-row window) and every
    frequency table is 8-aligned, and coarse tables otherwise; the rule
    is read back from ``freqs`` and ``words`` (its
    ``MTSCOMP_DEC_LOOKUP`` override is not). ``rows`` keeps the first
    ``rows`` rows of 128 words of each group's buffer (the port's
    :meth:`DeviceBatchDecoder.pack` stages no slack rows): lets a test
    decode the identical staged batch in both packages.
    """
    (states, words, freqs, counts, coarse_pk, dense_pk, _counts_b,
     const_vals, raw_vals, heads) = (np.array(a) for a in raw_args)
    N = states.shape[0]
    octet = (bool(counts.any()) and words.size // (N * LANES) <= 16384
             and not np.any(freqs & 7))
    if rows is not None:
        words = words.reshape(N, -1)[:, :rows * LANES]
    lookup = (coarse_pk[:, :, 0, :] if octet
              else coarse_pk.reshape(N, GROUP_ROWS, 256))
    return _to_tensors(states, words, lookup,
                       dense_pk.reshape(N, GROUP_ROWS, 256), counts,
                       const_vals, raw_vals, heads, resolve_device(device))


def check_words_used(parsed_list, used):
    """Compare the per-group word consumption the decode reported to the
    containers' stored stream lengths; IOError on mismatch."""
    n_groups = sum(len(p['groups']) for p in parsed_list)
    if n_groups == 0:
        return
    used = to_host(used).reshape(-1) if torch.is_tensor(used) \
        else np.asarray(used).reshape(-1)
    i = 0
    for parsed in parsed_list:
        for g in parsed['groups']:
            if used[i] != g['words'].size:
                raise IOError("ANS group consumed %d of %d payload words."
                              % (used[i], g['words'].size))
            i += 1


class DeviceBatchDecoder:
    """Decode batches of parsed ANS chunk containers on one device."""

    def __init__(self, reader, device):
        if reader.algorithm != 'ans':
            raise ValueError("device batch decode requires the ans (v2) "
                             "format")
        self.reader = reader
        self.device = resolve_device(device)
        # Bitcast float files decode in their integer coding dtype.
        self.dtype = np.dtype(getattr(reader, 'code_dtype', reader.dtype))
        self.order = reader.chunk_order
        self.do_time_diff = bool(reader.cmeta.do_time_diff)
        self.do_spatial_diff = bool(reader.cmeta.do_spatial_diff)
        self.diff_order = int(getattr(reader, 'time_diff_order', 1))
        self.last_tail = None

    def supported(self, parsed_list, n_samples):
        """Uniform geometry/modes across the batch, integer dtype in
        native byte order.

        The JAX package's rule but for 8-byte dtypes, which it declines
        because JAX without x64 truncates a uint64 plane accumulator to
        uint32; the card's int64 forms of K4 and K5 take them. Containers
        that fail here take the host path, which raises the decoders'
        documented IOErrors for genuinely malformed inputs.
        """
        if self.dtype.kind not in 'iu':
            return False
        if self.dtype.byteorder not in '<=|':
            return False
        first = parsed_list[0]
        if first['itemsize'] != self.dtype.itemsize:
            return False
        if first['n_head'] not in (0, self.reader.n_channels):
            return False
        for parsed in parsed_list:
            if parsed['modes'] != first['modes']:
                return False
            if parsed.get('transform') != first.get('transform'):
                return False
            if parsed.get('tail_split', 1) != first.get('tail_split', 1):
                return False
            if parsed['seg'] != first['seg']:
                return False
            if parsed['aligned'] != first['aligned']:
                return False
            if parsed['zigzag'] != first['zigzag']:
                return False
            if parsed['n_stream'] != first['n_stream']:
                return False
            if parsed['itemsize'] != first['itemsize']:
                return False
            if parsed['n_elems'] != n_samples * self.reader.n_channels:
                return False
            if parsed['n_head'] != first['n_head']:
                return False
        return True

    def decode_tensor(self, parsed_list, n_samples):
        """(B, n_samples, n_channels) decoded tensor on the device, in the
        coding dtype's bits (uint8, int16, int32 or int64 tensor: an int16
        tensor for int16 and uint16 files, int64 for int64, uint64 and
        float64 ones).

        Raises IOError when any group's stream-word consumption differs
        from its container's stored length (corrupt payload).
        """
        return self._decode_shards(parsed_list, n_samples)[0]

    def _decode_shards(self, parsed_list, n_samples, mesh=None):
        """The batch decoded across ``mesh`` (:meth:`pack`; one shard
        without) and audited: each shard's (b, n_samples, C) samples on
        its device, in batch order."""
        with phase('decode.pack'):
            fn, shards = self.pack(parsed_list, n_samples, mesh=mesh)
        if mesh_devices(mesh) is None:
            shards = [shards]
        with phase('decode.device'):
            results = []
            for args in shards:
                with on_device(args[0].device):
                    results.append(fn(*args))
        with phase('decode.fetch'):
            # Fetches the word counts: the call's one wait for the cards.
            used = [u for _, u in results]
            check_words_used(parsed_list, used[0] if len(used) == 1 else
                             np.concatenate([to_host(u) for u in used]))
        return [samples for samples, _ in results]

    def decode_batch(self, parsed_list, n_samples, mesh=None):
        """(B, n_samples, n_channels) decoded ndarray in the coding dtype.

        With ``mesh`` (:func:`~.mesh.chunk_mesh`), the batch is sharded
        across the mesh's devices (:meth:`pack`) and every shard launched,
        so that distinct cards overlap, before all are audited and each is
        fetched through its card's staging ring (:class:`_HostRows`).
        Raises ValueError when the mesh does not divide a batch with rANS
        groups.
        """
        B, C = len(parsed_list), self.reader.n_channels
        shards = self._decode_shards(parsed_list, n_samples, mesh)
        with _fetch_pool(self.reader) as pool:
            out = _HostRows((B * n_samples, C), self.dtype, pool)
            pos = 0
            for samples in shards:
                out.put(samples.reshape(-1, C), pos)
                pos += samples.shape[0] * n_samples
        return out.out.reshape(B, n_samples, C)

    def pack(self, parsed_list, n_samples, mesh=None):
        """Stage a batch: ``(fn, tensors)`` with ``fn(*tensors)`` returning
        ``(samples, words_used)`` on the device; pass ``words_used`` to
        :func:`check_words_used` for the corruption audit
        (:meth:`decode_tensor` does). Staging once and calling ``fn``
        repeatedly amortizes the host-to-device copy.

        The staged arrays are the JAX package's where both take the same
        route (its ``freqs`` and ``counts_b`` aside, which the port's K1
        does not read; octet rows or coarse tables as its Pallas kernel
        would take them), with each group's word buffer cut to the
        longest stream's rows of 128 words (the JAX package adds slack
        rows and buckets to 512). Layouts that only the port fuses stage
        their ragged tail after the full groups.

        With ``mesh`` (:func:`~.mesh.chunk_mesh` of width n), returns
        ``(fn, shards)``: ``shards[s]`` holds the tensors of chunks
        ``[s*B/n, (s+1)*B/n)`` on ``mesh[s]`` and ``fn(*shards[s])``
        decodes them there. The staged arrays are the JAX package's
        ``pack(mesh=)`` arrays cut along their leading axis: groups
        chunk-major in each shard, with the ragged tail ``[full groups |
        tail groups]`` in each shard, so that every shard's slab stands
        alone. ``B % n != 0`` raises ValueError; a batch with no rANS
        groups is not sharded: one shard on the decoder's device.
        """
        devices = mesh_devices(mesh)
        B = len(parsed_list)
        C = self.reader.n_channels
        T = n_samples
        first = parsed_list[0]
        modes = tuple(first['modes'])
        seg = first['seg']
        has_head = first['n_head'] > 0
        n_coded = T * C - first['n_head']
        n_stream = first['n_stream']
        aligned = first['aligned']
        tail_split = first.get('tail_split', 1)
        rans_planes = [p for p, m in enumerate(modes) if m == MODE_RANS]
        const_planes = [p for p, m in enumerate(modes) if m == MODE_CONST]
        raw_planes = [p for p, m in enumerate(modes) if m == MODE_RAW]
        n_seg = -(-n_stream // seg) if rans_planes else 0
        G = len(first['groups'])
        S = -(-min(seg, n_stream) // LANES) if rans_planes else 0
        # Adaptive chunks' payload descriptor (batch-uniform, enforced by
        # supported()) overrides the sidecar-derived attributes.
        tr = first.get('transform')
        if tr is not None:
            do_time_diff = tr[0] > 0
            diff_order = tr[0] if tr[0] else 1
            do_spatial_diff = bool(tr[1])
        else:
            do_time_diff = self.do_time_diff
            diff_order = self.diff_order
            do_spatial_diff = self.do_spatial_diff

        Tc = T - 1 if has_head else T
        tp = -(-Tc // LANES) * LANES if aligned else 0
        fuse8, k = _fuse8_geom(modes, self.dtype, first['zigzag'],
                               self.order, do_time_diff, do_spatial_diff,
                               seg, tp, S, aligned, has_head)

        # Ragged-tail decision (fuse8 only): the last group of each chunk
        # holds only the leftover channels (C % k), one short segment or
        # M bit6 sub-rows. Packed after all full groups, it decodes as B
        # short groups and feeds the finalize's second channel block,
        # which takes any number of channels (the JAX package's tail
        # kernel bounds it to 32 channels behind at most 1024 rows).
        tail = None
        if fuse8 and G >= 2:
            tail_segs = first['groups'][-1]['segments']
            rem = C - (n_seg - 1) * k if k else 0
            base = (n_seg - 1) * seg
            n_tail = sum(n for _, _, n in tail_segs)
            contiguous, nxt = True, base
            for _, s, n in tail_segs:
                contiguous = contiguous and s == nxt
                nxt = s + n
            if 0 < rem < k and contiguous and n_tail == rem * tp:
                tail = (rem, -(-rem // 8) * 8,
                        tuple(n for _, _, n in tail_segs))
        if tail_split > 1 and tail is None:
            # bit6 sub-rows are not uniform k-channel rows: outside the
            # tail packing, the generic route reassembles them.
            fuse8 = False

        w_max = 1
        for parsed in parsed_list:
            for g in parsed['groups']:
                w_max = max(w_max, g['words'].size)
        # Word buffers: each group's longest stream in rows of 128 words.
        # K1 reads nothing past a group's region (reads there are 0), so
        # no slack rows, and no bucketing: nothing compiles per shape.
        WR = -(-w_max // LANES)

        # Shards: the mesh's width where the batch has rANS groups. The
        # group layout below is per shard, so each shard's slab holds
        # whole chunks and the decode fn sees exactly this layout at the
        # shard's batch size.
        n_shard = 1
        if devices is not None and G > 0:
            n_shard = len(devices)
            if B % n_shard:
                raise ValueError("chunk batch must divide the mesh (%d "
                                 "chunks, %d devices)" % (B, n_shard))
        Bl = B // n_shard

        slots = group_slots(B, G, Bl, tail)
        NG = max(B * G, 1)
        states = np.full((NG, GROUP_ROWS, LANES), RANS_L, dtype=np.uint32)
        words = np.zeros((NG, WR * LANES), dtype=np.uint16)
        counts = np.zeros((NG, GROUP_ROWS), dtype=np.int32)
        const_vals = np.zeros((B, max(len(const_planes), 1)), dtype=np.uint8)
        raw_vals = np.zeros((B, max(len(raw_planes), 1),
                             n_coded if raw_planes else 1), dtype=np.uint8)
        heads = np.zeros((B, C), dtype=self.dtype)
        # Segment rows, the same in every chunk of the batch (supported()
        # holds the geometry uniform): each group's rows' symbol counts.
        seg_n = np.array([n for g in first['groups']
                          for _p, _s, n in g['segments']], dtype=np.int32)
        for b, parsed in enumerate(parsed_list):
            if has_head:
                heads[b] = parsed['head'].view(self.dtype)
            for gi, g in enumerate(parsed['groups']):
                i = slots[b, gi]
                R = len(g['segments'])
                states[i, :R] = g['states']
                words[i, :g['words'].size] = g['words']
                counts[i, :R] = seg_n[gi * GROUP_ROWS:gi * GROUP_ROWS + R]
            for j, p in enumerate(const_planes):
                const_vals[b, j] = parsed['planes'][p]['value']
            for j, p in enumerate(raw_planes):
                raw_vals[b, j] = parsed['planes'][p]['raw']

        # K1's tables. When every table of the batch is 8-aligned (what
        # this codec's writer emits), the card builds each row's octet and
        # dense tables from the containers' frequency tables
        # (decode_tables); otherwise the host packs them, and K1 takes
        # the octet form still where it can, else the coarse tables with
        # one fixup, or two when some 16-slot bucket holds three symbols.
        freqs, tbase = freq_stack(parsed_list, rans_planes)
        on_card = bool(rans_planes) and not np.any(freqs & 7)
        if on_card:
            fixups = 0
            table_rows = segment_tables(parsed_list, rans_planes, slots,
                                        tbase, NG)
            count('decode.tables_on_card', len(freqs))
        else:
            lookup, dense_pk, fixups = host_tables(parsed_list, slots, NG)
            if len(freqs):
                count('decode.tables_on_host', len(freqs))
        self.last_tail = tail
        if fuse8:
            fn = functools.partial(_decode_fuse8, B=Bl, T=T, G=G, S=S, k=k,
                                   tp=tp, tail=tail, fixups=fixups,
                                   diff_order=diff_order)
        else:
            fn = functools.partial(_decode_generic, lay=Layout(
                B=Bl, T=T, C=C, itemsize=self.dtype.itemsize, modes=modes,
                n_seg=n_seg, seg=seg, G=G, S=S, order=self.order,
                do_time_diff=do_time_diff, diff_order=diff_order,
                do_spatial_diff=do_spatial_diff, zigzag=first['zigzag'],
                has_head=has_head, aligned=aligned, tail_split=tail_split,
                fixups=fixups))

        def stage(g0, g1, c0, c1, device):
            # Groups [g0, g1) and chunks [c0, c1) on ``device``.
            if on_card:
                t0, t1 = tbase[c0], tbase[c1]
                rows = table_rows[g0:g1]
                tables = decode_tables(
                    to_device(freqs[t0:t1].view(np.int16), device),
                    to_device(np.where(rows >= 0, rows - t0, -1).astype(
                        np.int32), device))
            else:
                tables = (lookup[g0:g1], dense_pk[g0:g1])
            return _to_tensors(states[g0:g1], words[g0:g1], *tables,
                               counts[g0:g1], const_vals[c0:c1],
                               raw_vals[c0:c1], heads[c0:c1], device)

        with phase('decode.upload'):
            if devices is None:
                return fn, stage(0, NG, 0, B, self.device)
            if G == 0:
                return fn, [stage(0, NG, 0, B, self.device)]
            return fn, [stage(s * Bl * G, (s + 1) * Bl * G, s * Bl,
                              (s + 1) * Bl, dev)
                        for s, dev in enumerate(devices)]


def group_slots(B, G, Bl, tail):
    """(B, G) int array: the staged group of chunk b's group gi. Groups
    are chunk-major; with a ragged ``tail``, each shard of ``Bl`` chunks
    stages its chunks' full groups first, then their tail groups."""
    b = np.arange(B)[:, None]
    gi = np.arange(G)[None, :]
    if tail is None:
        return b * G + gi
    s, bl = np.divmod(b, Bl)
    base = s * Bl * G
    return np.where(gi == G - 1, base + Bl * (G - 1) + bl,
                    base + bl * (G - 1) + gi)


def plane_tables(parsed, p):
    """(n, 256) uint16: the frequency tables plane ``p`` of a parsed
    container carries (one unless it holds several, flags bit4)."""
    plane = parsed['planes'][p]
    return plane['tables'] if 'tables' in plane else plane['freqs'][None]


def freq_stack(parsed_list, rans_planes):
    """Every rANS table of a batch, chunk by chunk and plane by plane:
    ``(freqs (U, 256) uint16, tbase (B + 1,) int)``, chunk b's tables
    being ``freqs[tbase[b]:tbase[b + 1]]``."""
    tabs = [plane_tables(parsed, p) for parsed in parsed_list
            for p in rans_planes]
    per_chunk = np.array([len(t) for t in tabs], dtype=np.int64).reshape(
        len(parsed_list), len(rans_planes)).sum(1)
    tbase = np.concatenate([[0], np.cumsum(per_chunk)])
    freqs = (np.concatenate(tabs) if tabs
             else np.zeros((0, 256), dtype=np.uint16))
    return freqs, tbase


def segment_tables(parsed_list, rans_planes, slots, tbase, NG):
    """(NG, 32) int32: each staged segment row's table in
    :func:`freq_stack`'s stack, -1 for a row without a segment. The
    segment rows are the first chunk's (a batch's geometry is uniform),
    each chunk's plane indexes its own tables by segment (``tidx``)."""
    first = parsed_list[0]
    segs = [s for g in first['groups'] for s in g['segments']]
    seg_p = np.array([p for p, _s, _n in segs])
    seg_i = np.array([start // first['seg'] for _p, start, _n in segs])
    rows_of = [np.flatnonzero(seg_p == p) for p in rans_planes]
    G = slots.shape[1]
    out = np.full((NG, GROUP_ROWS), -1, dtype=np.int32)
    flat = np.full(G * GROUP_ROWS, -1, dtype=np.int32)
    for b, parsed in enumerate(parsed_list):
        base = tbase[b]
        for p, rows in zip(rans_planes, rows_of):
            tidx = parsed['planes'][p].get('tidx')
            flat[rows] = base if tidx is None else base + tidx[seg_i[rows]]
            base += len(plane_tables(parsed, p))
        out[slots[b]] = flat.reshape(G, GROUP_ROWS)
    return out


def host_tables(parsed_list, slots, NG):
    """K1's tables packed on the host (:func:`pack_device_tables`), for
    batches with a table off the 8-slot grid: ``(lookup, dense_pk
    (NG, 32, 256) int32, fixups)``. ``lookup`` holds octet rows
    (NG, 32, 128) where every table has them (``fixups`` 0), else the
    coarse tables (NG, 32, 256) with ``fixups`` 1, or 2 when some 16-slot
    bucket holds three symbols."""
    coarse_pk = np.zeros((NG, GROUP_ROWS, 2, LANES), dtype=np.int32)
    octet_pk = np.zeros((NG, GROUP_ROWS, LANES), dtype=np.int32)
    dense_pk = np.zeros((NG, GROUP_ROWS, 2, LANES), dtype=np.int32)
    table_cache = {}
    needs_fixup2 = False
    octet_ok = True
    for b, parsed in enumerate(parsed_list):
        for gi, g in enumerate(parsed['groups']):
            i = slots[b, gi]
            for r, (p, start, _n) in enumerate(g['segments']):
                # Identical tables across chunks (the common case) pack
                # once.
                table = ans_seg_freqs(parsed, p, start)
                key = table.tobytes()
                if key not in table_cache:
                    table_cache[key] = pack_device_tables(table)
                coarse_pk[i, r], dense_pk[i, r], n2, orow = table_cache[key]
                needs_fixup2 = needs_fixup2 or n2
                if orow is None:
                    octet_ok = False
                else:
                    octet_pk[i, r] = orow
    dense_pk = dense_pk.reshape(NG, GROUP_ROWS, 256)
    if octet_ok:
        return octet_pk, dense_pk, 0
    return (coarse_pk.reshape(NG, GROUP_ROWS, 256), dense_pk,
            2 if needs_fixup2 else 1)


def _read_payload(reader, idx):
    start = reader.chunk_offsets[idx]
    length = reader.chunk_offsets[idx + 1] - start
    return pread_exact(reader.cdata, length, start)


def _chunk_key(reader, idx, payload=None):
    """What identifies chunk ``idx`` of a file that grows: the layout,
    the chunk's sample and byte bounds, and its last four bytes (an ans
    container's CRC32 of the rest), read from ``payload`` when given."""
    o0, o1 = reader.chunk_offsets[idx], reader.chunk_offsets[idx + 1]
    n = min(4, o1 - o0)
    tail = payload[len(payload) - n:] if payload is not None \
        else pread_exact(reader.cdata, n, o1 - n)
    return (reader.n_channels, reader.dtype.str, reader.chunk_bounds[idx],
            reader.chunk_bounds[idx + 1], o0, o1, bytes(tail))


#: Most decoded bytes one decode batch may hold when the configuration
#: names no ``batch_chunks``: 1 GiB. A batch stages, per decoded byte, at
#: most about six bytes on the device at once: the word streams (under 1,
#: the file's ratio, each group's padded to its batch's longest), K1's
#: symbol rows (1/2 with one coded byte plane, 1 with all), the decoded
#: samples (1) and, on the routes outside the fused kernels, the plane
#: combine, the inverse zigzag and one carried scan's copy (1 each). So a
#: batch at the bound holds at most about 6 GiB of an 80 GB card (an
#: estimate from the code; measured on an H100 with ``chip_smoke.py``'s
#: bounded-batch phase, the fused route's peak was 1,566.9 MB for 739.2
#: MB decoded, 2.1 bytes a decoded byte), a 32-chunk batch of 1-s
#: 385-channel int16 chunks (0.74 GB decoded) stays one batch, and a
#: 30-min recording of such chunks decodes in 40 batches of 46.
DECODE_BATCH_BYTES = 1 << 30


def batch_limit(reader, n_samples):
    """Most chunks of ``n_samples`` samples in one decode batch: the
    configuration's ``batch_chunks`` when set, else as many as decode to
    :data:`DECODE_BATCH_BYTES` (at least one)."""
    chunk_bytes = max(n_samples * reader.n_channels * reader.dtype.itemsize,
                      1)
    return int(reader.config.batch_chunks) \
        or max(1, DECODE_BATCH_BYTES // chunk_bytes)


#: The staging ring of a bulk read's fetch (:class:`StagingRing`):
#: FETCH_SLOTS pinned host slots of FETCH_SLOT_BYTES each, 128 MiB per
#: CUDA device and process, whatever the recording's length. Pinned, a
#: device-to-host copy runs at the link's DMA rate (52-55 GB/s on an
#: H100's host link, against 1.9 GB/s for a pageable ``.cpu()``), so a
#: fetch's time is the host copies into the result, which the ring
#: spreads over threads. The slots only keep the DMA and those copies out
#: of each other's way: the DMA fills one slot while threads empty the
#: others. Slots of 8 to 64 MiB measured alike; at 32 MiB a copy's fixed
#: cost (a launch, an event, a thread's wake-up) is small beside the
#: bytes it moves.
FETCH_SLOTS = 4
FETCH_SLOT_BYTES = 32 << 20

#: CUDA device index -> its :class:`StagingRing`, made on first use.
_FETCH_RINGS = {}
_FETCH_RINGS_LOCK = threading.Lock()


def _put_elems(dst, e0, src, done=None):
    """Write the 1-d ``src`` into the 2-d ``dst`` from flat element
    ``e0`` on, in C order (row ``e0 // C``, column ``e0 % C``), with
    NumPy's assignment semantics for any layout of ``dst``; first wait
    for ``done`` (a CUDA event) when given."""
    if done is not None:
        done.synchronize()
    cols = dst.shape[1]
    r0, c0 = divmod(e0, cols)
    r1, c1 = divmod(e0 + src.size, cols)
    if r0 == r1:
        dst[r0, c0:c1] = src
        return
    k = 0
    if c0:
        k = cols - c0
        dst[r0, c0:] = src[:k]
        r0 += 1
    m = (r1 - r0) * cols
    dst[r0:r1] = src[k:k + m].reshape(r1 - r0, cols)
    if c1:
        dst[r1, :c1] = src[k + m:]


class StagingRing:
    """Host slots through which a block's bytes reach a host array.

    :meth:`fetch` copies the block slot by slot into the slots and, on a
    thread pool, each slot's rows into their place in the destination,
    which is written once. A slot is given to the next copy only after
    its host copy has ended. With ``stream`` (the ring of a CUDA device,
    :func:`_fetch_ring`), the slots are pinned and each copy into a slot
    is an asynchronous DMA on that stream, which a host thread waits for
    by the slot's event; without, the copies run on the calling thread,
    so the schedule runs on the CPU as well. ``lock`` keeps one fetch at
    a time on the ring.
    """

    def __init__(self, n_slots, slot_bytes, stream=None):
        pin = stream is not None
        self.slots = [torch.empty(slot_bytes, dtype=torch.uint8,
                                  pin_memory=pin) for _ in range(n_slots)]
        self.views = [s.numpy() for s in self.slots]
        self.stream = stream
        self.events = [torch.cuda.Event() for _ in self.slots] if pin \
            else [None] * n_slots
        self.lock = threading.Lock()

    def fetch(self, src, dst, pool):
        """Copy the contiguous tensor ``src`` into the host ndarray
        ``dst`` of the same element count and item size, bytes as they
        are (``dst``'s dtype reads them): ``src``'s elements in C order
        fill ``dst``'s rows. Every copy into ``dst`` has ended, and the
        ring is free, when this returns or raises."""
        src = src.reshape(-1).view(torch.uint8)
        size = dst.itemsize
        if src.numel() != dst.size * size:
            raise ValueError("staged fetch of %d bytes into %d elements of "
                             "%d bytes" % (src.numel(), dst.size, size))
        step = len(self.views[0]) // size * size
        count('transfer.d2h_staged_bytes', src.numel())
        if src.device.type != 'cpu':
            count('transfer.d2h_bytes', src.numel())
        with self.lock:
            pending = [None] * len(self.slots)
            try:
                if self.stream is not None:
                    # The block was written on the caller's stream; the
                    # allocator must not reuse it while the DMA reads it.
                    self.stream.wait_stream(
                        torch.cuda.current_stream(src.device))
                    src.record_stream(self.stream)
                for i, b0 in enumerate(range(0, src.numel(), step)):
                    k = i % len(self.slots)
                    if pending[k] is not None:
                        pending[k].result()
                    b1 = min(b0 + step, src.numel())
                    if self.stream is None:
                        self.slots[k][:b1 - b0].copy_(src[b0:b1])
                    else:
                        with torch.cuda.stream(self.stream):
                            self.slots[k][:b1 - b0].copy_(src[b0:b1],
                                                          non_blocking=True)
                            self.events[k].record(self.stream)
                    pending[k] = pool.submit(
                        _put_elems, dst, b0 // size,
                        self.views[k][:b1 - b0].view(dst.dtype),
                        self.events[k])
            finally:
                wait_all([f for f in pending if f is not None])
                if self.stream is not None:
                    self.stream.synchronize()
            for f in pending:
                if f is not None:
                    f.result()


def _fetch_ring(device):
    """The staging ring of CUDA ``device``, made on first use and kept
    for the process; None for a CPU device, whose blocks are host memory
    already."""
    if device.type != 'cuda':
        return None
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with _FETCH_RINGS_LOCK:
        ring = _FETCH_RINGS.get(index)
        if ring is None:
            ring = _FETCH_RINGS[index] = StagingRing(
                FETCH_SLOTS, FETCH_SLOT_BYTES,
                stream=torch.cuda.Stream(torch.device('cuda', index)))
    return ring


def _fetch_pool(reader):
    """``n_threads`` threads for a bulk decode's host copies."""
    return ThreadPoolExecutor(max(1, int(reader.config.n_threads)),
                              thread_name_prefix='mts-fetch')


class _HostRows:
    """A bulk decode's host result: the one way a decoded block reaches
    host memory. :meth:`put` writes a card's block through its device's
    staging ring (:func:`_fetch_ring`; the host copies on ``pool``), a
    host block (a CPU device's tensor, the host codec's ndarray) by NumPy
    assignment. :attr:`out` is the caller's array, else allocated at the
    first block that needs it; a host block that spans all of ``shape``'s
    rows becomes it as it is."""

    def __init__(self, shape, dtype, pool, out=None):
        self.shape, self.dtype, self.pool, self.out = shape, dtype, pool, out

    def put(self, block, pos):
        """Write the (n, C) ``block`` into rows [pos, pos + n)."""
        rows = slice(pos, pos + len(block))
        ring = _fetch_ring(block.device) if torch.is_tensor(block) else None
        if ring is not None:
            if self.out is None:
                with phase('decode.assemble'):
                    self.out = np.empty(self.shape, self.dtype)
            with phase('decode.to_host'):
                ring.fetch(block, self.out[rows], self.pool)
            return
        if torch.is_tensor(block):
            with phase('decode.to_host'):
                block = to_host(block).view(self.dtype)
        if self.out is None and len(block) == self.shape[0]:
            self.out = block
            return
        with phase('decode.assemble'):
            if self.out is None:
                self.out = np.empty(self.shape, self.dtype)
            self.out[rows] = block


def _uniform_batches(readers, chunk_ids, n_samples, dec, multiple=1,
                     payloads=None):
    """Parse a run's chunks and cut it into batches of consecutive
    chunks, each of at most :func:`batch_limit` chunks over all
    ``readers`` (several for a multi-probe decode: every batch then holds
    the same chunks of each): the one place that judges (``supported()``)
    which chunks decode together on the card. A batch's first column (its
    chunk of every reader) is judged alone, each later column once,
    against the batch's first chunk; a declined batch is one column.
    Yields ``(chunk ids, parsed chunks reader-major, ok)`` as each batch
    closes, ``ok`` whether the card takes it. A batch cut by the bound
    holds a multiple of ``multiple`` ids (at least ``multiple``, beyond
    the bound if need be): what a mesh needs to divide it. ``payloads``,
    when a list, gets every payload as it is read.
    """
    limit = max(1, batch_limit(readers[0], n_samples) // len(readers))
    limit = max(multiple, limit - limit % multiple)
    ids, cols, ok = [], [], False

    def batch():
        return ids, [col[k] for k in range(len(readers)) for col in cols], ok

    for idx in chunk_ids:
        with phase('decode.parse'):
            raw = [_read_payload(r, idx) for r in readers]
            col = [r.codec.parse(p) for r, p in zip(readers, raw)]
        if payloads is not None:
            payloads.extend(raw)
        if ok and len(ids) < limit and dec.supported([cols[0][0]] + col,
                                                     n_samples):
            ids.append(idx)
            cols.append(col)
            continue
        if ids:
            yield batch()
        ids, cols, ok = [idx], [col], dec.supported(col, n_samples)
    if ids:
        yield batch()


def _decode_runs(reader, first_chunk, last_chunk, device):
    """Decode chunks [first, last] batch by batch.

    Runs are consecutive chunks with the same sample count and header
    descriptor (flags bit5 transform, bit6 tail split). Each run is cut
    further into mode-uniform batches (:func:`_uniform_batches`), so a
    file whose plane modes change between chunks (a quiet chunk codes
    its high byte CONST, a busy one rANS) still decodes on the device;
    the JAX package sends such a run to the host codec. No batch holds
    more chunks than :func:`batch_limit` allows, and a batch's staged
    tensors are dropped before the next is staged. Yields ``(row
    offset, block)``: a (n, C) device tensor in the coding dtype's bits,
    or a host ndarray in the reader's dtype for batches that the card
    declines.
    """
    global host_fallback_chunks
    bounds, offsets = reader.chunk_bounds, reader.chunk_offsets
    ans = reader.algorithm == 'ans'
    runs = []
    with phase('decode.parse'):
        for idx in range(first_chunk, last_chunk + 1):
            desc = None
            if ans:
                # The 20-byte header: peek_desc raises on a bit6 sub-row
                # count the full parse would reject.
                desc = peek_desc(pread_exact(
                    reader.cdata, min(20, offsets[idx + 1] - offsets[idx]),
                    offsets[idx]))
            key = (bounds[idx + 1] - bounds[idx], desc)
            if runs and runs[-1][1] == key:
                runs[-1][0].append(idx)
            else:
                runs.append(([idx], key))
    pos = 0
    for run_ids, (ns, _desc) in runs:
        dec = DeviceBatchDecoder(reader, device) if ans else None
        batches = (_uniform_batches([reader], run_ids, ns, dec) if ans
                   else [(run_ids, None, False)])
        for chunk_ids, parsed, ok in batches:
            n_span = len(chunk_ids) * ns
            if ok:
                block = dec.decode_tensor(parsed, ns).reshape(
                    n_span, reader.n_channels)
                del parsed
                yield pos, block
                del block
            else:
                logger.debug("Device decode unsupported for chunks %s; "
                             "using host path.", chunk_ids)
                host_fallback_chunks += len(chunk_ids)
                yield pos, np.concatenate(
                    [reader._decompress_chunk(i)[1] for i in chunk_ids])
            pos += n_span


def _span(reader, first_chunk, last_chunk):
    last_chunk = reader.n_chunks - 1 if last_chunk is None else last_chunk
    if not 0 <= first_chunk <= last_chunk < reader.n_chunks:
        raise ValueError("invalid chunk range [%d, %d] of %d chunks"
                         % (first_chunk, last_chunk, reader.n_chunks))
    total = (reader.chunk_bounds[last_chunk + 1]
             - reader.chunk_bounds[first_chunk])
    return last_chunk, total


def _torch_dtype(dtype):
    return torch.from_numpy(np.empty(0, np.dtype(dtype).newbyteorder('='))
                            ).dtype


def decompress_to_array(reader, first_chunk=0, last_chunk=None, out=None,
                        writable=True, device='cuda'):
    """Bulk-decode chunks [first, last] to one host ndarray via the GPU.

    Returns ``out`` if given (a ``(samples of the span, C)`` array of
    the reader's dtype, in any layout: NumPy's assignment semantics),
    else a fresh C-ordered array; either is written once, batch by batch
    (:class:`_HostRows`). ``writable`` has the JAX package's meaning
    (``False`` allows a read-only result); the port's result is always a
    writable array of its own, so both values return the same.
    """
    last_chunk, total = _span(reader, first_chunk, last_chunk)
    shape = (total, reader.n_channels)
    if out is not None and (not isinstance(out, np.ndarray)
                            or out.shape != shape
                            or out.dtype != reader.dtype):
        raise ValueError("out must be a %s ndarray of shape %s for chunks "
                         "[%d, %d], got %s %s"
                         % (reader.dtype, shape, first_chunk, last_chunk,
                            getattr(out, 'dtype', type(out).__name__),
                            getattr(out, 'shape', '')))
    with _fetch_pool(reader) as pool:
        res = _HostRows(shape, reader.dtype, pool, out)
        for pos, block in _decode_runs(reader, first_chunk, last_chunk,
                                       device):
            res.put(block, pos)
            del block  # freed here, not at the next batch's fetch
    return res.out


def decompress_to_tensor(reader, first_chunk=0, last_chunk=None,
                         device='cuda'):
    """Chunks [first, last] as one device-resident (n, C) tensor in the
    reader's dtype; nothing is fetched to the host. A uint64 file gives
    a ``torch.uint64`` view of the decoded int64 bits (torch has few
    uint64 ops: view it as int64 to compute)."""
    device = resolve_device(device)
    last_chunk, total = _span(reader, first_chunk, last_chunk)
    dtype = _torch_dtype(reader.dtype)
    out = None
    for pos, block in _decode_runs(reader, first_chunk, last_chunk, device):
        if torch.is_tensor(block):
            block = block.view(dtype)
        else:
            block = to_device(np.ascontiguousarray(
                block, block.dtype.newbyteorder('=')), device)
        if block.shape[0] == total:
            return block
        if out is None:
            out = torch.empty((total, reader.n_channels), dtype=dtype,
                              device=device)
        out[pos:pos + block.shape[0]].copy_(block)
        del block          # only ``out`` outlives the batch
    return out


class DeviceChunkCache:
    """Random-access reads: decoded chunks cached on the reader's device.

    ``read_window`` decodes the covering chunk(s) on the device, one
    chunk a call (a batch of one through :class:`DeviceBatchDecoder`),
    keeps the decoded (ns, C) tensors device-resident in a small LRU,
    slices on the device and copies only the requested window to the
    host: the host-side LRU chunk cache of ``Reader.read_chunk`` with the
    decode and the slicing moved onto the device. ``capacity`` defaults
    to the reader's ``cache_size``. :meth:`adopt` hands the cache on to a
    later snapshot of the same growing file.
    """

    def __init__(self, reader, capacity=None):
        self.reader = reader
        self.capacity = capacity or reader.cache_size
        #: chunk_idx -> (device tensor (ns, C), :func:`_chunk_key`),
        #: least recently used first.
        self._cache = collections.OrderedDict()

    def _chunk(self, idx):
        """Chunk ``idx`` decoded on the device, or None for a chunk the
        batched decode declines (a foreign byte order): judged by
        :func:`_uniform_batches`, as a bulk read's batch is, before
        anything is staged. Every error of the decode itself
        propagates."""
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx][0]
        r = self.reader
        ns = r.chunk_bounds[idx + 1] - r.chunk_bounds[idx]
        dec = DeviceBatchDecoder(r, r.device)
        payload = []
        (_, parsed, ok), = _uniform_batches([r], [idx], ns, dec,
                                            payloads=payload)
        if not ok:
            return None
        out = dec.decode_tensor(parsed, ns)[0]      # (ns, C), stays put
        # Keyed on the bytes decoded, not on a second read of the file.
        self._cache[idx] = out, _chunk_key(r, idx, payload[0])
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
        return out

    def clear(self):
        """Drop every cached chunk (and the device memory it holds)."""
        self._cache.clear()

    def adopt(self, reader):
        """Serve ``reader``, a later snapshot of the reader's file on the
        same device (a live stream's tail re-opens at every sidecar it
        publishes): keep each cached chunk whose key
        (:func:`_chunk_key`) is unchanged, drop the others."""
        for idx, (_, key) in list(self._cache.items()):
            if idx >= reader.n_chunks or _chunk_key(reader, idx) != key:
                del self._cache[idx]
        self.reader = reader
        reader._dev_cache = self

    def read_window(self, i0, i1):
        """Decoded samples [i0, i1) as a fresh writable host ndarray in
        the reader's dtype; None, with the window's chunks added to
        ``host_fallback_chunks``, when the batched decode declines one of
        them (the caller then reads the window through the host codec)."""
        global host_fallback_chunks
        r = self.reader
        first, last = r._chunks_for_interval(i0, max(i0, i1 - 1))
        parts = []
        for idx in range(first, last + 1):
            chunk = self._chunk(idx)
            if chunk is None:
                logger.debug("Device decode unsupported for chunk %d; "
                             "using host path.", idx)
                host_fallback_chunks += last - first + 1
                return None
            c0, c1 = r.chunk_bounds[idx], r.chunk_bounds[idx + 1]
            parts.append(chunk[max(i0, c0) - c0:min(i1, c1) - c0])
        dev = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        # A row slice of a cached chunk is a view of it: ``contiguous``
        # and ``cpu`` copy the window alone, into host memory the caller
        # owns. On the CPU device ``cpu`` copies nothing, so a one-chunk
        # window is cloned: never a view of a cached tensor. A window is
        # small and waited for: no staging ring and thread handoff here.
        if dev.device.type == 'cpu':
            win = dev.clone() if len(parts) == 1 else dev
        else:
            win = dev.contiguous()
        return to_host(win).view(r.dtype)


def decompress_multi(readers, mesh=None, first_chunk=0, last_chunk=None):
    """Decode the same chunk range of several recordings (multi-probe).

    The probes' chunks are decoded together, batch by batch, by
    :meth:`DeviceBatchDecoder.decode_batch` on the first reader's device
    or sharded across ``mesh`` (:func:`~.mesh.chunk_mesh`), and put into
    one ``(n_samples, n_channels)`` array per reader (:class:`_HostRows`).
    All probes must share geometry (channels, chunk sizes, dtype, plane
    modes). A batch holds the same few chunks of every probe, at most
    :func:`batch_limit`; with a mesh, a multiple of its width whenever the
    whole range is one. A range that is not raises the decode's
    ValueError, as the JAX package's assertion does; a batch cut where the
    plane modes change is not sharded when the mesh does not divide it.

    Falls back to per-reader ``to_array`` (each reader's own device, no
    mesh) when the probes cannot be merged, up front or at a batch the
    card declines. ``mesh`` must be a mesh or None (TypeError).

    With tracing on (``utils.trace``), three counters say how a call
    went: ``decode.multi_merged_chunks`` (readers x chunks of a call that
    returns merged arrays), ``decode.multi_fallback_chunks`` (readers x
    chunks of a call that ends in the per-reader fallback) and
    ``decode.multi_recopied_bytes`` (the bytes the merged path copies
    from a batch's host block into the probes' arrays: every decoded byte
    of a range of several batches, none of a range of one, whose arrays
    are views of its block).
    """
    assert readers
    devices = mesh_devices(mesh)
    last = readers[0].n_chunks - 1 if last_chunk is None else last_chunk
    n_chunks = last - first_chunk + 1
    if not 0 <= first_chunk <= last:
        raise ValueError(
            "decompress_multi: invalid chunk range [%d, %d]"
            % (first_chunk, last))
    for k, r in enumerate(readers):
        # One common chunk range per call is the contract.
        if r.n_chunks <= last:
            raise ValueError(
                "decompress_multi decodes one common chunk range, but "
                "reader %d has %d chunks and chunks [%d, %d] were "
                "requested; pass last_chunk to restrict the range."
                % (k, r.n_chunks, first_chunk, last))
    r0 = readers[0]
    # Probes must agree on everything the decoder derives from
    # readers[0]: the full decode identity (incl. the v2 sidecar
    # extensions time_diff_order/float_bitcast, which supported() can
    # never see: they are sidecar-only, not in the chunk payloads).
    # Fallback, never corrupt.
    ident0 = decode_identity(r0.cmeta)
    mergeable = (r0.algorithm == 'ans' and r0.device is not None and all(
        r.algorithm == 'ans' and decode_identity(r.cmeta) == ident0
        for r in readers))
    sizes = {r.chunk_bounds[i + 1] - r.chunk_bounds[i]
             for r in readers for i in range(first_chunk, last + 1)}
    if mergeable and len(sizes) == 1:
        ns, = sizes
        dec = DeviceBatchDecoder(r0, r0.device)
        width = len(devices) if devices else 1
        whole = (len(readers) * n_chunks) % width == 0
        outs = [_HostRows((n_chunks * ns, r.n_channels), r.dtype, None)
                for r in readers]
        for ids, parsed, ok in _uniform_batches(
                readers, range(first_chunk, last + 1), ns, dec,
                multiple=width // math.gcd(width, len(readers))):
            if not ok:
                break
            shard = mesh if len(parsed) % width == 0 or not whole else None
            block = dec.decode_batch(parsed, ns, mesh=shard).reshape(
                len(readers), len(ids) * ns, -1)
            del parsed
            count('decode.multi_recopied_bytes',
                  block.nbytes if len(ids) < n_chunks else 0)
            for out, r, rows in zip(outs, readers, block):
                out.put(rows.view(r.dtype), (ids[0] - first_chunk) * ns)
        else:
            count('decode.multi_merged_chunks', len(readers) * n_chunks)
            return [o.out for o in outs]
    count('decode.multi_fallback_chunks', len(readers) * n_chunks)
    return [r.to_array(first_chunk, last) for r in readers]


# --- encode ---------------------------------------------------------------

def _build_transform_fn(B, T, C, dtype_str, order, do_time_diff,
                        do_spatial_diff, split_head, diff_order=1):
    """Device transform stage: diff -> zigzag -> byte planes + histograms.

    Returns ``transform(chunks)`` for a (B, T, C) tensor holding the
    coding dtype's bits (``_BITS``), giving ``(planes (B, P, n) uint8,
    hists (B, P, 256) int64, head (B, C) or None)``: the coded elements'
    little-endian byte planes in ``order`` (F: channel-major), each
    plane's byte histogram, and the verbatim first row when
    ``split_head``. The JAX package's jitted function of the same name,
    as eager torch ops.
    """
    P = np.dtype(dtype_str).itemsize

    def transform(chunks):
        d = chunks
        if do_time_diff:
            for _ in range(diff_order):
                d = diff_time(d)
        if do_spatial_diff:
            d = diff_space(d)
        coded = d[:, 1:, :] if split_head else d
        z = zigzag_encode(coded)
        flat = (z.transpose(1, 2) if order == 'F' else z).reshape(B, -1)
        planes = flat.contiguous().view(torch.uint8).view(
            B, -1, P).transpose(1, 2).contiguous()
        hists = histogram256(planes.view(B * P, -1)).view(B, P, 256)
        head = d[:, 0, :] if split_head else None
        return planes, hists, head

    return transform


def _gather_symbols(planes, rans_planes, segments, *, B, G, C, tcs, tp,
                    aligned, n_stream, seg, S, tsplit):
    """(B, P, n) byte planes -> (B*G, 32, S*128) uint8 segment rows: the
    coded planes' streams (each channel zero-padded to ``tp`` symbols
    when ``aligned``) cut into the codec's segment list, one row per
    segment, rows zero-padded to S*128 and groups to 32 rows. The JAX
    package's ``gather_symbols``."""
    Pr = len(rans_planes)
    seg_eff = S * LANES
    sel = planes[:, rans_planes, :]
    if aligned:
        padded = torch.zeros((B, Pr, C, tp), dtype=torch.uint8,
                             device=planes.device)
        padded[:, :, :, :tcs] = sel.view(B, Pr, C, tcs)
        sel = padded.view(B, Pr, n_stream)
    rows = torch.zeros((B, G * GROUP_ROWS, seg_eff), dtype=torch.uint8,
                       device=planes.device)
    n_seg = -(-n_stream // seg)
    if tsplit == 1:
        # Uniform rows (no bit6 sub-rows): one copy of the padded planes.
        full = torch.zeros((B, Pr, n_seg * seg_eff), dtype=torch.uint8,
                           device=planes.device)
        full[:, :, :n_stream] = sel
        rows[:, :Pr * n_seg] = full.view(B, Pr * n_seg, seg_eff)
    else:
        # bit6: the ragged tail is M shorter sub-rows, one copy each.
        for r, (p, start, n) in enumerate(segments):
            rows[:, r, :n] = sel[:, rans_planes.index(p), start:start + n]
    return rows.view(B * G, GROUP_ROWS, seg_eff)


class DeviceBatchEncoder:
    """Encode batches of equal-size integer chunks on one device.

    Produces containers byte-identical to the host AnsCodec: the plane
    decisions are the codec's own ``decide_plane`` on histograms equal
    to the host codec's bincounts, and K6 is bit-exact against the
    normative coder. ``writer`` is the port's :class:`~..api.Writer`
    (its codec, dtype, chunk order and transform settings); ``device``
    defaults to the writer's.
    """

    def __init__(self, writer, transform=None, device=None):
        self.writer = writer
        self.codec = writer.codec
        if device is None:
            device = getattr(writer, 'device', None) or 'cuda'
        self.device = resolve_device(device)
        # Bitcast float writers hand the encoder integer views; code in
        # the coding dtype (float16 -> int16 runs the full device path).
        self.dtype = np.dtype(getattr(writer, 'code_dtype', writer.dtype))
        self.order = writer.chunk_order
        self.do_time_diff = bool(writer.do_time_diff)
        self.do_spatial_diff = bool(writer.do_spatial_diff)
        self.diff_order = int(getattr(writer, 'time_diff_order', 1))
        # Adaptive windows: ``transform=(order, spatial)`` overrides the
        # writer's global transform for this (window-uniform) batch, and
        # every produced container gets the bit5 descriptor stamp --
        # byte-identical to what Writer._compress_chunk's host path
        # writes for the same chunks.
        self.stamp = None
        if transform is not None:
            t_order, t_spatial = transform
            self.do_spatial_diff = bool(t_spatial)
            self.diff_order = t_order if t_order else 1
            self.do_time_diff = self.do_time_diff and t_order > 0
            self.stamp = (t_order if writer.do_time_diff else 0,
                          bool(t_spatial))
        #: K6's staged inputs of the last batch with a rANS plane (its
        #: last shard's with a mesh): ``(symbols, pk, rcp, counts, cap)``
        #: on the device.
        self.last_kernel_args = None

    def supported(self, n_samples):
        """Integers of any width (bitcast floats included) in native
        order, fewer than 65536 channels (the header's head field), any
        chunk length ``n_samples`` (the JAX package's signature; a chunk
        of one sample stores no head, as the host codec writes it). The
        transform makes one byte plane a byte of the element (8 planes
        for 8-byte elements, whose diffs and zigzag wrap in int64), and
        K6 codes planes of any element width; the JAX package's encode
        takes 1- and 2-byte elements only."""
        return (self.dtype.kind in 'iu'
                and self.dtype.byteorder in '<=|'
                and self.writer.n_channels < 65536)

    def encode_batch(self, chunks, mesh=None):
        """chunks: (B, T, C) ndarray in the coding dtype, or a tensor on
        the device holding its bits (``_BITS``) -> list of container
        payload bytes.

        With ``mesh`` (:func:`~.mesh.chunk_mesh`), K6's group axis is
        sharded across the mesh's devices: the groups are padded to a
        multiple of its width with inactive filler groups (count 0,
        placeholder tables), each shard is encoded on its device and its
        streams left-aligned and fetched, and the filler is dropped. The
        transform and the plane decisions run on the encoder's device as
        without a mesh; the bytes are the same.

        Traced (:mod:`~..utils.trace`), a batch opens ``write.upload``
        (an ndarray's copy to the device), the ``encode.*`` spans
        (device work and the fetches that wait for it), ``write.decide``
        (the host's plane decisions, tables, symbol gather and K6's
        staging, in pieces around ``encode.seghist``) and
        ``write.assemble`` (the containers); none nests in another.
        """
        devices = mesh_devices(mesh)
        B, T, C = chunks.shape
        P = self.dtype.itemsize
        seg = self.codec.seg
        if torch.is_tensor(chunks):
            x = chunks
        else:
            with phase('write.upload'):
                x = to_device(np.ascontiguousarray(chunks).view(
                    _BITS[P][1]), self.device)
        # The first row is stored verbatim (flags bit1) unless it is the
        # chunk's only row, as the host codec decides.
        split_head = T > 1
        transform = _build_transform_fn(
            B, T, C, str(self.dtype), self.order, self.do_time_diff,
            self.do_spatial_diff, split_head, self.diff_order)
        with phase('encode.transform'):
            planes_d, hists_d, head_d = transform(x)
        with phase('write.decide'):
            hists = to_host(hists_d)
            heads = to_host(head_d) if split_head else None
            n_coded = (T - 1 if split_head else T) * C

            # Channel-aligned segments (flags bit2): same eligibility
            # rule and geometry as the host codec (AnsCodec.encode).
            aligned = (getattr(self.codec, 'channel_aligned', False)
                       and self.order == 'F' and split_head
                       and n_coded > 0)
            if aligned:
                k, seg, tp, tcs, n_stream = ans_mod.aligned_geometry(
                    n_coded, C, seg)
            else:
                k = tp = tcs = 0
                n_stream = n_coded
            n_pad = n_stream - n_coded
            seg_mode = getattr(self.codec, 'table_mode',
                               'plane') == 'segment'

        # Per-segment histograms for segment-table clustering, equal to
        # the host codec's bincounts of its coded stream. Channel-aligned:
        # the F-order plane stream is channel-major, so a segment's
        # histogram is the sum of its k channels' (plus their zero pads).
        # Otherwise the stream is the plane itself (F or C order), cut
        # into segments of ``seg`` symbols, the last one short.
        seg_hists = None
        if seg_mode and n_stream > seg:
            with phase('encode.seghist'):
                if aligned:
                    n_segs = -(-C // k)
                    ch = torch.zeros((B, P, n_segs * k, 256),
                                     dtype=torch.int64, device=x.device)
                    ch[:, :, :C] = histogram256(
                        planes_d.view(B * P * C, tcs)).view(B, P, C, 256)
                    seg_hists = ch.view(B, P, n_segs, k, 256).sum(dim=3)
                    n_ch = (C - k * torch.arange(n_segs, device=x.device)
                            ).clamp(max=k)
                    seg_hists[:, :, :, 0] += n_ch * (tp - tcs)
                else:
                    n_full = n_stream // seg
                    flat = planes_d.view(B * P, n_stream)
                    parts = [histogram256(flat[:, :n_full * seg].reshape(
                        B * P * n_full, seg)).view(B, P, n_full, 256)]
                    if n_stream > n_full * seg:
                        parts.append(histogram256(
                            flat[:, n_full * seg:]).view(B, P, 1, 256))
                    seg_hists = torch.cat(parts, dim=2)
                seg_hists = to_host(seg_hists)

        # Host: tables + per-plane modes (uniform across the batch for
        # one device call; mixed batches split below). The decision
        # logic is ans_mod.decide_plane -- the SAME code the host codec
        # runs, so containers stay byte-identical.
        with phase('write.decide'):
            modes = np.empty((B, P), dtype=np.int64)
            plane_tables = {}
            for b in range(B):
                for p in range(P):
                    seg_fn = ((lambda b=b, p=p: seg_hists[b, p])
                              if seg_hists is not None else None)
                    mode, ptables, tidx = ans_mod.decide_plane(
                        hists[b, p], n_pad, n_stream, n_coded, seg,
                        'segment' if seg_mode else 'plane', seg_fn)
                    modes[b, p] = mode
                    if mode == MODE_RANS:
                        plane_tables[(b, p)] = (ptables, tidx)
        if not (modes == modes[0]).all():
            # Plane modes are data-dependent per chunk (a quiet chunk
            # codes its high byte CONST, a busy one rANS): encode each
            # mode-uniform sub-batch on the device, however short
            # (decide_plane is deterministic, so each passes the
            # uniformity check on re-entry). The JAX package sends
            # sub-batches under 4 chunks to the host codec, so as not to
            # compile one more shape; nothing here compiles per shape.
            payloads = [None] * B
            for row in sorted({tuple(m) for m in modes.tolist()}):
                ids = [b for b in range(B) if tuple(modes[b]) == row]
                sub = self.encode_batch(
                    chunks[torch.tensor(ids, device=chunks.device)]
                    if torch.is_tensor(chunks)
                    else np.ascontiguousarray(chunks[ids]), mesh=mesh)
                for j, b in enumerate(ids):
                    payloads[b] = sub[j]
            return payloads
        mode_row = [int(m) for m in modes[0]]
        rans_planes = [p for p, m in enumerate(mode_row) if m == MODE_RANS]
        raw_planes = [p for p, m in enumerate(mode_row) if m == MODE_RAW]

        # Ragged-tail segment split (flags bit6): identical decision to
        # the host codec (shared helper).
        tsplit = ans_mod.tail_split_for(aligned, mode_row, n_stream, seg)

        if rans_planes:
            with phase('write.decide'):
                segments = segment_counts(n_stream, seg, mode_row,
                                          tail_split=tsplit)
                staged, G, N = self._stage_k6(
                    planes_d, plane_tables, segments, rans_planes, devices,
                    B=B, C=C, tcs=tcs, tp=tp, aligned=aligned,
                    n_stream=n_stream, seg=seg, tsplit=tsplit)
            outs = []
            with phase('encode.kernel'):
                for dev, args in staged:
                    with on_device(dev):
                        outs.append(encode_groups(*args))
            with phase('encode.align'):
                parts = [left_align(w, nw) for _st, w, nw in outs]
                # Filler groups emit no words: only their counts and
                # states go.
                flat = np.concatenate([f for f, _ in parts])
                n_words = np.concatenate([nw for _, nw in parts])[:N]
                states = np.concatenate(
                    [to_host(st) for st, _w, _nw in outs]
                )[:N].view(np.uint32)

        # Host: assemble containers (identical layout to AnsCodec.encode).
        with phase('write.assemble'):
            group_words, group_states, group_counts = [], [], []
            if rans_planes:
                R = GROUP_ROWS
                offs = np.concatenate([[0], np.cumsum(n_words)])
                for b in range(B):
                    gw, gs, gc = [], [], []
                    for gi in range(G):
                        i = b * G + gi
                        segs = segments[gi * R:(gi + 1) * R]
                        gw.append(flat[offs[i]:offs[i + 1]])
                        gs.append(states[i, :len(segs)])
                        gc.append(int(n_words[i]))
                    group_words.append(gw)
                    group_states.append(gs)
                    group_counts.append(gc)
            raw_np = (to_host(planes_d[:, raw_planes]) if raw_planes
                      else None)
            return [self._container(
                b, hists, heads, raw_np, plane_tables, mode_row,
                rans_planes, raw_planes, group_words, group_states,
                group_counts, T=T, C=C, P=P, k=k, aligned=aligned,
                split_head=split_head, tsplit=tsplit) for b in range(B)]

    def _stage_k6(self, planes_d, plane_tables, segments, rans_planes,
                  devices, *, B, C, tcs, tp, aligned, n_stream, seg,
                  tsplit):
        """K6's inputs of a mode-uniform batch: its groups' encoder
        tables (one pack per distinct frequency table) and segment rows,
        in one shard on the encoder's device, or one per device of the
        mesh. Returns ``(staged, G, N)``: ``staged`` a list of ``(device,
        (symbols, pk, rcp, counts, cap))``, ``G`` the groups of a chunk,
        ``N`` the groups of the batch (filler groups past it)."""
        G = -(-len(segments) // GROUP_ROWS)
        R = GROUP_ROWS
        S = -(-min(seg, n_stream) // LANES)
        N = B * G
        width = len(devices) if devices else 1
        NP = -(-N // width) * width        # filler groups to the width
        freq_arr = np.zeros((NP, R, 256), dtype=np.int64)
        counts_arr = np.zeros((NP, R), dtype=np.int32)
        # Rows past a group's segments and filler groups are inactive
        # (count 0); any >= 2-symbol table keeps their lookups in range.
        freq_arr[:, :, :2] = rans.SCALE // 2
        for b in range(B):
            for gi in range(G):
                i = b * G + gi
                for r, (p, start, n) in enumerate(
                        segments[gi * R:(gi + 1) * R]):
                    ptables, tidx = plane_tables[(b, p)]
                    freq_arr[i, r] = ptables[
                        0 if tidx is None else tidx[start // seg]]
                    counts_arr[i, r] = n
        # Encoder tables once per distinct frequency table.
        uniq, inv = np.unique(freq_arr.reshape(-1, 256), axis=0,
                              return_inverse=True)
        pk_u, rcp_u = pack_encoder_tables(uniq)
        pk_arr = pk_u[inv.reshape(-1)].reshape(NP, R, 256)
        rcp_arr = rcp_u[inv.reshape(-1)].reshape(NP, R, 256)
        cap = symbol_capacity(counts_arr)
        symbols = _gather_symbols(
            planes_d, rans_planes, segments, B=B, G=G, C=C, tcs=tcs,
            tp=tp, aligned=aligned, n_stream=n_stream, seg=seg, S=S,
            tsplit=tsplit)
        if NP > N:
            symbols = torch.cat([symbols, symbols.new_zeros(
                (NP - N, R, S * LANES))])
        # One shard on the encoder's device without a mesh.
        shards = devices or (self.device,)
        per = NP // len(shards)
        staged = [(dev, (symbols[s * per:(s + 1) * per].to(dev),)
                   + tuple(to_device(np.ascontiguousarray(
                       a[s * per:(s + 1) * per]), dev)
                       for a in (pk_arr, rcp_arr, counts_arr))
                   + (cap,)) for s, dev in enumerate(shards)]
        self.last_kernel_args = staged[-1][1]
        return staged, G, N

    def _container(self, b, hists, heads, raw_np, plane_tables, mode_row,
                   rans_planes, raw_planes, group_words, group_states,
                   group_counts, *, T, C, P, k, aligned, split_head,
                   tsplit):
        """Chunk ``b``'s container: the layout of ``AnsCodec.encode``."""
        multitable = any(plane_tables[(b, p)][1] is not None
                         for p in rans_planes)
        flags = (1 | (2 if split_head else 0) | (4 if aligned else 0)
                 | (ans_mod.FLAG_MULTITABLE if multitable else 0)
                 | ans_mod.FLAG_CRC32)
        tdesc = 0
        if self.stamp is not None:
            flags |= ans_mod.FLAG_TRANSFORM
            tdesc = self.stamp[0] | (4 if self.stamp[1] else 0)
        if tsplit > 1:
            flags |= ans_mod.FLAG_TAILSPLIT
        parts = [ans_mod._HEADER.pack(
            ans_mod.MAGIC, ans_mod.CONTAINER_VERSION, P,
            flags, rans.SCALE_BITS, T * C,
            k if aligned else self.codec.seg_log2,
            rans.MIN_FREQ, rans.GROUP_ROWS, tdesc,
            C if split_head else 0, tsplit if tsplit > 1 else 0)]
        if split_head:
            parts.append(np.ascontiguousarray(heads[b]).tobytes())
        for p in range(P):
            m = mode_row[p]
            if m == MODE_CONST:
                # The constant byte: derive from the histogram.
                v = int(np.argmax(hists[b, p]))
                parts.append(struct.pack('<BB', m, v))
            elif m == MODE_RAW:
                parts.append(struct.pack('<B', m)
                             + raw_np[b, raw_planes.index(p)].tobytes())
            else:
                ptables, tidx = plane_tables[(b, p)]
                if multitable:
                    meta = (struct.pack('<BB', m, ptables.shape[0])
                            + ptables.astype('<u2').tobytes())
                    if ptables.shape[0] > 1:
                        meta += tidx.tobytes()
                    parts.append(meta)
                else:
                    parts.append(struct.pack('<B', m)
                                 + ptables[0].astype('<u2').tobytes())
        if rans_planes:
            parts.append(struct.pack('<I', len(group_words[b])))
            parts.append(np.asarray(group_counts[b], '<u4').tobytes())
            for st, wd in zip(group_states[b], group_words[b]):
                parts.append(st.astype('<u4').tobytes())
                parts.append(wd.astype('<u2').tobytes())
        return ans_mod._append_crc(parts)
