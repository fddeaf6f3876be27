"""Batched GPU decode and encode: ``mtscomp_tpu/parallel/pipeline.py``
ported to PyTorch.

Decode.

A batch of B chunk containers is parsed on the host, staged as tensors
(:meth:`DeviceBatchDecoder.pack`, the same arrays as the JAX package's
``pack``), and decoded by eager calls into the port's kernels. K1
(grouped rANS decode, ``ops/rans_decode.py``) writes each group's
row-linear byte rows; then one of two routes, the JAX package's
``_build_decode_fn`` branches:

- **fuse8**: int16/uint16 F-order chunks with a first-order time diff
  (or second: K5 follows), no spatial diff, channel-aligned segments and
  one rANS-coded low byte plane under a constant high byte. K1's rows ARE
  channels, and the fused finalize (K2/K3, ``ops/device_delta.py``) turns
  them into the (B, T, C) samples.
- **generic**: everything else that ``supported()`` accepts (1-, 2- and
  4-byte integers and bitcast floats, rANS/CONST/RAW planes in any mix,
  C or F order, spatial diff, first- or second-order time diff, flags
  bit6 without the tail packing). 2-byte F-order time-diff chunks
  without a spatial diff whose rANS planes sit in K1's rows as whole
  channel-aligned segments (``Layout.plane_form``) go from K1 straight
  into K4's plane form, which reads the byte planes in place, combines
  them, undoes the zigzag, scans and transposes. For every other layout
  the byte planes are reassembled and combined and the inverse zigzag
  applied in plain torch; then K4's element form (fused transpose + time
  scan) for F-order time-diff chunks without a spatial diff, and
  otherwise the layout, spatial cumsum and K5 passes.

K1 uses octet tables when every table of the batch is 8-aligned (what
this codec's writer emits) and its coarse/fixup form otherwise. Unlike
the JAX package, the port always runs K1: the TPU's switch to a scan
decoder for word streams beyond its VMEM window has no cause on the
H100.

Chunks the JAX package also leaves to the host (``supported()`` False
even alone: 8-byte dtypes, a non-native byte order, a head that is not
one full row) decode on the host codec, and the module counts them
(``host_fallback_chunks``).

Encode (:class:`DeviceBatchEncoder`, the Writer's route for ans files):
a batch of equal-shape chunks is uploaded once; diffs, zigzag, the
F-order transpose, the byte planes and their histograms run in plain
torch (``_build_transform_fn``); the plane decisions and segment tables
are made on the host by the codec's own ``decide_plane``; the coded
planes are gathered into (N, 32, S*128) segment rows; K6 (grouped rANS
encode, ``ops/rans_encode.py``) writes each group's states and
right-anchored word stream; the streams are left-aligned and fetched
once, and the containers assembled on the host, byte-identical to the
host codec's. Chunks the device route leaves to the host codec (a dtype
``supported()`` declines, runt sub-batches, layouts ``encode_batch``
declines) are counted (``host_encoded_chunks``).
"""

import dataclasses
import functools
import struct
import time

import numpy as np
import torch

from ..codec import ans as ans_mod
from ..codec.ans import (MODE_CONST, MODE_RANS, MODE_RAW, peek_desc,
                         segment_counts)
from ..codec.ans import seg_freqs as ans_seg_freqs
from ..device import resolve_device
from ..io_host import pread_exact
from ..models import rans
from ..models.rans import GROUP_ROWS, LANES, RANS_L
from ..ops.device_delta import (cumsum_space, cumsum_time,
                                cumsum_time_transposed,
                                cumsum_time_transposed_planes,
                                cumsum_time_transposed_u8,
                                cumsum_time_transposed_u8_tail,
                                diff_space, diff_time, zigzag_decode,
                                zigzag_encode)
from ..ops.device_hist import histogram256
from ..ops.rans_decode import decode_groups, decode_groups_coarse
from ..ops.rans_encode import (encode_groups, left_align,
                               pack_encoder_tables, symbol_capacity)
from ..ops.tables import WINDOW_ROWS, pack_device_tables
from ..utils.misc import logger

#: Chunks decoded on the host codec because ``supported()`` declined
#: their batch (the codec's documented semantics, as in the JAX package).
host_fallback_chunks = 0

#: Chunks the Writer's device route encoded on the host codec (the same
#: bytes): batches ``DeviceBatchEncoder.supported()`` declines, runt
#: sub-batches and layouts ``encode_batch`` declines.
host_encoded_chunks = 0

#: Tensor dtype holding a coding dtype's bits, by item size.
_BITS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.int16),
         4: (torch.int32, np.int32)}


def _fuse8_geom(modes, dtype, zigzag, order, do_time_diff, do_spatial_diff,
                seg, tp, T, S, aligned, has_head):
    """``(fuse8, k)``: whether a batch takes the fused u8 route, and its
    channels per segment. The JAX package's predicate (its ``use_pallas``
    is true here whenever a plane is rANS-coded)."""
    rans_planes = [p for p, m in enumerate(modes) if m == MODE_RANS]
    const_planes = [p for p, m in enumerate(modes) if m == MODE_CONST]
    raw_planes = [p for p, m in enumerate(modes) if m == MODE_RAW]
    k = (seg // tp) if aligned and tp else 0
    seg_eff = min(seg, S * LANES) if rans_planes else 0
    spb_f = max((d for d in range(1, 129) if S % d == 0), default=1) \
        if S else 1
    i16_kind = dtype in (np.dtype(np.int16), np.dtype(np.uint16))
    fuse8 = (bool(rans_planes) and aligned and has_head
             and rans_planes == [0] and not raw_planes
             and len(const_planes) == 1
             and i16_kind and zigzag
             and order == 'F' and do_time_diff and not do_spatial_diff
             and (GROUP_ROWS * k) % 128 == 0
             and seg_eff == seg and spb_f >= 8 and tp >= T)
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
    itemsize: int               # bytes per element (1, 2 or 4)
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
    coding dtype's bits (``_BITS``).
    """
    N = states.shape[0]

    def put(a, view):
        return torch.from_numpy(np.ascontiguousarray(a).view(view)).to(device)

    return (put(states, np.int32), put(words.reshape(N, -1), np.int16),
            put(lookup, np.int32),
            put(dense_pk.reshape(N, GROUP_ROWS, 256), np.int32),
            put(counts, np.int32), put(const_vals, np.uint8),
            put(raw_vals, np.uint8),
            put(heads, _BITS[heads.dtype.itemsize][1]))


def args_from_jax_pack(raw_args, device):
    """The port's decode tensors from the JAX package's staged batch.

    ``raw_args`` are the ten arrays ``mtscomp_tpu``'s
    ``DeviceBatchDecoder.pack`` stages (``states, words, freqs, counts,
    coarse_pk, dense_pk, counts_b, const_vals, raw_vals, heads``), as
    numpy or anything ``np.array`` takes. That pack puts octet rows in
    ``coarse_pk[:, :, 0]`` when its Pallas kernel runs (a rANS plane
    is present and the word buffer fits its 16384-row window) and every
    frequency table is 8-aligned, and coarse tables otherwise; the rule
    is read back from ``freqs`` and ``words`` (its
    ``MTSCOMP_DEC_LOOKUP`` override is not). Lets a test decode the
    identical staged batch in both packages.
    """
    (states, words, freqs, counts, coarse_pk, dense_pk, _counts_b,
     const_vals, raw_vals, heads) = (np.array(a) for a in raw_args)
    N = states.shape[0]
    octet = (bool(counts.any()) and words.size // (N * LANES) <= 16384
             and not np.any(freqs & 7))
    lookup = (coarse_pk[:, :, 0, :] if octet
              else coarse_pk.reshape(N, GROUP_ROWS, 256))
    return _to_tensors(states, words, lookup, dense_pk, counts, const_vals,
                       raw_vals, heads, resolve_device(device))


def check_words_used(parsed_list, used):
    """Compare the per-group word consumption the decode reported to the
    containers' stored stream lengths; IOError on mismatch."""
    n_groups = sum(len(p['groups']) for p in parsed_list)
    if n_groups == 0:
        return
    used = used.cpu().numpy().reshape(-1) if torch.is_tensor(used) \
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
        """Uniform geometry/modes across the batch, integer dtype.

        The JAX package's rule, unchanged: containers that fail here take
        the host path, which raises the decoders' documented IOErrors
        for genuinely malformed inputs.
        """
        if self.dtype.kind not in 'iu':
            return False
        if self.dtype.itemsize > 4:
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
        coding dtype's bits (uint8, int16 or int32 tensor: an int16
        tensor for int16 and uint16 files).

        Raises IOError when any group's stream-word consumption differs
        from its container's stored length (corrupt payload).
        """
        fn, args = self.pack(parsed_list, n_samples)
        out, used = fn(*args)
        check_words_used(parsed_list, used)
        return out

    def decode_batch(self, parsed_list, n_samples):
        """(B, n_samples, n_channels) decoded ndarray in the coding dtype."""
        return self.decode_tensor(parsed_list, n_samples).cpu().numpy().view(
            self.dtype)

    def pack(self, parsed_list, n_samples):
        """Stage a batch: ``(fn, tensors)`` with ``fn(*tensors)`` returning
        ``(samples, words_used)`` on the device; pass ``words_used`` to
        :func:`check_words_used` for the corruption audit
        (:meth:`decode_tensor` does). Staging once and calling ``fn``
        repeatedly amortizes the host-to-device copy.

        The staged arrays are the JAX package's (its ``freqs`` and
        ``counts_b`` aside, which the port's K1 does not read), octet rows
        or coarse tables as its Pallas kernel would take them.
        """
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
                               seg, tp, T, S, aligned, has_head)

        # Ragged-tail decision (fuse8 only): the last group of each chunk
        # holds only the leftover channels (C % k), one short segment or
        # M bit6 sub-rows. Packed after all full groups, it decodes as B
        # short groups and feeds the finalize's second input.
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
            S_t = max((-(-n // LANES) for _, _, n in tail_segs), default=0)
            if (0 < rem < k and contiguous and n_tail == rem * tp
                    and S_t and 2 * S_t <= S and rem <= 32
                    and (G - 1) * GROUP_ROWS * k + 128 <= 1024):
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
        # Word buffers: the JAX package's row bucketing, so both stage
        # identical arrays.
        wr = -(-w_max // LANES) + WINDOW_ROWS
        WR = -(-wr // 512) * 512

        def group_slot(b, gi):
            if tail is None:
                return b * G + gi
            if gi == G - 1:
                return B * (G - 1) + b
            return b * (G - 1) + gi

        NG = max(B * G, 1)
        states = np.full((NG, GROUP_ROWS, LANES), RANS_L, dtype=np.uint32)
        words = np.zeros((NG, WR * LANES), dtype=np.uint16)
        counts = np.zeros((NG, GROUP_ROWS), dtype=np.int32)
        coarse_pk = np.zeros((NG, GROUP_ROWS, 2, LANES), dtype=np.int32)
        octet_pk = np.zeros((NG, GROUP_ROWS, LANES), dtype=np.int32)
        dense_pk = np.zeros((NG, GROUP_ROWS, 2, LANES), dtype=np.int32)
        const_vals = np.zeros((B, max(len(const_planes), 1)), dtype=np.uint8)
        raw_vals = np.zeros((B, max(len(raw_planes), 1),
                             n_coded if raw_planes else 1), dtype=np.uint8)
        heads = np.zeros((B, C), dtype=self.dtype)
        table_cache = {}
        needs_fixup2 = False
        octet_ok = True

        def packed_table(parsed, p, start):
            # Identical tables across chunks (the common case) pack once.
            nonlocal needs_fixup2, octet_ok
            table = ans_seg_freqs(parsed, p, start)
            key = table.tobytes()
            if key not in table_cache:
                table_cache[key] = pack_device_tables(table)
            cpk, dpk, n2, orow = table_cache[key]
            needs_fixup2 = needs_fixup2 or n2
            if orow is None:
                octet_ok = False
                orow = 0
            return cpk, dpk, orow

        for b, parsed in enumerate(parsed_list):
            if has_head:
                heads[b] = parsed['head'].view(self.dtype)
            for gi, g in enumerate(parsed['groups']):
                i = group_slot(b, gi)
                R = len(g['segments'])
                states[i, :R] = g['states']
                words[i, :g['words'].size] = g['words']
                for r, (p, start, n) in enumerate(g['segments']):
                    coarse_pk[i, r], dense_pk[i, r], octet_pk[i, r] = \
                        packed_table(parsed, p, start)
                    counts[i, r] = n
            for j, p in enumerate(const_planes):
                const_vals[b, j] = parsed['planes'][p]['value']
            for j, p in enumerate(raw_planes):
                raw_vals[b, j] = parsed['planes'][p]['raw']

        # K1's lookup: octet rows when every table is 8-aligned, else the
        # coarse tables with one fixup, or two when some 16-slot bucket
        # holds three symbols.
        fixups = 0 if octet_ok else (2 if needs_fixup2 else 1)
        lookup = octet_pk if fixups == 0 else coarse_pk.reshape(
            NG, GROUP_ROWS, 256)
        self.last_tail = tail
        if fuse8:
            fn = functools.partial(_decode_fuse8, B=B, T=T, G=G, S=S, k=k,
                                   tp=tp, tail=tail, fixups=fixups,
                                   diff_order=diff_order)
        else:
            fn = functools.partial(_decode_generic, lay=Layout(
                B=B, T=T, C=C, itemsize=self.dtype.itemsize, modes=modes,
                n_seg=n_seg, seg=seg, G=G, S=S, order=self.order,
                do_time_diff=do_time_diff, diff_order=diff_order,
                do_spatial_diff=do_spatial_diff, zigzag=first['zigzag'],
                has_head=has_head, aligned=aligned, tail_split=tail_split,
                fixups=fixups))
        return fn, _to_tensors(states, words, lookup, dense_pk, counts,
                               const_vals, raw_vals, heads, self.device)


def _read_payload(reader, idx):
    start = reader.chunk_offsets[idx]
    length = reader.chunk_offsets[idx + 1] - start
    return pread_exact(reader.cdata, length, start)


def _uniform_batches(reader, chunk_ids, n_samples, dec):
    """Cut a run into batches of consecutive chunks that ``supported()``
    accepts together: ``[(chunk ids, parsed chunks), ...]``."""
    batches = []
    for idx in chunk_ids:
        parsed = reader.codec.parse(_read_payload(reader, idx))
        if batches and dec.supported([batches[-1][1][0], parsed], n_samples):
            batches[-1][0].append(idx)
            batches[-1][1].append(parsed)
        else:
            batches.append(([idx], [parsed]))
    return batches


def _decode_runs(reader, first_chunk, last_chunk, device):
    """Decode chunks [first, last] batch by batch.

    Runs are consecutive chunks with the same sample count and header
    descriptor (flags bit5 transform, bit6 tail split). Each run is cut
    further into mode-uniform batches (:func:`_uniform_batches`), so a
    file whose plane modes change between chunks (a quiet chunk codes
    its high byte CONST, a busy one rANS) still decodes on the device;
    the JAX package sends such a run to the host codec. Yields ``(row
    offset, block)``: a (n, C) device tensor in the coding dtype's bits,
    or a host ndarray in the reader's dtype for batches that
    ``supported()`` sends to the host codec.
    """
    global host_fallback_chunks
    bounds, offsets = reader.chunk_bounds, reader.chunk_offsets
    ans = reader.algorithm == 'ans'
    runs = []
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
        batches = (_uniform_batches(reader, run_ids, ns, dec) if ans
                   else [(run_ids, None)])
        for chunk_ids, parsed in batches:
            n_span = len(chunk_ids) * ns
            if parsed is not None and dec.supported(parsed, ns):
                yield pos, dec.decode_tensor(parsed, ns).reshape(
                    n_span, reader.n_channels)
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

    Each run lands in one span-wide destination: ``out`` if given (a
    ``(samples of the span, C)`` array of the reader's dtype, which is
    returned), else allocated here. Without ``out``, a span that decodes
    as one run returns the fetched buffer itself, with no copy.
    ``writable`` has the JAX package's meaning: ``False`` allows a
    read-only result, ``True`` never returns one. The port's fetch
    (``Tensor.cpu().numpy()``) is always a fresh writable host array, so
    both values return it as it comes.
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
    code = np.dtype(getattr(reader, 'code_dtype', reader.dtype))
    for pos, block in _decode_runs(reader, first_chunk, last_chunk, device):
        if torch.is_tensor(block):
            block = block.cpu().numpy().view(code).view(reader.dtype)
        if out is None and block.shape[0] == total:
            return block
        if out is None:
            out = np.empty(shape, reader.dtype)
        out[pos:pos + block.shape[0]] = block
    return out


def decompress_to_tensor(reader, first_chunk=0, last_chunk=None,
                         device='cuda'):
    """Chunks [first, last] as one device-resident (n, C) tensor in the
    reader's dtype; nothing is fetched to the host."""
    device = resolve_device(device)
    last_chunk, total = _span(reader, first_chunk, last_chunk)
    dtype = _torch_dtype(reader.dtype)
    out = None
    for pos, block in _decode_runs(reader, first_chunk, last_chunk, device):
        if torch.is_tensor(block):
            block = block.view(dtype)
        else:
            block = torch.from_numpy(np.ascontiguousarray(
                block, block.dtype.newbyteorder('='))).to(device)
        if block.shape[0] == total:
            return block
        if out is None:
            out = torch.empty((total, reader.n_channels), dtype=dtype,
                              device=device)
        out[pos:pos + block.shape[0]].copy_(block)
    return out


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


# Mixed-mode encode batches split into mode-uniform sub-batches; runs
# smaller than this take the host codec (byte-identical) instead, as in
# the JAX package.
MIN_DEVICE_SUBBATCH = 4


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
        #: K6's staged inputs of the last batch with a rANS plane:
        #: ``(symbols, pk, rcp, counts, cap)`` on the device.
        self.last_kernel_args = None
        #: Host-clock seconds by layer, accumulated over encode_batch
        #: calls when set to a dict (each layer ends in a synchronize).
        self.profile = None

    def supported(self, n_samples):
        """1- and 2-byte integers in native order, chunks of at least
        two samples, fewer than 65536 channels (the JAX package's
        rule)."""
        return (self.dtype.kind in 'iu' and self.dtype.itemsize <= 2
                and self.dtype.byteorder in '<=|'
                and n_samples > 1
                and self.writer.n_channels < 65536)

    def _mark(self, name, t0):
        """Close layer ``name`` opened at ``t0``; returns the new time."""
        if self.profile is None:
            return t0
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.profile[name] = self.profile.get(name, 0.0) + (t1 - t0)
        return t1

    def _host_encode(self, chunk):
        """One chunk (host ndarray) through the host codec."""
        return self.codec.encode(
            self.writer._transform_chunk(chunk, self.diff_order,
                                         self.do_spatial_diff),
            order=self.order, transform=self.stamp)

    def encode_batch(self, chunks):
        """chunks: (B, T, C) ndarray in the coding dtype, or a tensor on
        the device holding its bits (``_BITS``) -> list of container
        payload bytes, or None for a layout the device route leaves to
        the host codec (segment tables without channel-aligned
        segments, as in the JAX package)."""
        global host_encoded_chunks
        t0 = time.perf_counter()
        B, T, C = chunks.shape
        P = self.dtype.itemsize
        seg = self.codec.seg
        if torch.is_tensor(chunks):
            x = chunks
        else:
            x = torch.from_numpy(np.ascontiguousarray(chunks).view(
                _BITS[P][1])).to(self.device)
        t0 = self._mark('upload', t0)
        transform = _build_transform_fn(
            B, T, C, str(self.dtype), self.order, self.do_time_diff,
            self.do_spatial_diff, True, self.diff_order)
        planes_d, hists_d, head_d = transform(x)
        hists = hists_d.cpu().numpy()
        heads = head_d.cpu().numpy()
        n_coded = (T - 1) * C

        # Channel-aligned segments (flags bit2): same eligibility rule
        # and geometry as the host codec (AnsCodec.encode).
        aligned = (getattr(self.codec, 'channel_aligned', False)
                   and self.order == 'F' and n_coded > 0)
        if aligned:
            k, seg, tp, tcs, n_stream = ans_mod.aligned_geometry(
                n_coded, C, seg)
        else:
            k = tp = tcs = 0
            n_stream = n_coded
        n_pad = n_stream - n_coded
        seg_mode = getattr(self.codec, 'table_mode', 'plane') == 'segment'
        if seg_mode and not aligned:
            return None    # host codec handles non-aligned clustering

        # Per-channel histograms for segment-table clustering: the
        # F-order plane stream is channel-major, so per-segment
        # histograms are sums of per-channel ones (plus the per-channel
        # zero pads) -- bit-identical to the host codec's bincounts.
        ch_hists = None
        if seg_mode and n_stream > seg:
            ch_hists = histogram256(planes_d.view(B * P * C, tcs)).view(
                B, P, C, 256).cpu().numpy()
        n_segs = -(-n_stream // seg) if aligned else 0
        t0 = self._mark('transform', t0)

        def _seg_hists(b, p):
            out = np.empty((n_segs, 256), dtype=np.int64)
            for s in range(n_segs):
                a, z = s * k, min((s + 1) * k, C)
                out[s] = ch_hists[b, p, a:z].sum(axis=0)
                out[s, 0] += (z - a) * (tp - tcs)
            return out

        # Host: tables + per-plane modes (uniform across the batch for
        # one device call; mixed batches split below). The decision
        # logic is ans_mod.decide_plane -- the SAME code the host codec
        # runs, so containers stay byte-identical.
        modes = np.empty((B, P), dtype=np.int64)
        plane_tables = {}
        for b in range(B):
            for p in range(P):
                seg_fn = ((lambda b=b, p=p: _seg_hists(b, p))
                          if ch_hists is not None else None)
                mode, ptables, tidx = ans_mod.decide_plane(
                    hists[b, p], n_pad, n_stream, n_coded, seg,
                    'segment' if seg_mode else 'plane', seg_fn)
                modes[b, p] = mode
                if mode == MODE_RANS:
                    plane_tables[(b, p)] = (ptables, tidx)
        if not (modes == modes[0]).all():
            # Plane modes are data-dependent per chunk (a quiet chunk
            # codes its high byte CONST, a busy one rANS): encode each
            # mode-uniform sub-batch on the device (decide_plane is
            # deterministic, so each passes the uniformity check on
            # re-entry); sub-batches below MIN_DEVICE_SUBBATCH chunks go
            # to the host codec (the same bytes), as in the JAX package.
            payloads = [None] * B
            for row in sorted({tuple(m) for m in modes.tolist()}):
                ids = [b for b in range(B) if tuple(modes[b]) == row]
                if len(ids) < MIN_DEVICE_SUBBATCH:
                    host_encoded_chunks += len(ids)
                    for b in ids:
                        chunk = (chunks[b] if not torch.is_tensor(chunks)
                                 else chunks[b].cpu().numpy().view(
                                     self.dtype))
                        payloads[b] = self._host_encode(chunk)
                    continue
                sub = self.encode_batch(
                    chunks[torch.tensor(ids, device=chunks.device)]
                    if torch.is_tensor(chunks)
                    else np.ascontiguousarray(chunks[ids]))
                for j, b in enumerate(ids):
                    payloads[b] = sub[j]
            return payloads
        mode_row = [int(m) for m in modes[0]]
        rans_planes = [p for p, m in enumerate(mode_row) if m == MODE_RANS]
        raw_planes = [p for p, m in enumerate(mode_row) if m == MODE_RAW]

        # Ragged-tail segment split (flags bit6): identical decision to
        # the host codec (shared helper).
        tsplit = ans_mod.tail_split_for(aligned, mode_row, n_stream, seg)

        group_words, group_states, group_counts = [], [], []
        if rans_planes:
            segments = segment_counts(n_stream, seg, mode_row,
                                      tail_split=tsplit)
            G = -(-len(segments) // GROUP_ROWS)
            R = GROUP_ROWS
            S = -(-min(seg, n_stream) // LANES)
            freq_arr = np.zeros((B * G, R, 256), dtype=np.int64)
            counts_arr = np.zeros((B * G, R), dtype=np.int32)
            # Rows past a group's segments are inactive (count 0); any
            # >= 2-symbol table keeps their lookups in range.
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
            pk_arr = pk_u[inv.reshape(-1)].reshape(B * G, R, 256)
            rcp_arr = rcp_u[inv.reshape(-1)].reshape(B * G, R, 256)
            cap = symbol_capacity(counts_arr)
            t0 = self._mark('host_decisions', t0)
            symbols = _gather_symbols(
                planes_d, rans_planes, segments, B=B, G=G, C=C, tcs=tcs,
                tp=tp, aligned=aligned, n_stream=n_stream, seg=seg, S=S,
                tsplit=tsplit)
            dev = self.device
            args = (symbols, torch.from_numpy(pk_arr).to(dev),
                    torch.from_numpy(rcp_arr).to(dev),
                    torch.from_numpy(counts_arr).to(dev), cap)
            self.last_kernel_args = args
            t0 = self._mark('gather_stage', t0)
            states_d, words_d, nw_d = encode_groups(*args)
            t0 = self._mark('k6', t0)
            flat, n_words = left_align(words_d, nw_d)
            states = states_d.cpu().numpy().view(np.uint32)
            t0 = self._mark('align_fetch', t0)
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
        else:
            t0 = self._mark('host_decisions', t0)

        raw_np = (planes_d[:, raw_planes].cpu().numpy() if raw_planes
                  else None)

        # Host: assemble containers (identical layout to AnsCodec.encode).
        payloads = []
        for b in range(B):
            multitable = any(plane_tables[(b, p)][1] is not None
                             for p in rans_planes)
            flags = (1 | 2 | (4 if aligned else 0)
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
                rans.MIN_FREQ, rans.GROUP_ROWS, tdesc, C,
                tsplit if tsplit > 1 else 0)]
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
            payloads.append(ans_mod._append_crc(parts))
        self._mark('assembly', t0)
        return payloads
