"""The delta transform on the device, the port's counterpart of
``mtscomp_tpu/ops/device_delta.py``: the encode's diffs and zigzag, and
the decode's time and channel integration.

Kernels (each entry point launches its CUDA kernel for CUDA tensors and
runs its plain PyTorch twin, ``*_ref``, for CPU tensors; nothing else
selects between them):

- K4 (``csrc/scan_transposed.cu``), the transpose + time scan, in forms
  that share the kernel bodies and differ in their load stage:
  ``cumsum_time_transposed`` scans int16/int32 elements, and
  ``cumsum_time_transposed_planes`` reads a 2-byte element's two byte
  planes itself (K1's rows or a RAW plane viewed in place, or a CONST
  plane's value per chunk), combines them and undoes the zigzag on the
  way in, so that no torch pass runs between K1 and the scan.
- K2 + K3, the fused finalize of the fuse8 decode:
  ``cumsum_time_transposed_u8`` and ``cumsum_time_transposed_u8_tail``
  keep the JAX names and are a third load stage of the same kernels: the
  plane form with a CONST high plane (no memory read for it), the zigzag
  and a head, the low plane in one channel block or two. On the card
  K3's ragged tail is just a second pointer, chosen per channel row, so
  one transposed-scan kernel family serves the TPU's three kernels.
- K5, ``cumsum_time`` (``csrc/cumsum_time.cu``): the carried time cumsum
  of time-major int16/int32 samples.

K4 and K5 split time into segments, one block each: a pass of segment
totals into a scratch tensor the wrapper allocates, their exclusive
prefixes, then the seeded scan of each segment. The wrappers fix the
segment length and the channel tile (``cumsum_time_geometry``,
``scan_transposed_geometry``); a call counts as one launch.

Unlike the TPU kernels, every output is written at its final shape: no
128-multiple padding of time or channels to trim afterwards.

Plain ops (XLA ops in the JAX package, plain torch here): the encode's
``diff_time``, ``diff_space`` and ``zigzag_encode`` and the decode's
``zigzag_decode``, ``cumsum_space`` and ``cumsum_time_ref`` (the
counterparts of ``diff_time_jnp``, ``diff_space_jnp``,
``zigzag_encode_jnp``, ``zigzag_decode_jnp``, ``cumsum_space_jnp`` and
``cumsum_time_jnp``). torch has almost no uint16/uint32 arithmetic, so
they take the values as same-width integer bits (uint8, int8, int16,
int32). The encode's ops compute in the element's width, where torch's
integer arithmetic wraps; the decode's widen to int64 where a sum
could leave it.
"""

import torch

from . import _build

#: Kernel launches in this process, by kernel form (CUDA calls only; the
#: twins never count): the finalize (K2) through
#: :func:`cumsum_time_transposed_u8` and its tail form (K3) through
#: :func:`cumsum_time_transposed_u8_tail`; K4 through
#: :func:`cumsum_time_transposed` by element type and mode (seeded by a
#: head, or inclusive) and its plane form through
#: :func:`cumsum_time_transposed_planes` by mode; K5 through
#: :func:`cumsum_time` by element type. A multi-pass kernel counts one
#: launch a call.
launches = {'finalize_u8': 0, 'finalize_u8_tail': 0,
            'scan_transposed_i16_seeded': 0,
            'scan_transposed_i16_inclusive': 0,
            'scan_transposed_i32_seeded': 0,
            'scan_transposed_i32_inclusive': 0,
            'scan_planes_i16_seeded': 0, 'scan_planes_i16_inclusive': 0,
            'cumsum_time_i16': 0, 'cumsum_time_i32': 0}

#: The scan kernels' element types (1-byte data is widened by callers),
#: and their names in the launch counts.
SCAN_DTYPES = (torch.int16, torch.int32)
_WIDTH = {torch.int16: 'i16', torch.int32: 'i32'}


def cumsum_time_transposed_u8(planes, head, hi, n_samples=None):
    """(B, C', T') u8 low-byte codes -> (B, T, C) decoded int16 samples.

    ``planes[b, c, i]`` is the low byte of channel c's zigzagged time
    diff i (rows contiguous along time; batch and channel strides are
    free, so a row-linear K1 output views in with no copy); ``hi`` (B,)
    is each chunk's constant high byte; ``head`` (B, C) int16 the
    verbatim first samples, with C <= C' (extra rows are ignored).
    Output sample t is ``head + sum(unzigzag(planes[..., :t]))`` modulo
    2^16, for t < T = ``n_samples`` (default T'; at most T' + 1).

    The CUDA kernel needs time stride 1 and nothing else of the rows.
    Rows off the 16-byte grid (a base, batch stride or channel stride;
    K1's rows and a gathered tail block are on it) only slow it: it then
    loads one byte a lane instead of 16.
    """
    return _finalize(planes, None, head, hi, n_samples)


def cumsum_time_transposed_u8_tail(planes, tail, head, tail_head, hi,
                                   n_samples=None):
    """:func:`cumsum_time_transposed_u8` over two channel blocks.

    ``planes`` (B, CA, T') holds channels [0, CA) and ``tail``
    (B, CB', T') the ragged tail channels [CA, CA + CB) with CB =
    ``tail_head.shape[1]`` <= CB'; ``head`` (B, CA) and ``tail_head``
    (B, CB) int16. Returns (B, T, CA + CB) int16.
    """
    return _finalize(planes, tail, torch.cat([head, tail_head], dim=1), hi,
                     n_samples)


def cumsum_time_transposed_u8_ref(planes, head, hi, n_samples=None):
    """Plain PyTorch twin of :func:`cumsum_time_transposed_u8`."""
    return _finalize_ref(planes, None, head, hi,
                         _n_samples(planes, n_samples))


def cumsum_time_transposed_u8_tail_ref(planes, tail, head, tail_head, hi,
                                       n_samples=None):
    """Plain PyTorch twin of :func:`cumsum_time_transposed_u8_tail`."""
    return _finalize_ref(planes, tail, torch.cat([head, tail_head], dim=1),
                         hi, _n_samples(planes, n_samples))


def _n_samples(planes, n_samples):
    T = planes.shape[2] if n_samples is None else int(n_samples)
    if not 0 <= T <= planes.shape[2] + 1:
        raise ValueError("n_samples %d needs %d diffs per channel, the "
                         "planes hold %d" % (T, T - 1, planes.shape[2]))
    return T


def _check_args(planes, tail, head, hi):
    B = planes.shape[0]
    C = head.shape[1] if head.dim() == 2 else -1
    if planes.dtype != torch.uint8 or planes.dim() != 3:
        raise ValueError("planes must be (B, C, T) uint8")
    if head.dtype != torch.int16 or tuple(head.shape) != (B, C):
        raise ValueError("head must be (B, C) int16")
    if hi.dim() != 1 or hi.shape[0] != B or hi.dtype not in (torch.uint8,
                                                             torch.int32):
        raise ValueError("hi must be (B,) uint8 or int32")
    if tail is None:
        if C > planes.shape[1]:
            raise ValueError("head has %d channels, planes only %d"
                             % (C, planes.shape[1]))
    else:
        if (tail.dtype != torch.uint8 or tail.dim() != 3
                or tail.shape[0] != B or tail.shape[2] != planes.shape[2]):
            raise ValueError("tail must be (B, CB, T) uint8 like planes")
        if not planes.shape[1] <= C <= planes.shape[1] + tail.shape[1]:
            raise ValueError("heads cover %d channels; planes + tail hold "
                             "%d + %d" % (C, planes.shape[1], tail.shape[1]))
    for t in (planes, tail, head, hi):
        if t is not None and t.device != planes.device:
            raise ValueError("all inputs must be on one device")


def _finalize(planes, tail, head, hi, n_samples):
    _check_args(planes, tail, head, hi)
    T = _n_samples(planes, n_samples)
    if planes.device.type == 'cpu':
        return _finalize_ref(planes, tail, head, hi, T)
    return _launch(planes, tail, head, hi, T)


def _finalize_blocks(planes, tail, C, T):
    """The low plane's channel blocks as the kernel reads them: ``(bulk,
    tail block or None)``, views over the ``T - 1`` coded steps of the
    ``C`` head channels. An empty block drops out."""
    n_coded = max(T - 1, 0)
    if tail is None:
        return planes[:, :C, :n_coded], None
    bulk = planes[:, :, :n_coded]
    tail = tail[:, :C - planes.shape[1], :n_coded]
    if bulk.shape[1] == 0 or tail.shape[1] == 0:
        return (tail if bulk.shape[1] == 0 else bulk), None
    return bulk, tail


def _launch(planes, tail, head, hi, T):
    """The finalize on the card: K4's kernels behind the finalize load
    stage (``mts_finalize_u8`` in ``csrc/scan_transposed.cu``)."""
    if planes.device.type != 'cuda':
        raise ValueError("the finalize runs on CUDA or CPU tensors, not %s"
                         % planes.device)
    for name, t in (('planes', planes), ('tail', tail)):
        if t is not None and t.stride(2) != 1 and t.shape[2] > 1:
            raise ValueError("%s rows must be time-contiguous" % name)
    B, C = head.shape
    head = head.contiguous()
    hi = hi.to(torch.uint8).contiguous()
    out = torch.empty((B, T, C), dtype=torch.int16, device=planes.device)
    if out.numel() == 0:
        return out
    bulk, tail_block = _finalize_blocks(planes, tail, C, T)
    n_steps, c_tile = scan_transposed_geometry(C, 2)
    scratch = _scratch(B, T, n_steps, C, planes.device)
    lib = _build.library()
    rc = lib.mts_finalize_u8(
        planes.device.index, bulk.data_ptr(), bulk.stride(0), bulk.stride(1),
        bulk.shape[1], _ptr(tail_block),
        0 if tail_block is None else tail_block.stride(0),
        0 if tail_block is None else tail_block.stride(1),
        head.data_ptr(), hi.data_ptr(), out.data_ptr(), _ptr(scratch), B, C,
        T, bulk.shape[2], n_steps, c_tile, _build.stream_handle(planes))
    _build.check(lib, rc, 'finalize_u8')
    launches['finalize_u8' if tail is None else 'finalize_u8_tail'] += 1
    return out


def _finalize_ref(planes, tail, head, hi, T):
    B, C = head.shape
    lo = planes[:, :C] if tail is None else torch.cat(
        [planes, tail[:, :C - planes.shape[1]]], dim=1)
    z = lo[:, :, :max(T - 1, 0)].to(torch.int64) \
        | (hi.to(torch.int64)[:, None, None] << 8)
    d = (z >> 1) ^ -(z & 1)
    excl = torch.cat([torch.zeros((B, C, 1), dtype=torch.int64,
                                  device=planes.device),
                      torch.cumsum(d, dim=2)], dim=2)[:, :, :T]
    v = (excl + head.to(torch.int64)[:, :, None]) & 0xFFFF
    v = v - ((v >> 15) << 16)                     # to the int16 range
    return v.to(torch.int16).transpose(1, 2).contiguous()


# --- plain ops ----------------------------------------------------------

def diff_time(x):
    """Batched time diff of (B, T, C) integers, row 0 kept, wrapping in
    the element's width (the JAX package's ``diff_time_jnp``)."""
    return torch.cat([x[:, :1], x[:, 1:] - x[:, :-1]], dim=1)


def diff_space(x):
    """Batched channel diff of (B, T, C) integers, column 0 kept,
    wrapping in the element's width (``diff_space_jnp``)."""
    return torch.cat([x[:, :, :1], x[:, :, 1:] - x[:, :, :-1]], dim=2)


#: The signed dtype of each integer width (the zigzag's arithmetic shift).
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def zigzag_encode(v):
    """Zigzag of integers held as uint8, int8, int16 or int32 bits ->
    the codes' bits in the same dtype: ``(s << 1) ^ (s >> (bits - 1))``
    on the signed view ``s`` of the same width, as
    ``zigzag_encode_jnp`` (wrapped diffs of unsigned data are small in
    the signed sense)."""
    s = v.view(_SIGNED[v.element_size()])
    return ((s + s) ^ (s >> (8 * v.element_size() - 1))).view(v.dtype)


def wrap_to(v, dtype):
    """int64 ``v`` modulo 2^bits as ``dtype`` (uint8, int8, int16, int32):
    the in-dtype wrap of the JAX package's integer ops."""
    bits = torch.iinfo(dtype).bits
    v = v & ((1 << bits) - 1)
    if dtype.is_signed:
        v = v - ((v >> (bits - 1)) << bits)
    return v.to(dtype)


def zigzag_decode(z):
    """Inverse zigzag of codes held as uint8, int16 or int32 bits ->
    the decoded integers' bits in the same dtype, ``(z >>> 1) ^ -(z &
    1)`` computed in that dtype (no widening pass)."""
    if z.dtype == torch.uint8:
        return (z >> 1) ^ ((z & 1) * 255)
    if z.dtype not in SCAN_DTYPES:
        raise ValueError("zigzag_decode takes uint8, int16 or int32 codes, "
                         "not %s" % z.dtype)
    # Logical right shift: torch's >> on signed ints is arithmetic.
    return ((z >> 1) & torch.iinfo(z.dtype).max) ^ -(z & 1)


def cumsum_space(d):
    """In-dtype (wrapping) cumsum over channels of (B, T, C) integers."""
    return wrap_to(torch.cumsum(d.to(torch.int64), dim=2), d.dtype)


def cumsum_time_ref(d):
    """Plain PyTorch twin of :func:`cumsum_time` (the JAX package's
    ``cumsum_time_jnp``): in-dtype cumsum over time of (B, T, C)."""
    return wrap_to(torch.cumsum(d.to(torch.int64), dim=1), d.dtype)


# --- K5: carried time cumsum --------------------------------------------

#: K5's block tile: at most this many bytes of one chunk's time segment in
#: shared memory, and at most this many time steps a segment.
K5_TILE_BYTES = 64 * 1024
K5_SEG_STEPS = 64


def cumsum_time_geometry(C, itemsize):
    """``(n_steps, c_tile)`` of K5's split of a (B, T, C) tensor: time
    steps a segment and channels a tile. All channels make one tile (a
    segment is then one contiguous span) unless one time step's row
    exceeds the tile; the tiles are then even."""
    c_max = K5_TILE_BYTES // itemsize
    c_tile = -(-C // -(-C // c_max)) if C > c_max else max(C, 1)
    return max(1, min(K5_SEG_STEPS,
                      K5_TILE_BYTES // (c_tile * itemsize))), c_tile


def _scratch(B, T, n_steps, C, device):
    """The (B, segments, C) totals of a split scan; None for one segment."""
    n_seg = -(-T // n_steps)
    if n_seg <= 1:
        return None
    return torch.empty((B, n_seg, C), dtype=torch.int32, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def cumsum_time(d):
    """(B, T, C) int16/int32 -> its wrapping cumsum over time (K5).

    The CUDA kernel writes a new contiguous tensor; ``d`` is read as
    contiguous (a strided ``d`` is copied first).
    """
    if d.dim() != 3 or d.dtype not in SCAN_DTYPES:
        raise ValueError("cumsum_time takes (B, T, C) int16 or int32, got "
                         "%s %s" % (d.dtype, tuple(d.shape)))
    if d.device.type == 'cpu':
        return cumsum_time_ref(d)
    if d.device.type != 'cuda':
        raise ValueError("cumsum_time runs on CUDA or CPU tensors, not %s"
                         % d.device)
    d = d.contiguous()
    B, T, C = d.shape
    out = torch.empty_like(d)
    if out.numel() == 0:
        return out
    n_steps, c_tile = cumsum_time_geometry(C, d.element_size())
    scratch = _scratch(B, T, n_steps, C, d.device)
    lib = _build.library()
    rc = lib.mts_cumsum_time(d.device.index, d.data_ptr(), out.data_ptr(),
                             _ptr(scratch), B, T, C, n_steps, c_tile,
                             d.element_size(), _build.stream_handle(d))
    _build.check(lib, rc, 'cumsum_time')
    launches['cumsum_time_' + _WIDTH[d.dtype]] += 1
    return out


# --- K4: transpose + time scan ------------------------------------------

#: K4's time steps a segment by element size (a tile row of 32 words), and
#: its largest channel tile (one thread a channel).
K4_SEG_STEPS = {2: 64, 4: 32}
K4_MAX_C_TILE = 256


def scan_transposed_geometry(C, itemsize):
    """``(n_steps, c_tile)`` of K4's split: time steps a segment, and
    channels a tile (even tiles of at most 256, rounded up to 32)."""
    per = -(-C // -(-C // K4_MAX_C_TILE)) if C > 0 else 1
    return K4_SEG_STEPS[itemsize], -(-per // 32) * 32


def cumsum_time_transposed(elems, head=None, n_samples=None):
    """(B, C, T') int16/int32 channel-major -> (B, T, C) integrated (K4).

    Without ``head`` the scan is inclusive: ``out[:, t] = sum(elems[:, :,
    :t+1])``, T = ``n_samples`` <= T' (default T'). With ``head`` (B, C)
    of the same dtype it is exclusive and seeded by the head: ``out[:, t]
    = head + sum(elems[:, :, :t])``, T <= T' + 1 (default T'). Both wrap
    modulo the element width. ``elems`` rows must be time-contiguous;
    batch and channel strides are free.
    """
    T = _scan_t_check(elems, head, n_samples)
    if elems.device.type == 'cpu':
        return _scan_t_ref(elems, head, T)
    if elems.device.type != 'cuda':
        raise ValueError("cumsum_time_transposed runs on CUDA or CPU "
                         "tensors, not %s" % elems.device)
    if elems.stride(2) != 1 and elems.shape[2] > 1:
        raise ValueError("elems rows must be time-contiguous")
    B, C, t_in = elems.shape
    if head is not None:
        head = head.contiguous()
    out = torch.empty((B, T, C), dtype=elems.dtype, device=elems.device)
    if out.numel() == 0:
        return out
    n_steps, c_tile = scan_transposed_geometry(C, elems.element_size())
    scratch = _scratch(B, T, n_steps, C, elems.device)
    lib = _build.library()
    rc = lib.mts_scan_transposed(
        elems.device.index, elems.data_ptr(), elems.stride(0),
        elems.stride(1), _ptr(head), out.data_ptr(), _ptr(scratch), B, C, T,
        t_in, n_steps, c_tile, elems.element_size(),
        _build.stream_handle(elems))
    _build.check(lib, rc, 'scan_transposed')
    launches['scan_transposed_%s_%s' % (
        _WIDTH[elems.dtype], 'inclusive' if head is None else 'seeded')] += 1
    return out


def cumsum_time_transposed_ref(elems, head=None, n_samples=None):
    """Plain PyTorch twin of :func:`cumsum_time_transposed`."""
    return _scan_t_ref(elems, head, _scan_t_check(elems, head, n_samples))


def _scan_t_check(elems, head, n_samples):
    if elems.dim() != 3 or elems.dtype not in SCAN_DTYPES:
        raise ValueError("cumsum_time_transposed takes (B, C, T) int16 or "
                         "int32, got %s %s" % (elems.dtype,
                                               tuple(elems.shape)))
    return _scan_t_head(elems, head, n_samples, elems.dtype)


def _scan_t_head(rows, head, n_samples, dtype):
    """Check ``head`` against the (B, C, T') ``rows`` it seeds and return
    the output's T."""
    B, C, t_in = rows.shape
    if head is not None:
        if head.dtype != dtype or tuple(head.shape) != (B, C):
            raise ValueError("head must be (B, C) %s" % dtype)
        if head.device != rows.device:
            raise ValueError("all inputs must be on one device")
    T = t_in if n_samples is None else int(n_samples)
    if not 0 <= T <= t_in + (head is not None):
        raise ValueError("n_samples %d out of range for %d elements per "
                         "channel" % (T, t_in))
    return T


def _scan_t_ref(elems, head, T):
    B, C, _ = elems.shape
    s = torch.cumsum(elems.to(torch.int64), dim=2)
    if head is not None:
        s = torch.cat([torch.zeros((B, C, 1), dtype=torch.int64,
                                   device=elems.device), s], dim=2)
        s = s + head.to(torch.int64)[:, :, None]
    return wrap_to(s[:, :, :T], elems.dtype).transpose(1, 2).contiguous()


# --- K4, plane form: byte planes -> combine, unzigzag, scan, transpose ---

def cumsum_time_transposed_planes(lo, hi, head=None, n_samples=None,
                                  zigzag=True):
    """The two byte planes of 2-byte elements -> (B, T, C) int16 samples
    (K4, plane form): ``elem = lo | hi << 8``, the inverse zigzag where
    ``zigzag`` is set, then :func:`cumsum_time_transposed` of the elements
    (inclusive, or exclusive and seeded by the int16 ``head`` (B, C)).

    A plane is a uint8 (B, C, T') tensor whose rows are time-contiguous
    (batch and channel strides are free: a view of K1's rows, pads
    skipped, or of a RAW plane), or a uint8 (B,) tensor, one constant per
    chunk (a CONST plane). At least one plane is a (B, C, T') tensor.
    """
    rows, T = _planes_check(lo, hi, head, n_samples)
    if rows.device.type == 'cpu':
        return _scan_t_ref(_planes_elems_ref(lo, hi, zigzag), head, T)
    if rows.device.type != 'cuda':
        raise ValueError("cumsum_time_transposed_planes runs on CUDA or CPU "
                         "tensors, not %s" % rows.device)
    B, C, t_in = rows.shape
    if head is not None:
        head = head.contiguous()
    out = torch.empty((B, T, C), dtype=torch.int16, device=rows.device)
    if out.numel() == 0:
        return out
    n_steps, c_tile = scan_transposed_geometry(C, 2)
    scratch = _scratch(B, T, n_steps, C, rows.device)
    lo_args, lo = _plane_args(lo)
    hi_args, hi = _plane_args(hi)
    lib = _build.library()
    rc = lib.mts_scan_transposed_planes(
        rows.device.index, *lo_args, *hi_args, int(bool(zigzag)), _ptr(head),
        out.data_ptr(), _ptr(scratch), B, C, T, t_in, n_steps, c_tile,
        _build.stream_handle(rows))
    _build.check(lib, rc, 'scan_transposed_planes')
    launches['scan_planes_i16_%s'
             % ('inclusive' if head is None else 'seeded')] += 1
    return out


def _plane_args(p):
    """A byte plane's C arguments ``[rows, batch stride, channel stride,
    consts]``, and the tensor they point into."""
    if p.dim() == 3:
        return [p.data_ptr(), p.stride(0), p.stride(1), None], p
    p = p.contiguous()
    return [None, 0, 0, p.data_ptr()], p


def cumsum_time_transposed_planes_ref(lo, hi, head=None, n_samples=None,
                                      zigzag=True):
    """Plain PyTorch twin of :func:`cumsum_time_transposed_planes`: the
    generic route's plane combine and inverse zigzag, then the element
    form's twin."""
    _rows, T = _planes_check(lo, hi, head, n_samples)
    return _scan_t_ref(_planes_elems_ref(lo, hi, zigzag), head, T)


def _planes_check(lo, hi, head, n_samples):
    """``(a (B, C, T') plane, T)`` of the plane form's checked inputs."""
    rows = [p for p in (lo, hi) if p.dim() == 3]
    if not rows:
        raise ValueError("at least one byte plane must be a (B, C, T) "
                         "tensor")
    shape = rows[0].shape
    for p in (lo, hi):
        if p.dtype != torch.uint8:
            raise ValueError("byte planes must be uint8, got %s" % p.dtype)
        if p.dim() == 3:
            if p.shape != shape:
                raise ValueError("the byte planes differ in shape: %s, %s"
                                 % (tuple(shape), tuple(p.shape)))
            if p.stride(2) != 1 and shape[2] > 1:
                raise ValueError("plane rows must be time-contiguous")
        elif tuple(p.shape) != (shape[0],):
            raise ValueError("a constant plane must be (B,) = (%d,), got %s"
                             % (shape[0], tuple(p.shape)))
        if p.device != rows[0].device:
            raise ValueError("all inputs must be on one device")
    return rows[0], _scan_t_head(rows[0], head, n_samples, torch.int16)


def _planes_elems_ref(lo, hi, zigzag):
    """The planes' (B, C, T') int16 elements: the little-endian byte
    combine and the inverse zigzag of the generic route."""
    shape = next(p for p in (lo, hi) if p.dim() == 3).shape
    acc = torch.stack([p if p.dim() == 3 else p[:, None, None].expand(shape)
                       for p in (lo, hi)], dim=3).contiguous()
    elems = acc.view(torch.int16).view(shape)
    return zigzag_decode(elems) if zigzag else elems
