"""A frozen, plain NumPy decoder of the v2 (``algorithm='ans'``) format.

Written from the format's specification (the repository's FORMAT.md) and
the normative coder it names, and kept here so that no change to the
program moves the yardstick that judges it. It imports nothing of the
program: it reads a ``.ch`` sidecar and ``.cbin`` chunk payloads and
returns the decoded samples, for integer dtypes (and v2 float files,
which code the same-width integer bits).

The rANS stage decodes every group of a chunk at once, one step of all
lanes at a time, in the decoder order the format fixes: at each step the
lanes whose state falls below 2**16 read one 16-bit word each from their
group's stream, in row-major lane order. Every structural check the
format names raises ``ValueError``: the CRC32, the frequency tables, the
group count, the words each group consumes and trailing bytes.
"""

import json
import struct
import zlib

import numpy as np

MAGIC = 0x3253544D
HEADER = struct.Struct('<IBBBBIBBBBHH')
SCALE_BITS = 12
SCALE = 1 << SCALE_BITS
RANS_L = 1 << 16
LANES = 128
GROUP_ROWS = 32
MIN_FREQ = 8
RAW, RANS, CONST = 0, 1, 2
F_ZIGZAG, F_HEAD, F_ALIGNED, F_CRC = 1, 2, 4, 8
F_MULTITABLE, F_TRANSFORM, F_TAILSPLIT = 16, 32, 64


def read_sidecar(path):
    with open(path) as f:
        return json.load(f)


def _table(buf, off):
    freqs = np.frombuffer(buf, '<u2', 256, off).astype(np.int64)
    present = freqs[freqs > 0]
    if freqs.sum() != SCALE or present.size < 2 or present.min() < MIN_FREQ:
        raise ValueError('bad frequency table')
    return freqs, off + 512


def _segments(n_stream, seg, modes, tail_split):
    """(plane, start, count) of every coded segment, in stream order."""
    out = []
    for p, mode in enumerate(modes):
        if mode != RANS:
            continue
        for start in range(0, n_stream, seg):
            n = min(seg, n_stream - start)
            if tail_split > 1 and n < seg:
                q = -(-(-(-n // LANES)) // tail_split) * LANES
                for off in range(0, n, q):
                    out.append((p, start + off, min(q, n - off)))
            else:
                out.append((p, start, n))
    return out


def parse(payload):
    """The fields of one chunk container, as a dict."""
    buf = memoryview(payload)
    (magic, version, itemsize, flags, scale_bits, n_elems, seg_field,
     min_freq, group_rows, tdesc, n_head, tsplit) = HEADER.unpack_from(buf, 0)
    if magic != MAGIC or version != 2 or scale_bits != SCALE_BITS \
            or group_rows != GROUP_ROWS or min_freq != MIN_FREQ:
        raise ValueError('bad container header')
    if flags & F_CRC:
        (want,) = struct.unpack_from('<I', buf, len(buf) - 4)
        if zlib.crc32(buf[:-4]) != want:
            raise ValueError('CRC32 mismatch')
        buf = buf[:-4]
    if not flags & F_HEAD:
        n_head = 0
    off = HEADER.size
    head = np.frombuffer(buf, np.uint8, n_head * itemsize, off)
    off += n_head * itemsize
    n_coded = n_elems - n_head
    if flags & F_ALIGNED:
        tcs = n_coded // n_head
        tp = -(-tcs // LANES) * LANES
        seg, n_stream = seg_field * tp, n_head * tp
    else:
        tcs = tp = 0
        seg, n_stream = 1 << seg_field, n_coded
    n_segs = -(-n_stream // seg)
    planes = []
    for _ in range(itemsize):
        mode = buf[off]
        off += 1
        if mode == CONST:
            planes.append((mode, buf[off]))
            off += 1
        elif mode == RAW:
            planes.append((mode, np.frombuffer(buf, np.uint8, n_coded, off)))
            off += n_coded
        elif mode == RANS:
            n_tables = 1
            if flags & F_MULTITABLE:
                n_tables = buf[off]
                off += 1
            tables = []
            for _ in range(n_tables):
                freqs, off = _table(buf, off)
                tables.append(freqs)
            index = np.zeros(n_segs, np.int64)
            if n_tables > 1:
                index = np.frombuffer(buf, np.uint8, n_segs, off).astype(
                    np.int64)
                off += n_segs
            planes.append((mode, (np.stack(tables), index)))
        else:
            raise ValueError('unknown plane mode %d' % mode)
    modes = [m for m, _ in planes]
    segments = _segments(n_stream, seg, modes,
                         tsplit if flags & F_TAILSPLIT else 1)
    groups = []
    if segments:
        (n_groups,) = struct.unpack_from('<I', buf, off)
        off += 4
        if n_groups != -(-len(segments) // GROUP_ROWS):
            raise ValueError('wrong group count')
        n_words = np.frombuffer(buf, '<u4', n_groups, off)
        off += 4 * n_groups
        for g in range(n_groups):
            segs = segments[g * GROUP_ROWS:(g + 1) * GROUP_ROWS]
            states = np.frombuffer(buf, '<u4', len(segs) * LANES, off)
            off += states.nbytes
            words = np.frombuffer(buf, '<u2', int(n_words[g]), off)
            off += words.nbytes
            groups.append((segs, states.reshape(len(segs), LANES), words))
    if off != len(buf):
        raise ValueError('trailing bytes')
    transform = None
    if flags & F_TRANSFORM:
        transform = (tdesc & 3, bool(tdesc & 4))
    return dict(itemsize=itemsize, n_elems=n_elems, n_head=n_head, head=head,
                zigzag=bool(flags & F_ZIGZAG), aligned=bool(flags & F_ALIGNED),
                seg=seg, tp=tp, tcs=tcs, n_stream=n_stream, planes=planes,
                groups=groups, transform=transform)


def finish_chunk(c, coded, n_samples, n_channels, dtype, order='F',
                 do_time_diff=True, do_spatial_diff=False, time_order=1):
    """One chunk's samples, ``(n_samples, n_channels)`` of ``dtype``, from
    its parsed container ``c`` and its decoded rANS planes ``coded``."""
    dtype = np.dtype(dtype)
    if c['n_elems'] != n_samples * n_channels or c['itemsize'] != \
            dtype.itemsize:
        raise ValueError('chunk geometry')
    planes = np.empty((c['n_elems'] - c['n_head'], c['itemsize']), np.uint8)
    for p, (mode, value) in enumerate(c['planes']):
        if mode != RANS:
            planes[:, p] = value
        elif c['aligned']:
            planes[:, p] = coded[p].reshape(
                c['n_head'], c['tp'])[:, :c['tcs']].reshape(-1)
        else:
            planes[:, p] = coded[p]
    # The elements' bits, unsigned: zigzag undone, then the inverse
    # transform as modular sums in that width (exact for any integer).
    width = 'u%d' % c['itemsize']
    u = planes.view('<' + width).reshape(-1).astype(width)
    if c['zigzag']:
        u = (u >> 1) ^ (0 - (u & 1))
    out = np.empty((n_samples, n_channels), width)
    if c['n_head']:
        out[0] = c['head'].view('<' + width)
        out[1:] = u.reshape((n_samples - 1, n_channels), order=order)
    else:
        out[:] = u.reshape((n_samples, n_channels), order=order)
    time_n, spatial = (time_order if do_time_diff else 0), do_spatial_diff
    if c['transform'] is not None:
        time_n, spatial = c['transform']
    if spatial:
        np.cumsum(out, axis=1, dtype=out.dtype, out=out)
    for _ in range(time_n):
        np.cumsum(out, axis=0, dtype=out.dtype, out=out)
    return out.view(dtype)


def entropy_decode(chunks):
    """``[{plane: decoded symbol stream}]`` of the rANS planes of the
    parsed containers ``chunks``, the groups of all of them stepped
    together."""
    outs = [{p: np.zeros(c['n_stream'], np.uint8)
             for p, (mode, _) in enumerate(c['planes']) if mode == RANS}
            for c in chunks]
    # Every row (segment) of every group, group-major: its lanes are
    # row-major within the group, the order in which they read words.
    rows = [(k, g, seg) for k, c in enumerate(chunks)
            for g, (segs, _, _) in enumerate(c['groups']) for seg in segs]
    if not rows:
        return outs
    groups = [grp for c in chunks for grp in c['groups']]
    n_rows = len(rows)
    freq = np.empty((n_rows, 256), np.int64)
    count = np.empty(n_rows, np.int64)
    for i, (k, _g, (p, start, n)) in enumerate(rows):
        tables, index = chunks[k]['planes'][p][1]
        freq[i] = tables[index[start // chunks[k]['seg']]]
        count[i] = n
    cum = np.zeros_like(freq)
    np.cumsum(freq[:, :-1], axis=1, out=cum[:, 1:])
    lut = np.stack([np.repeat(np.arange(256, dtype=np.uint8), f)
                    for f in freq]).reshape(-1)
    freq, cum = freq.reshape(-1).astype(np.uint32), cum.reshape(-1).astype(
        np.uint32)
    x = np.concatenate([st.reshape(-1) for _, st, _ in groups]).astype(
        np.uint32)
    lane_row = np.arange(n_rows, dtype=np.int64).repeat(LANES)
    lane_j = np.tile(np.arange(LANES, dtype=np.int64), n_rows)
    lane_n = count.repeat(LANES)
    lane_group = np.concatenate([np.full(st.size, g, np.int64)
                                 for g, (_, st, _) in enumerate(groups)])
    n_words = np.array([w.size for _, _, w in groups], np.int64)
    words = np.concatenate([w for _, _, w in groups]).astype(np.uint32)
    word_base = np.cumsum(n_words) - n_words
    pos = np.zeros(len(groups), np.int64)
    steps = -(-int(count.max()) // LANES)
    sym = np.empty((steps, x.size), np.uint8)
    for s in range(steps):
        active = s * LANES + lane_j < lane_n
        slot = x & (SCALE - 1)
        k = lut[lane_row * SCALE + slot]
        sym[s] = k
        at = lane_row * 256 + k
        x = np.where(active, freq[at] * (x >> SCALE_BITS) + slot - cum[at], x)
        lanes = np.flatnonzero(active & (x < RANS_L))
        if lanes.size:
            grp = lane_group[lanes]
            per = np.bincount(grp, minlength=len(groups))
            rank = np.arange(lanes.size) - (np.cumsum(per) - per)[grp]
            if np.any(pos[grp] + rank >= n_words[grp]):
                raise ValueError('rANS word stream exhausted')
            x[lanes] = (x[lanes] << 16) | words[word_base[grp] + pos[grp]
                                                + rank]
            pos += per
    if np.any(pos != n_words):
        raise ValueError('a group left words unread')
    # Lane j of step s holds symbol s * 128 + j of its row.
    sym = sym.reshape(steps, n_rows, LANES).transpose(1, 0, 2).reshape(
        n_rows, steps * LANES)
    for i, (k, _g, (p, start, n)) in enumerate(rows):
        outs[k][p][start:start + n] = sym[i, :n]
    return outs


def decode_file(cbin, ch, chunks=None, batch=8):
    """Decoded samples of chunks ``chunks`` (all by default) of a file,
    as ``{chunk index: (n, C) array}``; ``batch`` chunks' rANS groups
    decode together."""
    meta = read_sidecar(ch)
    if meta['algorithm'] != 'ans':
        raise ValueError('not a v2 (ans) file')
    user = np.dtype(meta['dtype'])
    code = np.dtype('int%d' % (8 * user.itemsize)) \
        if meta.get('float_bitcast') else user
    bounds, offsets = meta['chunk_bounds'], meta['chunk_offsets']
    chunks = list(range(len(bounds) - 1) if chunks is None else chunks)
    out = {}
    with open(cbin, 'rb') as f:
        for b0 in range(0, len(chunks), batch):
            ids = chunks[b0:b0 + batch]
            parsed = []
            for i in ids:
                f.seek(offsets[i])
                parsed.append(parse(f.read(offsets[i + 1] - offsets[i])))
            for i, c, coded in zip(ids, parsed, entropy_decode(parsed)):
                out[i] = finish_chunk(
                    c, coded, bounds[i + 1] - bounds[i], meta['n_channels'],
                    code, order=meta.get('chunk_order', 'F'),
                    do_time_diff=meta['do_time_diff'],
                    do_spatial_diff=bool(meta['do_spatial_diff']),
                    time_order=int(meta.get('time_diff_order') or 1)
                ).view(user)
    return out
