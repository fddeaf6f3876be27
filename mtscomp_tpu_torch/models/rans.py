"""Lane-interleaved rANS: the entropy-coding core of format v2.

Design
------
The reference's entropy stage is a sequential zlib stream per chunk
(mtscomp.py:394, 619), which cannot be parallelized *within* a chunk.
Format v2 replaces it with a layout designed around the TPU vector unit:

- A chunk's byte planes are cut into **segments** of contiguous symbols;
  each segment is coded by **128 interleaved rANS lanes** (lane ``j``
  takes symbols ``j, j+128, ...``) — one segment maps onto one 128-lane
  vector register row.
- Segments are packed into **groups of R <= 32 rows** (one (32, 128)
  vector — TPU vector ops cost roughly the same at 8 and 32 sublanes,
  so wide groups quarter the per-symbol cost). A group shares a single
  renormalization word stream, merged in **decoder order**: at each
  step, the lanes whose state underflows read one 16-bit word each, in
  row-major lane order. The vectorized decoder therefore consumes the
  stream strictly front-to-back — no per-lane cursors, just a masked
  rank within the step.
- Each row carries its own frequency table (so one group can mix byte
  planes with different statistics).

Coder parameters (fixed for the format):

- 32-bit states, 16-bit renorm words, state invariant ``[2^16, 2^32)``;
- ``SCALE_BITS = 12`` (frequencies sum to 4096), 256-symbol alphabet;
- **minimum frequency 8** for present symbols: every 16-slot bucket of
  the 4096-slot table then contains at most 3 symbols, so the decoder's
  slot->symbol lookup is one 256-entry coarse lookup plus at most two
  compare-increments over a dense alphabet — the shape TPU shuffles
  want (no binary search). This encoder quantizes frequencies to
  multiples of 8 (see :func:`quantize_freqs`), tightening the bound to
  two symbols per bucket so the device decoder needs ONE fixup for
  tables it wrote itself;
- per (step, lane) visit at most ONE word is emitted/read, making the
  decode step a single masked vector operation.

The encoder walks symbols backward (steps descending), emitting at most
one word per visit *before* each state update; the decoder walks forward
reading at most one word per visit *after* each update. The word
sequences mirror exactly (verified exhaustively in tests).

This file is the host (NumPy) implementation and the normative spec; the
device implementations (the CUDA kernels behind ops/rans_decode.py and
ops/rans_encode.py, and their plain PyTorch twins) must match it
bit-for-bit.
"""

import numpy as np

SCALE_BITS = 12
SCALE = 1 << SCALE_BITS          # 4096
RANS_L = 1 << 16                 # state lower bound
WORD_BITS = 16
MIN_FREQ = 8                     # present symbols get >= 8/4096
MAX_FREQ = SCALE - MIN_FREQ      # >= 2 present symbols when RANS is used
LANES = 128                      # lanes per segment (one vector row)
GROUP_ROWS = 32                  # segments per group (one (32,128) vector)


def zigzag_encode(values):
    """Map signed integers to small unsigned codes: 0,-1,1,-2,... -> 0,1,2,3,...

    Input may be any integer dtype; it is reinterpreted as the signed type
    of the same width first (wrapped diffs of unsigned data are "small"
    in the signed sense). Returns the NATIVE-order unsigned dtype of the
    same width (big-endian inputs are value-normalized first — the
    raw-byte reinterpretation the views below perform would otherwise
    collide distinct values).
    """
    v = np.asarray(values)
    if v.dtype.byteorder == '>':
        v = v.astype(v.dtype.newbyteorder('='))
    bits = v.dtype.itemsize * 8
    s = v.view(np.dtype('int%d' % bits)) if v.dtype.kind == 'u' else v
    u = s.view(np.dtype('uint%d' % bits))
    # (s << 1) ^ (s >> (bits - 1)) in modular arithmetic: the arithmetic
    # right shift broadcasts the sign across all bits.
    return (u * np.array(2, u.dtype)) ^ (s >> (bits - 1)).view(u.dtype)


def zigzag_decode(codes, dtype):
    """Inverse of :func:`zigzag_encode`; ``dtype`` is the original dtype."""
    u = np.asarray(codes)
    assert u.dtype.kind == 'u'
    s = (u >> 1).astype(u.dtype)
    out = (s ^ (-(u & 1)).astype(u.dtype)).view(
        np.dtype('int%d' % (u.dtype.itemsize * 8)))
    dtype = np.dtype(dtype)
    if dtype.byteorder == '>':
        # Values (not bytes) round-trip for non-native input dtypes.
        return out.view(dtype.newbyteorder('=')).astype(dtype)
    return out.view(dtype)


def quantize_freqs(counts, scale_bits=SCALE_BITS, min_freq=MIN_FREQ):
    """Quantize symbol counts to frequencies summing to ``2**scale_bits``.

    Every present symbol gets frequency >= ``min_freq``; absent symbols
    get 0. Returns ``None`` when fewer than two symbols are present
    (use a constant plane).

    Frequencies are quantized at **min_freq granularity** (largest-
    remainder apportionment of ``scale // min_freq`` units, then
    one-unit steals from the largest buckets when the minimum bumps
    overshoot). Every cumulative boundary of the emitted table is then
    a multiple of ``min_freq``, so with the format's ``min_freq = 8``
    no 16-slot bucket of the 4096-slot table can intersect more than
    TWO symbols — the device decoder's single-fixup slot lookup
    applies to every table this encoder writes. (Decoders still accept
    arbitrary min-8 tables, where a bucket may hold three symbols —
    files from other writers use the two-fixup variant.) Measured on
    Neuropixels-like data the unit granularity also compresses
    slightly *better* than per-slot apportionment: spreading the
    rebalancing cuts one unit at a time stops the single most frequent
    symbol from absorbing the whole min-frequency overshoot.
    """
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    assert total > 0
    present = counts > 0
    n_present = int(present.sum())
    if n_present <= 1:
        return None
    scale = 1 << scale_bits
    assert scale % min_freq == 0
    assert n_present * min_freq <= scale
    q = scale // min_freq                       # units of min_freq slots
    ideal = counts * q / total
    freqs = np.floor(ideal).astype(np.int64)
    freqs[present] = np.maximum(freqs[present], 1)
    remainder = int(q - freqs.sum())
    if remainder > 0:
        frac = np.where(present, ideal - np.floor(ideal), -1.0)
        order = np.argsort(-frac, kind='stable')
        take = order[:remainder]
        freqs[take] += 1
    while freqs.sum() > q:
        # Steal single units from the currently largest bucket; the cut
        # rotates across the large symbols instead of gutting one.
        k = int(np.argmax(freqs))
        assert freqs[k] > 1, "cannot rebalance frequency table"
        freqs[k] -= 1
    freqs *= min_freq
    assert freqs.sum() == scale
    assert np.all(freqs[present] >= min_freq)
    assert np.all(freqs[~present] == 0)
    return freqs.astype(np.uint16)


def quantize_freqs_batch(counts_rows, scale_bits=SCALE_BITS,
                         min_freq=MIN_FREQ):
    """Row-vectorized :func:`quantize_freqs`: (K, 256) -> (K, 256).

    Bit-identical to calling the scalar version per row (same stable
    largest-remainder ordering, same one-unit steal tie-breaking);
    exists because the segment-table clustering quantizes many
    candidate tables per Lloyd iteration. Every row must have >= 2
    present symbols (callers pre-handle constant rows).
    """
    counts = np.asarray(counts_rows, dtype=np.int64)
    K = counts.shape[0]
    totals = counts.sum(axis=1, keepdims=True)
    assert np.all(totals > 0)
    present = counts > 0
    n_present = present.sum(axis=1)
    assert np.all(n_present >= 2)
    scale = 1 << scale_bits
    assert scale % min_freq == 0
    q = scale // min_freq
    assert np.all(n_present * min_freq <= scale)
    ideal = counts * q / totals
    freqs = np.floor(ideal).astype(np.int64)
    freqs = np.where(present, np.maximum(freqs, 1), 0)
    remainder = q - freqs.sum(axis=1)
    frac = np.where(present, ideal - np.floor(ideal), -1.0)
    order = np.argsort(-frac, axis=1, kind='stable')
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(256),
                                                   (K, 256)), axis=1)
    freqs += (rank < np.maximum(remainder, 0)[:, None])
    over = freqs.sum(axis=1) - q
    if np.any(over > 0):
        # Closed form of the scalar one-unit steal loop ("decrement the
        # first current maximum, repeat ``over`` times"): the loop
        # levels values down sweep by sweep — cap every value at level
        # L, where L is the lowest level whose capping cost does not
        # exceed ``over``, then spend the remaining decrements at level
        # L in index order (exactly the order repeated first-argmax
        # visits elements within one level). Bit-identical to the loop,
        # O(K * 256 log 256) instead of O(K * over).
        D = np.maximum(over, 0)
        desc = np.sort(freqs, axis=1)[:, ::-1].astype(np.int64)
        csum = np.cumsum(desc, axis=1)
        j = np.arange(1, 257)
        # cost(L) = sum(max(f - L, 0)), i.e. the decrements capping all
        # values at level L costs; at the candidate levels L = desc[m]:
        # cost = csum[m] - (m+1) * desc[m] (ties contribute zero).
        cost_at = csum - j[None, :] * desc
        # The sweep stops inside the piece (desc[m], desc[m-1]] for the
        # FIRST m with cost(desc[m]) >= D; there the slope is exactly m
        # (first-index argmax ⇒ desc[m-1] > desc[m] at that m).
        ge = cost_at >= D[:, None]
        m = np.argmax(ge, axis=1)
        rows_i = np.arange(K)
        hit = ge[rows_i, m] & (D > 0)
        n_above = np.maximum(m, 1)
        lift = (cost_at[rows_i, m] - D + n_above - 1) // n_above
        L = desc[rows_i, m] + np.maximum(lift, 0)
        capped = np.minimum(freqs, L[:, None])
        r = D - (freqs - capped).sum(axis=1)
        # Remaining r decrements hit the first r elements (index order)
        # whose value reached L — the order repeated first-argmax
        # visits elements within one level.
        at_L = capped == L[:, None]
        seen = np.cumsum(at_L, axis=1)
        capped -= at_L & (seen <= r[:, None])
        ok = hit & (r >= 0) & (r <= at_L.sum(axis=1)) \
            & (capped >= present).all(axis=1)
        freqs = np.where(ok[:, None], capped, freqs)
        # Rows the closed form could not place (leveling below the
        # global minimum — pathological tables) fall back to the
        # reference loop; bit-identity either way.
        for i in np.nonzero((D > 0) & ~ok)[0]:  # pragma: no cover
            while freqs[i].sum() > q:
                k = int(np.argmax(freqs[i]))
                assert freqs[i, k] > 1, "cannot rebalance table"
                freqs[i, k] -= 1
    freqs *= min_freq
    assert np.all(freqs.sum(axis=1) == scale)
    return freqs.astype(np.uint16)


def cumulative_freqs(freqs):
    """Exclusive prefix sum along the last axis (uint32)."""
    freqs = np.asarray(freqs)
    cum = np.zeros(freqs.shape, dtype=np.uint32)
    np.cumsum(freqs[..., :-1], axis=-1, out=cum[..., 1:])
    return cum


def encoder_tables(freqs):
    """Division-free per-symbol encoder tables (reciprocal scheme).

    The encoder update needs ``x // f`` and ``x % f`` with a per-lane
    divisor — TPUs lower vector integer division very poorly, so the
    device encoder divides via the Granlund-Montgomery round-up
    reciprocal (the unknown-divisor scheme compilers/libdivide use),
    exact for ALL 32-bit x::

        m   = ceil(2**(32+shift) / f), shift = ceil(log2(f))  # 33 bits
        rcp = m - 2**32                                        # low 32
        t   = mulhi32(x, rcp)
        q   = (((x - t) >> 1) + t) >> (shift - 1)   == x // f

    and the update becomes ``x + cum + q * (SCALE - f)`` (no modulo:
    ``x - q*f + q*SCALE + cum``).

    freqs: (..., 256) quantized tables (uint16/ints). Returns
    ``(pk, rcp)`` uint32 arrays of the same shape with
    ``pk = (rcp_shift << 25) | (cmpl << 12) | cum``, ``cmpl = SCALE -
    f`` (13 bits), ``rcp_shift = shift - 1``. Entries for ``f < 2``
    are placeholders (the format's MIN_FREQ is 8; absent symbols are
    never encoded by active lanes).
    """
    f = np.asarray(freqs, dtype=np.int64)
    assert f.shape[-1] == 256
    cum = cumulative_freqs(f).astype(np.int64)
    cmpl = SCALE - f
    shift = np.zeros_like(f)
    rcp = np.zeros_like(f, dtype=np.uint64)
    ge2 = f >= 2
    # ceil(log2(f)): exact for f <= 4096 (log2 of powers of two is
    # exact; non-powers cannot round across an integer).
    shift[ge2] = np.ceil(np.log2(f[ge2])).astype(np.int64)
    num = np.uint64(1) << (shift[ge2] + 32).astype(np.uint64)
    fu = f[ge2].astype(np.uint64)
    m = (num + fu - np.uint64(1)) // fu          # 33 bits, >= 2^32
    assert np.all(m >= (1 << 32)) and np.all(m < (1 << 33))
    rcp[ge2] = m - np.uint64(1 << 32)
    rcp_shift = np.maximum(shift - 1, 0)
    pk = (rcp_shift << 25) | (cmpl << 12) | cum
    return pk.astype(np.uint32), rcp.astype(np.uint32)


def group_steps(row_counts):
    """Scan length for a group: max over rows of ceil(count / LANES)."""
    return int(max((-(-int(c) // LANES) for c in row_counts), default=0))


def rans_encode_group(rows, freqs_rows):
    """Encode R segment rows (R <= GROUP_ROWS) into one merged-stream group.

    rows : list of uint8 arrays (the segments' symbols, row r has n_r).
    freqs_rows : (R, 256) per-row frequency tables.

    Returns ``(states, words)``: (R, 128) uint32 decoder start states and
    the merged uint16 renorm payload in decoder read order.
    """
    R = len(rows)
    assert 1 <= R <= GROUP_ROWS
    counts = [len(r) for r in rows]
    S = group_steps(counts)

    freqs_rows = np.asarray(freqs_rows, dtype=np.uint64)
    assert freqs_rows.shape == (R, 256)
    cum_rows = cumulative_freqs(freqs_rows).astype(np.uint64)

    # Pad rows to S*LANES symbols (padding never touched thanks to masks).
    syms = np.zeros((R, S * LANES), dtype=np.int64)
    for r, row in enumerate(rows):
        syms[r, :counts[r]] = row
    n = np.asarray(counts, dtype=np.int64)[:, None]

    x = np.full((R, LANES), RANS_L, dtype=np.uint64)
    lane_j = np.arange(LANES, dtype=np.int64)[None, :]
    words_per_step = [None] * S
    for s in range(S - 1, -1, -1):
        active = (s * LANES + lane_j) < n                    # (R, 128)
        sy = syms[:, s * LANES:(s + 1) * LANES]
        f = np.take_along_axis(freqs_rows, sy, axis=1)
        f = np.where(active, f, np.uint64(1))
        c = np.take_along_axis(cum_rows, sy, axis=1)
        emit = active & (x >= (f << np.uint64(20)))
        if emit.any():
            # Row-major flatten == decoder lane order (r*128 + j).
            words_per_step[s] = (x[emit] & np.uint64(0xFFFF)).astype(np.uint16)
            x[emit] >>= np.uint64(16)
        else:
            words_per_step[s] = _EMPTY_U16
        upd = (x // f) * np.uint64(SCALE) + (x % f) + c
        x = np.where(active, upd, x)

    words = np.concatenate(words_per_step) if S else _EMPTY_U16
    return x.astype(np.uint32), words


_EMPTY_U16 = np.zeros(0, dtype=np.uint16)


def rans_decode_group(states, words, freqs_rows, row_counts):
    """Decode one group; the normative mirror of :func:`rans_encode_group`.

    Returns ``(rows, words_used)`` with ``rows`` a list of uint8 arrays.
    """
    states = np.asarray(states, dtype=np.uint64)
    R = states.shape[0]
    assert states.shape == (R, LANES)
    freqs_rows = np.asarray(freqs_rows, dtype=np.uint64)
    cum_rows = cumulative_freqs(freqs_rows).astype(np.uint64)
    S = group_steps(row_counts)
    n = np.asarray(row_counts, dtype=np.int64)[:, None]
    lane_j = np.arange(LANES, dtype=np.int64)[None, :]
    words = np.asarray(words, dtype=np.uint16)

    x = states.copy()
    out = np.empty((R, S * LANES), dtype=np.uint8)
    # Inclusive per-row cumsums for the slot lookup, hoisted out of the
    # step loop (bit-exact; the loop only reads them).
    inc_rows = np.cumsum(freqs_rows, axis=1)
    pos = 0
    for s in range(S):
        active = (s * LANES + lane_j) < n
        slot = (x & np.uint64(SCALE - 1)).astype(np.int64)
        # slot -> symbol via searchsorted per row (normative; device code
        # uses the coarse-table + single-fixup equivalent).
        sym = np.empty((R, LANES), dtype=np.int64)
        for r in range(R):
            sym[r] = np.searchsorted(inc_rows[r], slot[r], side='right')
        out[:, s * LANES:(s + 1) * LANES] = sym
        f = np.take_along_axis(freqs_rows, sym, axis=1)
        c = np.take_along_axis(cum_rows, sym, axis=1)
        upd = f * (x >> np.uint64(SCALE_BITS)) + slot.astype(np.uint64) - c
        x = np.where(active, upd, x)
        need = active & (x < np.uint64(RANS_L))
        cnt = int(need.sum())
        if cnt:
            if pos + cnt > words.size:
                raise IOError("rANS word stream exhausted mid-decode "
                              "(corrupt or truncated payload).")
            w = words[pos:pos + cnt].astype(np.uint64)
            x[need] = (x[need] << np.uint64(16)) | w    # row-major order
            pos += cnt
    rows = [out[r, :row_counts[r]] for r in range(R)]
    return rows, pos
