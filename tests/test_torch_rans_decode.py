"""PyTorch port, K1: the grouped rANS decode and its tables.

The port's plain twin of the decode kernel (what ``decode_groups`` runs
for CPU tensors) is held, bit for bit, against the JAX package's Pallas
kernel in interpret mode and against the normative coder, on groups
packed from real containers. The re-housed table packer is held against
the JAX package's for every table those containers carry, and the
table builder's twin (``decode_tables_ref``, what ``decode_tables`` runs
for CPU tensors) against the packer, row by row.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from mtscomp_tpu import compress, decompress  # noqa: E402
from mtscomp_tpu.codec.ans import seg_freqs  # noqa: E402
from mtscomp_tpu.models import rans  # noqa: E402
from mtscomp_tpu.ops import pallas_rans  # noqa: E402
from mtscomp_tpu.parallel.pipeline import (  # noqa: E402
    DeviceBatchDecoder as JaxDecoder, _read_payload)

import mtscomp_tpu_torch as mt  # noqa: E402
from mtscomp_tpu_torch.codec.ans import MODE_RANS as PORT_MODE_RANS  # noqa
from mtscomp_tpu_torch.models import rans as port_rans  # noqa: E402
from mtscomp_tpu_torch.ops import tables  # noqa: E402
from mtscomp_tpu_torch.ops.rans_decode import (  # noqa: E402
    decode_groups, decode_groups_coarse, decode_groups_ref, decode_tables,
    decode_tables_ref)
from mtscomp_tpu_torch.parallel.pipeline import (  # noqa: E402
    DeviceBatchDecoder, _read_payload as port_read_payload,
    args_from_jax_pack, freq_stack)

from chip_smoke import (  # noqa: E402
    EDGE_CASES, REGION_ENDS, edge_groups, edge_k1_inputs)
from conftest import write_arr  # noqa: E402

# name: (channels, samples per chunk, chunks, dtype, compress kwargs).
# 'ragged129' is the 385-channel layout scaled down (4-channel
# segments, a 1-channel tail split into 8 sub-rows); 'wide40' packs all
# 40 channels into one segment row.
GEOMETRIES = {
    'ragged129': (129, 1000, 2, 'int16', {'ans_seg_log2': 12}),
    'uniform128': (128, 1000, 2, 'int16', {'ans_seg_log2': 12}),
    'wide40': (40, 300, 3, 'uint16', {}),
}


def _staged(tmp_path, name, monkeypatch):
    """Compress one geometry; return (reader, parsed chunks, T)."""
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    C, T, n, dtype, kw = GEOMETRIES[name]
    rng = np.random.default_rng(11)
    arr = np.cumsum(rng.normal(0, 5, size=(n * T, C)), axis=0).astype(dtype)
    path = write_arr(tmp_path / 'k1.bin', arr)
    compress(path, tmp_path / 'k1.cbin', tmp_path / 'k1.ch',
             sample_rate=float(T), n_channels=C, dtype=dtype,
             algorithm='ans', quiet=True, check_after_compress=False,
             device='none', **kw)
    r = decompress(tmp_path / 'k1.cbin', tmp_path / 'k1.ch', quiet=True)
    parsed = [r.codec.parse(_read_payload(r, i)) for i in range(r.n_chunks)]
    return r, parsed, T


def _live(counts, n_steps):
    """(N, 32, n_steps*128) mask of the columns below each row's count."""
    col = torch.arange(n_steps * rans.LANES)
    return col[None, None, :] < counts[:, :, None].long()


@pytest.mark.parametrize('name', sorted(GEOMETRIES))
def test_decode_groups_twin_matches_pallas(tmp_path_, monkeypatch, name):
    r, parsed, T = _staged(tmp_path_, name, monkeypatch)
    try:
        fn, args = DeviceBatchDecoder(r, 'cpu').pack(parsed, T)
        S = fn.keywords['S']
        syms, used = decode_groups(*args[:5], S)
        _, jargs = JaxDecoder(r).pack(parsed, T)
        states, words, _f, _c, coarse_pk, dense_pk, counts_b = jargs[:7]
        jsyms, jused = pallas_rans.decode_groups_pallas(
            states, words, coarse_pk, dense_pk, counts_b, n_steps=S,
            interpret=True, octet=True, one_fixup=True)
        # The Pallas output rounds the columns up to whole grid blocks.
        jsyms = torch.from_numpy(np.array(jsyms)[:, :, :S * rans.LANES])
        assert syms.shape == jsyms.shape and syms.dtype == torch.uint8
        live = _live(args[4], S)
        assert torch.equal(syms[live], jsyms[live])
        assert np.array_equal(used.numpy(), np.asarray(jused))
        # Every group consumed exactly its stored stream.
        assert sorted(used.tolist()) == sorted(
            g['words'].size for p in parsed for g in p['groups'])
    finally:
        r.close()


@pytest.mark.parametrize('name', sorted(GEOMETRIES))
def test_decode_groups_twin_matches_normative(tmp_path_, monkeypatch,
                                              name):
    r, parsed, T = _staged(tmp_path_, name, monkeypatch)
    try:
        dec = DeviceBatchDecoder(r, 'cpu')
        fn, args = dec.pack(parsed, T)
        syms, used = decode_groups(*args[:5], fn.keywords['S'])
        B, G = len(parsed), len(parsed[0]['groups'])
        for b, p in enumerate(parsed):
            for gi, g in enumerate(p['groups']):
                # The packer's slot layout: chunk-major, or with a ragged
                # tail [full groups chunk-major | tail groups].
                if dec.last_tail is None:
                    i = b * G + gi
                elif gi == G - 1:
                    i = B * (G - 1) + b
                else:
                    i = b * (G - 1) + gi
                freqs = np.stack([seg_freqs(p, pl, st)
                                  for pl, st, _n in g['segments']])
                counts = [n for _pl, _st, n in g['segments']]
                rows, n_used = rans.rans_decode_group(
                    g['states'], g['words'], freqs, counts)
                assert used[i] == n_used == g['words'].size
                for ri, row in enumerate(rows):
                    assert np.array_equal(syms[i, ri, :row.size].numpy(),
                                          row)
    finally:
        r.close()


def test_decode_groups_twin_random_groups():
    """Groups encoded by the normative coder from random symbol rows
    (ragged counts, skewed and flat alphabets) decode exactly."""
    rng = np.random.default_rng(3)
    N, S = 3, 6
    states = np.full((N, 32, 128), rans.RANS_L, np.uint32)
    words = np.zeros((N, 4096), np.uint16)
    octet = np.zeros((N, 32, 128), np.int32)
    dense = np.zeros((N, 32, 256), np.int32)
    counts = np.zeros((N, 32), np.int32)
    want = []
    for n in range(N):
        R = int(rng.integers(1, 33))
        rows, freq_rows = [], []
        for ri in range(R):
            c = int(rng.integers(1, S * 128 + 1))
            p = rng.dirichlet(np.full(256, float(rng.choice([0.05, 1.0]))))
            row = rng.choice(256, size=c, p=p).astype(np.uint8)
            hist = np.bincount(row, minlength=256)
            hist[(int(row[0]) + 1) % 256] += 1   # >= 2 symbols present
            f = rans.quantize_freqs(hist)
            rows.append(row)
            freq_rows.append(f)
            _c, d, _n2, o = tables.pack_device_tables(f)
            octet[n, ri], dense[n, ri] = o, d.reshape(-1)
            counts[n, ri] = c
        st, w = rans.rans_encode_group(rows, np.stack(freq_rows))
        states[n, :R] = st
        words[n, :w.size] = w
        want.append((rows, w.size))
    syms, used = decode_groups_ref(
        torch.from_numpy(states.view(np.int32)),
        torch.from_numpy(words.view(np.int16)), torch.from_numpy(octet),
        torch.from_numpy(dense), torch.from_numpy(counts), S)
    for n, (rows, n_words) in enumerate(want):
        assert used[n] == n_words
        for ri, row in enumerate(rows):
            assert np.array_equal(syms[n, ri, :row.size].numpy(), row)


@pytest.mark.parametrize('name', sorted(GEOMETRIES))
def test_pack_device_tables_match_jax(tmp_path_, monkeypatch, name):
    r, parsed, _T = _staged(tmp_path_, name, monkeypatch)
    r.close()
    seen = 0
    for p in parsed:
        for g in p['groups']:
            for pl, st, _n in g['segments']:
                f = seg_freqs(p, pl, st)
                mine = tables.pack_device_tables(f)
                ref = pallas_rans.pack_device_tables(f)
                for a, b in zip(mine[:2], ref[:2]):
                    assert a.dtype == b.dtype == np.int32
                    assert np.array_equal(a, b)
                assert mine[2] == ref[2]
                assert mine[3] is not None
                assert mine[3].dtype == ref[3].dtype
                assert np.array_equal(mine[3], ref[3])
                seen += 1
    assert seen > 0


@pytest.mark.parametrize('seed', range(4))
def test_pack_device_tables_foreign_tables(seed):
    """Tables with boundaries off the 8-slot grid (other writers) pack
    identically too, including the missing octet table."""
    rng = np.random.default_rng(seed)
    f = np.zeros(256, np.int64)
    sym = rng.choice(256, size=int(rng.integers(2, 200)), replace=False)
    f[sym] = 1
    f[sym] += rng.multinomial(4096 - sym.size, np.full(sym.size,
                                                       1.0 / sym.size))
    mine = tables.pack_device_tables(f)
    ref = pallas_rans.pack_device_tables(f)
    assert np.array_equal(mine[0], ref[0])
    assert np.array_equal(mine[1], ref[1])
    assert mine[2] == ref[2]
    assert (mine[3] is None) == (ref[3] is None)
    if ref[3] is not None:
        assert np.array_equal(mine[3], ref[3])


def test_decode_groups_rejects_bad_inputs():
    N = 1
    good = dict(states=torch.zeros((N, 32, 128), dtype=torch.int32),
                words=torch.zeros((N, 128), dtype=torch.int16),
                octet_pk=torch.zeros((N, 32, 128), dtype=torch.int32),
                dense_pk=torch.zeros((N, 32, 256), dtype=torch.int32),
                counts=torch.zeros((N, 32), dtype=torch.int32))
    syms, used = decode_groups(**good, n_steps=1)
    assert syms.shape == (N, 32, 128) and used.tolist() == [0]
    for key, bad in [('states', good['states'].to(torch.int64)),
                     ('words', good['words'].to(torch.int32)),
                     ('dense_pk', good['dense_pk'][:, :, :128]),
                     ('counts', good['counts'][:, :16])]:
        with pytest.raises(ValueError, match=key):
            decode_groups(**dict(good, **{key: bad}), n_steps=1)


def test_args_from_jax_pack_dtypes(tmp_path_, monkeypatch):
    """The JAX staged batch maps onto the port's tensors with the
    unsigned words and states carried as same-bit signed views."""
    r, parsed, T = _staged(tmp_path_, 'ragged129', monkeypatch)
    try:
        _, jargs = JaxDecoder(r).pack(parsed, T)
        args = args_from_jax_pack(jargs, 'cpu')
        assert [a.dtype for a in args] == [
            torch.int32, torch.int16, torch.int32, torch.int32,
            torch.int32, torch.uint8, torch.uint8, torch.int16]
        assert np.array_equal(args[0].numpy().view(np.uint32),
                              np.asarray(jargs[0]))
        assert np.array_equal(
            args[1].numpy().view(np.uint16),
            np.asarray(jargs[1]).reshape(args[1].shape))
        # rows= keeps each group's first rows of 128 words: the port's
        # pack stages exactly those, the same bits.
        rows = -(-max(g['words'].size for p in parsed for g in p['groups'])
                 // 128)
        trimmed = args_from_jax_pack(jargs, 'cpu', rows=rows)
        assert trimmed[1].shape == (args[1].shape[0], rows * 128)
        assert torch.equal(trimmed[1], args[1][:, :rows * 128])
        assert not args[1][:, rows * 128:].any()
        for a, b in zip(trimmed[2:], args[2:]):
            assert torch.equal(a, b)
        staged = DeviceBatchDecoder(r, 'cpu').pack(parsed, T)[1]
        assert all(torch.equal(a, b) for a, b in zip(staged, trimmed))
    finally:
        r.close()


@functools.lru_cache(maxsize=None)
def _edge_streams(case):
    """An edge case's groups, encoded by the normative coder, and each
    group's rows as the normative decoder returns them."""
    rows, freqs, counts, steps = edge_groups(case)
    streams = [rans.rans_encode_group(g, freqs[n]) for n, g in
               enumerate(rows)]
    decoded = []
    for n, (st, w) in enumerate(streams):
        got, n_used = rans.rans_decode_group(st, w, freqs[n], counts[n])
        assert n_used == w.size
        assert all(np.array_equal(a, b) for a, b in zip(got, rows[n]))
        decoded.append(got)
    return rows, freqs, counts, steps, streams, decoded


@pytest.mark.parametrize('form', ['octet', 'coarse_1fixup', 'coarse_2fixups'])
@pytest.mark.parametrize('region_end', REGION_ENDS)
@pytest.mark.parametrize('case', sorted(EDGE_CASES))
def test_decode_twins_edge_cases(case, region_end, form):
    """The twins K1 is held to on the card, on the inputs its design
    makes risky: steps that read close to 4096 words, 1 step and the
    encoder's window counts around 16, rows of count 0 and ragged
    counts, a region ending at the stream's last word or off the 8-word
    grid; each against the normative decoder."""
    rows, freqs, counts, steps, streams, decoded = _edge_streams(case)
    states, words, octet, coarse, dense, counts_t = edge_k1_inputs(
        rows, freqs, counts, streams, region_end)
    if form == 'octet':
        syms, used = decode_groups(states, words, octet, dense, counts_t,
                                   steps)
    else:
        syms, used = decode_groups_coarse(states, words, coarse, dense,
                                          counts_t, steps,
                                          one_fixup=form == 'coarse_1fixup')
    assert used.tolist() == [w.size for _st, w in streams]
    if region_end == 'exact':
        # (A one-step group emits no word: its region is one word.)
        assert max(used.tolist()) == words.shape[1] or not used.any()
    else:
        assert words.shape[1] % 8
    for n, group in enumerate(decoded):
        for r, row in enumerate(group):
            assert np.array_equal(syms[n, r, :row.size].numpy(), row)


# --- the table builder (decode_tables) ---------------------------------------

def _built_rows(stack, rows):
    """``decode_tables`` on CPU tensors (the twin) of a (U, 256) table
    stack and an (N, 32) row index, as numpy."""
    octet, dense = decode_tables(
        torch.from_numpy(np.ascontiguousarray(stack, np.uint16).view(
            np.int16)), torch.from_numpy(np.asarray(rows, np.int32)))
    return octet.numpy(), dense.numpy()


def _assert_rows_match_packer(stack):
    """Every table of ``stack`` built in a row (shuffled, with rows of no
    segment between them) equals ``pack_device_tables``' octet and dense
    rows bit for bit; rows of -1 stay zero."""
    U = len(stack)
    order = np.random.default_rng(U).permutation(U)
    flat = np.full(-(-(2 * U) // 32) * 32, -1, np.int32)
    flat[::2][:U] = order
    rows = flat.reshape(-1, 32)
    octet, dense = _built_rows(stack, rows)
    assert octet.dtype == dense.dtype == np.int32
    assert octet.shape == rows.shape + (128,)
    assert dense.shape == rows.shape + (256,)
    for (n, r), u in np.ndenumerate(rows):
        if u < 0:
            assert not octet[n, r].any() and not dense[n, r].any()
            continue
        _c, d, _n2, o = tables.pack_device_tables(stack[u])
        assert o is not None, 'table %d is not 8-aligned' % u
        assert np.array_equal(dense[n, r], d.reshape(-1)), u
        assert np.array_equal(octet[n, r], o), u


def _recording_tables(tmp_path, kind):
    """Every frequency table of a small recording written by the port: a
    385-channel walk kept modulo 2**16, of small steps for ``'ap'`` (one
    coded byte plane) and of steps large enough to code both planes for
    ``'lfp'``."""
    rng = np.random.default_rng(5)
    C, T = 385, 1250
    # Channels of unlike step sizes, so that segments of a plane differ.
    std = rng.uniform(1, 12, size=C) if kind == 'ap' else rng.uniform(
        3, 40, size=C)
    steps = rng.normal(0, 1, size=(2 * T, C)) * std
    arr = (np.cumsum(steps, axis=0).astype(np.int64) % 65536).astype(
        np.uint16).view(np.int16)
    path = write_arr(tmp_path / (kind + '.bin'), arr)
    cbin, ch = tmp_path / (kind + '.cbin'), tmp_path / (kind + '.ch')
    mt.compress(path, cbin, ch, sample_rate=float(T), n_channels=C,
                dtype='int16', algorithm='ans', quiet=True,
                check_after_compress=False, device='none')
    r = mt.decompress(cbin, ch, device='none', quiet=True)
    try:
        parsed = [r.codec.parse(port_read_payload(r, i))
                  for i in range(r.n_chunks)]
    finally:
        r.close()
    planes = [p for p, m in enumerate(parsed[0]['modes'])
              if m == PORT_MODE_RANS]
    assert len(planes) == (1 if kind == 'ap' else 2)
    return freq_stack(parsed, planes)[0]


@pytest.mark.parametrize('kind', ['ap', 'lfp'])
def test_decode_tables_match_packer_on_recordings(tmp_path_, kind):
    """Every table an AP-like and an LFP-like recording written by the
    port carries."""
    stack = _recording_tables(tmp_path_, kind)
    assert len(stack) > 2
    _assert_rows_match_packer(stack)


@pytest.mark.parametrize('seed', range(4))
def test_decode_tables_match_packer_on_random_tables(seed):
    """8-aligned tables of random alphabets, flat and skewed, from the
    writer's quantizer."""
    rng = np.random.default_rng(seed)
    stack = []
    for _ in range(40):
        n_sym = int(rng.integers(2, 257))
        alpha = float(rng.choice([0.05, 1.0, 20.0]))
        hist = np.zeros(256, np.int64)
        sym = rng.choice(256, size=n_sym, replace=False)
        hist[sym] = rng.multinomial(5000, rng.dirichlet(
            np.full(n_sym, alpha))) + 1
        stack.append(port_rans.quantize_freqs(hist))
    _assert_rows_match_packer(np.stack(stack).astype(np.uint16))


def _edge_table(name):
    f = np.zeros(256, np.int64)
    if name == 'one_symbol':
        f[200] = 4096
    elif name == 'all_256':
        f[:] = 16
    elif name == 'last_symbol_8':
        f[0], f[255] = 4088, 8
    elif name == 'first_and_last_8':
        f[0], f[128], f[255] = 8, 4080, 8
    return f


@pytest.mark.parametrize('name', ['one_symbol', 'all_256', 'last_symbol_8',
                                  'first_and_last_8'])
def test_decode_tables_edge_tables(name):
    """One symbol of 4096 (its frequency reaches the symbol's bits of
    the dense entry, as in the packer), all 256 symbols present, and
    8-slot symbols at the ends of the alphabet."""
    _assert_rows_match_packer(_edge_table(name)[None].astype(np.uint16))


def test_decode_tables_rows_without_segment_and_bad_inputs():
    """Rows of -1, and of an index outside the stack, are zeros; an
    empty stack builds all-zero rows; wrong dtypes and shapes raise."""
    stack = np.stack([_edge_table('all_256'),
                      _edge_table('last_symbol_8')]).astype(np.uint16)
    rows = np.full((2, 32), -1, np.int32)
    rows[0, 3], rows[1, 0], rows[1, 1] = 1, 0, 2
    octet, dense = _built_rows(stack, rows)
    live = np.zeros((2, 32), bool)
    live[0, 3] = live[1, 0] = True
    assert not octet[~live].any() and not dense[~live].any()
    assert octet[live].all(axis=1).any() and dense[live].any()
    octet, dense = _built_rows(np.zeros((0, 256), np.uint16), rows)
    assert not octet.any() and not dense.any()
    f = torch.zeros((2, 256), dtype=torch.int16)
    r = torch.zeros((1, 32), dtype=torch.int32)
    for bad_f, bad_r, key in [(f.to(torch.int32), r, 'freqs'),
                              (f[:, :128], r, 'freqs'),
                              (f, r.to(torch.int64), 'rows'),
                              (f, r[:, :16], 'rows')]:
        with pytest.raises(ValueError, match=key):
            decode_tables(bad_f, bad_r)


def test_decode_tables_twin_equals_wrapper_on_cpu():
    """For CPU tensors the wrapper is the twin (no launch is counted)."""
    stack = torch.from_numpy(np.stack(
        [_edge_table('all_256'), _edge_table('one_symbol')]).astype(
            np.int16))
    rows = torch.tensor([[0, 1, -1] + [0] * 29], dtype=torch.int32)
    before = dict(mt.launch_counts())
    got = decode_tables(stack, rows)
    want = decode_tables_ref(stack, rows)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert mt.launch_counts() == before
