"""PyTorch port, K1: the grouped rANS decode and its host-side tables.

The port's plain twin of the decode kernel (what ``decode_groups`` runs
for CPU tensors) is held, bit for bit, against the JAX package's Pallas
kernel in interpret mode and against the normative coder, on groups
packed from real containers. The re-housed table packer is held against
the JAX package's for every table those containers carry.
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

from mtscomp_tpu_torch.ops import tables  # noqa: E402
from mtscomp_tpu_torch.ops.rans_decode import (  # noqa: E402
    decode_groups, decode_groups_coarse, decode_groups_ref)
from mtscomp_tpu_torch.parallel.pipeline import (  # noqa: E402
    DeviceBatchDecoder, args_from_jax_pack)

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
