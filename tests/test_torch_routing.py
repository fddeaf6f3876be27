"""PyTorch port: layouts that the port's kernels take and the JAX
package's routing sends elsewhere.

Decode. The JAX package's fused u8 route (K1 + K2/K3) asks for a Pallas
step block (a divisor of the step count in 8..128), a 128-lane channel
tile (segments of a multiple of 4 channels), ``tp >= T`` and, for the
ragged tail, at most 32 tail channels behind at most 1024 rows. The
port's fused route asks for none of these: each layout below decodes
on it in the port and on the generic route in the JAX package, to the
source and to the JAX package's bytes, and K1's twin gives every
group's rows as the normative decoder does.

Encode. The port's device encode takes 4-byte elements (int32, uint32,
float32 through the writer's bitcast), mode-uniform sub-batches and
adaptive window runs of any length, segment tables without
channel-aligned segments and chunks of one sample; each writes the host
codec's bytes, equal to the JAX package's host route, with no chunk on
the host codec.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu  # noqa: E402
from mtscomp_tpu import decompress  # noqa: E402
from mtscomp_tpu.parallel import pipeline as jpl  # noqa: E402

import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.codec.ans as ans_mod  # noqa: E402
from mtscomp_tpu_torch import config as mt_config  # noqa: E402
from mtscomp_tpu_torch.codec.ans import MODE_RANS, seg_freqs  # noqa: E402
from mtscomp_tpu_torch.models import rans  # noqa: E402
from mtscomp_tpu_torch.ops.rans_decode import decode_groups  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

from chip_smoke import foreign_geometry  # noqa: E402
from conftest import write_arr  # noqa: E402

ORDER1 = {'time_diff_order': 1, 'do_spatial_diff': False}


@pytest.fixture(autouse=True)
def _port_config(tmp_path, monkeypatch):
    """The port's user config file redirected; the JAX side runs its
    Pallas kernels in interpret mode."""
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')


def _walk(n, C, seed, step=5.0):
    """Random walk (diff std ``step``): one rANS plane under a constant
    high byte, the fused route's layout."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0.0, step, size=(n, C)),
                     axis=0).astype(np.int16)


# name: (channels, samples per chunk, compress options, segment width of
# another writer or None, expected ragged tail (remaining channels, its
# rows' symbol counts) or None). Two chunks each.
FUSED = {
    # 16700 samples: k = 4 and S = 4 * 131 steps, no divisor in 8..128.
    'steps_without_divisor': (9, 16700, {'ans_seg_log2': 12}, None, None),
    # 129 samples: tp = 128 = the coded samples, so tp < T.
    'tp_below_T': (40, 129, {}, None, None),
    # Segments of 5 and 6 channels: 32 * k is no multiple of 128.
    'k5': (15, 2000, {}, 5, None),
    'k6_bit6_tail': (193, 300, {}, 6, (1, (128, 128, 128))),
    # 257 segments of 4 channels: 8 full groups before the bit6 tail,
    # past the 1024-row bound.
    'bit6_past_1024_rows': (1025, 1000, {'ans_seg_log2': 12}, None,
                            (1, (128,) * 8)),
    # 128-channel segments and a 33-channel bit6 tail.
    'bit6_tail_of_33': (4129, 100, {'ans_seg_log2': 14}, None,
                        (33, (640,) * 6 + (384,))),
}


def _fused_file(tmp_path, monkeypatch, name):
    C, T, opts, k, _tail = FUSED[name]
    arr = _walk(2 * T, C, seed=len(name))
    path = write_arr(tmp_path / 'f.bin', arr)
    with monkeypatch.context() as m:
        if k is not None:
            m.setattr(ans_mod, 'aligned_geometry', foreign_geometry(k))
        mt.compress(path, tmp_path / 'f.cbin', tmp_path / 'f.ch',
                    sample_rate=float(T), n_channels=C, dtype='int16',
                    algorithm='ans', quiet=True, check_after_compress=False,
                    device='none', **dict(ORDER1, **opts))
    r = decompress(tmp_path / 'f.cbin', tmp_path / 'f.ch', quiet=True)
    parsed = [r.codec.parse(tp._read_payload(r, i)) for i in range(r.n_chunks)]
    return arr, r, T, parsed


def _normative_rows(parsed, b, gi):
    """Chunk b's group gi as the normative decoder gives it: its rows'
    symbols and the words it consumed."""
    g = parsed[b]['groups'][gi]
    R = len(g['segments'])
    freqs = np.stack([seg_freqs(parsed[b], p, s) for p, s, _ in
                      g['segments']])
    counts = np.array([n for _, _, n in g['segments']])
    rows, used = rans.rans_decode_group(g['states'][:R], g['words'], freqs,
                                        counts)
    assert used == g['words'].size
    return [row[:n] for row, n in zip(rows, counts)]


@pytest.mark.parametrize('name', sorted(FUSED))
def test_layout_decodes_fused_in_the_port(tmp_path_, monkeypatch, name):
    C, T, _opts, k, tail = FUSED[name]
    arr, r, _T, parsed = _fused_file(tmp_path_, monkeypatch, name)
    try:
        p0 = parsed[0]
        assert p0['modes'] == [MODE_RANS, ans_mod.MODE_CONST]
        tp_ = -(-(T - 1) // 128) * 128
        S = -(-min(p0['seg'], p0['n_stream']) // 128)
        if k is not None:
            assert p0['seg'] == k * tp_
        # The JAX package's predicate sends the layout to its generic
        # route; the port fuses it.
        jfuse8, _k, _spb = jpl._fuse8_geom(
            tuple(p0['modes']), np.dtype(np.int16), p0['zigzag'], 'F', True,
            False, p0['seg'], tp_, T, S, True, p0['aligned'], True)
        jdec = jpl.DeviceBatchDecoder(r)
        jdec.pack(parsed, T)
        assert not jfuse8 or (tail is not None and jdec.last_tail is None)
        dec = tp.DeviceBatchDecoder(r, 'cpu')
        assert dec.supported(parsed, T)
        fn, args = dec.pack(parsed, T)
        assert fn.func is tp._decode_fuse8
        want_tail = None if tail is None else (tail[0], -(-tail[0] // 8) * 8,
                                               tail[1])
        assert dec.last_tail == want_tail
        assert (p0['tail_split'] > 1) == (tail is not None)
        out, used = fn(*args)
        tp.check_words_used(parsed, used)
        got = out.numpy()
        assert np.array_equal(got.reshape(arr.shape), arr)
        want = np.asarray(jdec.decode_batch(parsed, T)).tobytes()
        assert got.tobytes() == want
        assert dec.decode_batch(parsed, T).tobytes() == want

        # K1's twin on the staged groups against the normative decoder,
        # group by group (the ragged tail's groups after the full ones).
        syms, _used = decode_groups(*args[:5], fn.keywords['S'])
        B, G = len(parsed), len(p0['groups'])
        for b in range(B):
            for gi in range(G):
                slot = (b * G + gi if tail is None
                        else B * (G - 1) + b if gi == G - 1
                        else b * (G - 1) + gi)
                for row, want_row in enumerate(_normative_rows(parsed, b,
                                                               gi)):
                    assert np.array_equal(
                        syms[slot, row, :want_row.size].numpy(), want_row)
    finally:
        r.close()


@pytest.mark.parametrize('name', ['k6_bit6_tail', 'bit6_past_1024_rows'])
def test_reader_decodes_fused_layouts(tmp_path_, monkeypatch, name):
    """decompress(..., device='cpu').to_array() and a window of a newly
    fused layout: the source, no chunk on the host codec."""
    arr, r, T, _parsed = _fused_file(tmp_path_, monkeypatch, name)
    r.close()
    mt.reset_launch_counts()
    rp = mt.decompress(tmp_path_ / 'f.cbin', tmp_path_ / 'f.ch', device='cpu',
                       quiet=True)
    try:
        assert np.array_equal(rp.to_array(), arr)
        assert np.array_equal(rp[T - 7:T + 5], arr[T - 7:T + 5])
    finally:
        rp.close()
    assert mt.launch_counts()['host_fallback_chunks'] == 0


# --- encode ---------------------------------------------------------------

T, C = 500, 129


def _spiky(seed, n=3 * T, C=C, step=5.0, spikes=1 / 1500):
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, step, size=(n, C))
    t, c = np.nonzero(rng.random((n - 3, C)) < spikes)
    for j, v in enumerate((-60.0, -90.0, 150.0)):
        np.add.at(d, (t + j, c), v)
    return np.cumsum(d, axis=0)


# name: (source, compress options, expected plane count).
WIDE = {
    'int32': (lambda: (_spiky(20) * 1001).astype(np.int32), ORDER1, 4),
    'int32_plane_tables': (lambda: (_spiky(21) * 1001).astype(np.int32),
                           dict(ORDER1, ans_table_mode='plane'), 4),
    'int32_order2': (lambda: (_spiky(22) * 7).astype(np.int32),
                     dict(time_diff_order=2, do_spatial_diff=False), 4),
    'int32_c_order': (lambda: (_spiky(23) * 1001).astype(np.int32),
                      dict(ORDER1, chunk_order='C'), 4),
    'uint32': (lambda: ((_spiky(24) * 1001).astype(np.int64)
                        % (1 << 32)).astype(np.uint32), ORDER1, 4),
    'float32': (lambda: (_spiky(25) * 0.25).astype(np.float32), ORDER1, 4),
    'float32_spatial': (lambda: (_spiky(26) * 0.25).astype(np.float32),
                        dict(time_diff_order=1, do_spatial_diff=True), 4),
}


def _compress_both(tmp_path, arr, n_samples=T, **kw):
    """The port's compress on the device route (the twins) and the JAX
    package's on the host codec, in chunks of ``n_samples``: asserts
    their ``.cbin`` and ``.ch`` equal and returns the port's
    host-encoded chunk count."""
    raw = write_arr(tmp_path / 'w.bin', arr)
    kw = dict(sample_rate=float(n_samples), n_channels=arr.shape[1],
              dtype=arr.dtype, algorithm='ans', quiet=True, **kw)
    mt.reset_launch_counts()
    mt.compress(raw, tmp_path / 'p.cbin', tmp_path / 'p.ch', device='cpu',
                **kw)
    n_host = mt.launch_counts()['host_encoded_chunks']
    mtscomp_tpu.compress(raw, tmp_path / 'j.cbin', tmp_path / 'j.ch',
                         device='none', **kw)
    for ext in ('.cbin', '.ch'):
        assert ((tmp_path / ('p' + ext)).read_bytes()
                == (tmp_path / ('j' + ext)).read_bytes())
    return n_host


@pytest.mark.parametrize('name', sorted(WIDE))
def test_four_byte_elements_encode_on_the_device(tmp_path_, name):
    """4-byte files encode on the device route: the host codec's bytes,
    the JAX package's file (its host route: its encode takes 2-byte
    elements at most), no chunk on the host codec; the port decodes it."""
    make, opts, n_planes = WIDE[name]
    arr = make()
    w = mt.Writer(algorithm='ans', quiet=True, device='cpu', **opts)
    raw = write_arr(tmp_path_ / 'w.bin', arr)
    w.open(raw, sample_rate=float(T), n_channels=C, dtype=arr.dtype)
    try:
        enc = tp.DeviceBatchEncoder(w, device='cpu')
        assert enc.supported(T)
        chunks = np.stack([np.asarray(w.get_chunk(i)) for i in range(2)])
        mt.reset_launch_counts()
        got = enc.encode_batch(chunks)
        assert mt.launch_counts()['host_encoded_chunks'] == 0
        code = np.dtype(getattr(w, 'code_dtype', w.dtype))
        host = [w.codec.encode(w._transform_chunk(c.view(code)),
                               order=w.chunk_order) for c in chunks]
        assert got == host
        parsed = [w.codec.parse(p) for p in got]
        assert all(len(p['modes']) == n_planes for p in parsed)
        assert any(MODE_RANS in p['modes'] for p in parsed)
    finally:
        w.close()
    assert _compress_both(tmp_path_, arr[:2 * T + 300], **opts) == 0
    r = mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                      quiet=True)
    try:
        assert r.to_array().tobytes() == arr[:2 * T + 300].tobytes()
    finally:
        r.close()


def _one_sample_source(dtype, n=6, C=40, seed=29):
    """``n`` samples of a smooth channel profile that moves in time, in
    ``dtype``'s range (float32: NaN and both infinities planted)."""
    rng = np.random.default_rng(seed)
    prof = np.cumsum(rng.integers(-3, 4, size=(n, C)), axis=1)
    walk = prof + np.cumsum(rng.integers(-9, 10, size=(n, 1)), axis=0)
    dt = np.dtype(dtype)
    if dt.kind == 'f':
        arr = (walk * 0.25).astype(dt)
        arr.reshape(-1)[[1, C + 2, 2 * C + 3]] = [np.nan, np.inf, -np.inf]
        return arr
    info = np.iinfo(dt)
    mid = (int(info.min) + int(info.max)) // 2
    return ((walk + mid - int(info.min)) % (int(info.max) - int(info.min)
                                           + 1) + int(info.min)).astype(dt)


ONE_SAMPLE_LAYOUTS = {
    'f_order1': ORDER1,
    'c_order': dict(ORDER1, chunk_order='C'),
    'order2': {'time_diff_order': 2, 'do_spatial_diff': False},
    'spatial': {'time_diff_order': 1, 'do_spatial_diff': True},
}


@pytest.mark.parametrize('layout', sorted(ONE_SAMPLE_LAYOUTS))
@pytest.mark.parametrize('dtype', ['uint8', 'int8', 'int16', 'uint16',
                                   'int32', 'float32'])
def test_one_sample_chunks_encode_on_the_device(tmp_path_, dtype, layout):
    """Chunks of one sample (no head: the host codec codes the sample's
    row itself, flags without bit1) encode on the device route in every
    layout: the JAX package's host-route file, no chunk on the host
    codec; the port's device decode returns the source."""
    arr = _one_sample_source(dtype)
    opts = ONE_SAMPLE_LAYOUTS[layout]
    assert _compress_both(tmp_path_, arr, n_samples=1, **opts) == 0
    r = mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                      quiet=True)
    try:
        parsed = [r.codec.parse(tp._read_payload(r, i))
                  for i in range(r.n_chunks)]
        assert r.n_chunks == arr.shape[0]
        assert all(p['n_head'] == 0 for p in parsed)
        mt.reset_launch_counts()
        assert r.to_array().tobytes() == arr.tobytes()
        assert mt.launch_counts()['host_fallback_chunks'] == 0
    finally:
        r.close()


@pytest.mark.parametrize('order,aligned', [('C', True), ('F', False)])
@pytest.mark.parametrize('dtype', ['int16', 'int32'])
def test_segment_tables_without_aligned_segments(tmp_path_, order, aligned,
                                                 dtype):
    """Segment tables over a stream without channel-aligned segments (C
    order, or aligned segments switched off): the per-segment histograms
    come from the card, the tables from the codec's own clustering, and
    the bytes are the host codec's; the JAX package leaves such batches
    to its host codec."""
    walk = _spiky(27, n=2 * T) * np.linspace(0.25, 4.0, C)[None]
    arr = (walk.astype(np.int16) if dtype == 'int16'
           else walk.astype(np.int32))
    opts = dict(ORDER1, chunk_order=order, ans_channel_segments=aligned,
                ans_seg_log2=12)
    w = mt.Writer(algorithm='ans', quiet=True, device='cpu', **opts)
    raw = write_arr(tmp_path_ / 'w.bin', arr)
    w.open(raw, sample_rate=float(T), n_channels=C, dtype=arr.dtype)
    try:
        chunks = np.stack([np.asarray(w.get_chunk(i)) for i in range(2)])
        got = tp.DeviceBatchEncoder(w, device='cpu').encode_batch(chunks)
        host = [w.codec.encode(w._transform_chunk(c), order=order)
                for c in chunks]
        assert got == host
        parsed = [w.codec.parse(p) for p in got]
        assert not parsed[0]['aligned']
        # Clustered tables: some rANS plane holds more than one.
        assert any(len(p['planes'][q].get('tables', ())) > 1
                   for p in parsed for q in range(len(p['modes']))
                   if p['modes'][q] == MODE_RANS)
    finally:
        w.close()
    assert _compress_both(tmp_path_, arr, **opts) == 0


def test_adaptive_runs_shorter_than_four_chunks(tmp_path_):
    """transform_adapt=1 re-probes every chunk: a walk, then a slow
    oscillation, makes window runs of 1-3 chunks, each encoded on the
    device (the JAX package's route sends them to its host codec); the
    file equals the JAX package's."""
    n = 6 * T
    walk = _spiky(28, n=n, spikes=0.0)
    walk[3 * T:] = walk[3 * T - 1] + 2000 * np.sin(
        np.arange(3 * T)[:, None] / 40.0 + np.arange(C))
    arr = np.round(walk).astype(np.int16)
    assert _compress_both(tmp_path_, arr, transform_adapt=1,
                          n_threads=8) == 0
    r = mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                      quiet=True)
    try:
        transforms = [r.codec.parse(tp._read_payload(r, i))['transform']
                      for i in range(r.n_chunks)]
        assert np.array_equal(r.to_array(), arr)
    finally:
        r.close()
    runs = [1]
    for a, b in zip(transforms, transforms[1:]):
        if a == b:
            runs[-1] += 1
        else:
            runs.append(1)
    assert len(runs) >= 2 and min(runs) < 4
