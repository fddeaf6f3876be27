"""PyTorch port: the generic decode route (every layout outside fuse8).

Chunks whose zigzagged diffs do not share one high byte (spikes), a
second-order time diff, C order, spatial diff, no time diff, 1- and
4-byte dtypes, bitcast floats, RAW planes, flags bit6 without the tail
packing and tables from other writers all decode on the port's device
route. For each such file the port's ``pack`` stages the same arrays as
the JAX package's, and its ``decode_batch`` returns the same bytes as
the JAX package's (Pallas in interpret mode) and as the source; the
reader's entry points decode it with no chunk on the host codec. The
files are written by the port's own host codec (the JAX package's
bytes); the foreign writer's tables come from patching the port's copy
of the codec.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from mtscomp_tpu import decompress  # noqa: E402
from mtscomp_tpu.codec.ans import MODE_RANS, MODE_RAW  # noqa: E402
from mtscomp_tpu.parallel.pipeline import (  # noqa: E402
    DeviceBatchDecoder as JaxDecoder, _read_payload)

import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.codec.ans as ans_mod  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

from conftest import make_signal, to_int16, write_arr  # noqa: E402
from chip_smoke import foreign_quantizer, heavy_tailed_steps  # noqa: E402


def spiky(n, C, seed, step=5.0, rate=1 / 6000):
    """Random walk (diff std ``step``) with spikes: a (-60, -90, +150)
    step over 3 samples at ``rate`` per sample and channel. Each spike's
    +150 diff leaves the high byte plane non-constant."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, step, size=(n, C))
    t, c = np.nonzero(rng.random((n - 3, C)) < rate)
    for k, v in enumerate((-60.0, -90.0, 150.0)):
        np.add.at(d, (t + k, c), v)
    return np.cumsum(d, axis=0).astype(np.int64)


def _heavy_tailed(n, C, seed):
    steps = heavy_tailed_steps(np.random.default_rng(seed), (n, C))
    return np.cumsum(steps, axis=0).astype(np.int16)


S12 = {'ans_seg_log2': 12}
ORDER1 = {'time_diff_order': 1, 'do_spatial_diff': False}

# name: (source array, samples per chunk, compress options, foreign
# min frequency or None, expected decode route).
GEOMS = {
    'spiky_int16': (lambda: spiky(2000, 129, 0).astype(np.int16), 1000,
                    dict(S12, **ORDER1), None, 'generic'),
    'spiky_uint16': (lambda: spiky(2000, 40, 1).astype(np.int16).view(
        np.uint16), 1000, ORDER1, None, 'generic'),
    'order2_generic': (lambda: spiky(2000, 129, 2).astype(np.int16), 1000,
                       dict(S12, time_diff_order=2, do_spatial_diff=False),
                       None, 'generic'),
    'order2_fuse8': (lambda: np.cumsum(np.random.default_rng(3).normal(
        0, 0.5, size=(2000, 129)), axis=0).astype(np.int16), 1000,
        dict(S12, time_diff_order=2, do_spatial_diff=False), None, 'fuse8'),
    'c_order': (lambda: spiky(2000, 129, 4).astype(np.int16), 1000,
                dict(S12, chunk_order='C', **ORDER1), None, 'generic'),
    'spatial': (lambda: spiky(2000, 129, 5).astype(np.int16), 1000,
                dict(S12, time_diff_order=1, do_spatial_diff=True), None,
                'generic'),
    'no_time_diff': (lambda: spiky(2000, 40, 6).astype(np.int16), 1000,
                     dict(do_time_diff=False, do_spatial_diff=False), None,
                     'generic'),
    # One rANS plane, 33 segments: flags bit6, while the spatial diff
    # keeps the batch off the fuse8 route (no tail packing).
    'bit6_spatial': (lambda: np.cumsum(np.random.default_rng(7).normal(
        0, 5, size=(2000, 129)), axis=0).astype(np.int16), 1000,
        dict(S12, time_diff_order=1, do_spatial_diff=True), None, 'generic'),
    'uint8': (lambda: (spiky(2000, 129, 8) % 256).astype(np.uint8), 1000,
              dict(S12, **ORDER1), None, 'generic'),
    'int8': (lambda: (spiky(2000, 40, 9) % 256).astype(np.uint8).view(
        np.int8), 1000, ORDER1, None, 'generic'),
    'int32': (lambda: (spiky(2000, 40, 10) * 1001).astype(np.int32), 1000,
              ORDER1, None, 'generic'),
    'float32': (lambda: (np.cumsum(np.random.default_rng(11).normal(
        0, 1, size=(2000, 40)), axis=0) * 0.25).astype(np.float32), 1000,
        ORDER1, None, 'generic'),
    'float32_order2': (lambda: (np.cumsum(np.random.default_rng(14).normal(
        0, 1, size=(2000, 40)), axis=0) * 0.25).astype(np.float32), 1000,
        dict(time_diff_order=2, do_spatial_diff=False), None, 'generic'),
    'raw_plane': (lambda: to_int16(make_signal('colored', ns=4 * 300,
                                               nc=40)), 300, {}, None,
                  'generic'),
    'foreign_1fixup': (lambda: _heavy_tailed(2500, 24, 12), 1000,
                       dict(ans_table_mode='plane', **ORDER1), 16,
                       'generic'),
    'foreign_2fixups': (lambda: _heavy_tailed(2500, 24, 9), 1000,
                        dict(ans_table_mode='plane', **ORDER1), 8,
                        'generic'),
}


def _file(tmp_path, monkeypatch, name):
    """Compress geometry ``name``: (source, open JAX-package reader, T)."""
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    make, T, opts, min_freq, _route = GEOMS[name]
    arr = make()
    path = write_arr(tmp_path / 'g.bin', arr)
    with monkeypatch.context() as m:
        if min_freq is not None:
            m.setattr(ans_mod, '_quantize_rows', foreign_quantizer(min_freq))
        mt.compress(path, tmp_path / 'g.cbin', tmp_path / 'g.ch',
                    sample_rate=float(T), n_channels=arr.shape[1],
                    dtype=arr.dtype, algorithm='ans', quiet=True,
                    check_after_compress=False, device='none', **opts)
    return arr, decompress(tmp_path / 'g.cbin', tmp_path / 'g.ch',
                           quiet=True), T


def _parsed(r, n_samples):
    """The chunks of the file's first run (equal sample counts)."""
    n = sum(1 for i in range(r.n_chunks)
            if r.chunk_bounds[i + 1] - r.chunk_bounds[i] == n_samples)
    return [r.codec.parse(_read_payload(r, i)) for i in range(n)]


def _check_layout(name, parsed, fn):
    """The file really has the layout its name promises."""
    p0 = parsed[0]
    n_rans = sum(m == MODE_RANS for m in p0['modes'])
    route = 'fuse8' if fn.func is tp._decode_fuse8 else 'generic'
    assert route == GEOMS[name][4]
    if name.startswith(('spiky', 'order2_g', 'c_order', 'spatial')):
        assert n_rans == 2                      # both byte planes coded
    if name == 'bit6_spatial':
        assert p0['tail_split'] > 1 and n_rans == 1
    if name == 'raw_plane':
        assert MODE_RAW in p0['modes']
    if name.startswith('foreign'):
        assert fn.keywords['lay'].fixups == int(name[8])
    elif route == 'generic':
        assert fn.keywords['lay'].fixups == 0


@pytest.mark.parametrize('name', sorted(GEOMS))
def test_pack_matches_jax_pack_generic(tmp_path_, monkeypatch, name):
    arr, r, T = _file(tmp_path_, monkeypatch, name)
    try:
        parsed = _parsed(r, T)
        dec = tp.DeviceBatchDecoder(r, 'cpu')
        assert dec.supported(parsed, T)
        fn, args = dec.pack(parsed, T)
        _check_layout(name, parsed, fn)
        jdec = JaxDecoder(r)
        _jfn, jargs = jdec.pack(parsed, T)
        assert dec.last_tail == jdec.last_tail
        # Each group's words in the longest stream's rows: the JAX
        # package's further (slack and bucket) rows are all zero.
        rows = -(-max(g['words'].size for p in parsed for g in p['groups'])
                 // 128)
        assert args[1].shape[1] == rows * 128
        assert not tp.args_from_jax_pack(jargs, 'cpu')[1][:, rows * 128:].any()
        want = tp.args_from_jax_pack(jargs, 'cpu', rows=rows)
        assert len(args) == len(want) == 8
        for a, b in zip(args, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        out, used = fn(*args)
        tp.check_words_used(parsed, used)
        code = np.dtype(getattr(r, 'code_dtype', r.dtype))
        got = out.numpy().view(code)
        assert got.tobytes() == JaxDecoder(r).decode_batch(parsed, T).tobytes()
        src = arr[:len(parsed) * T].view(code)
        assert np.array_equal(got.reshape(src.shape), src)
    finally:
        r.close()


@pytest.mark.parametrize('name', sorted(GEOMS))
def test_decode_batch_generic_matches_jax_and_source(tmp_path_, monkeypatch,
                                                     name):
    arr, r, T = _file(tmp_path_, monkeypatch, name)
    try:
        parsed = _parsed(r, T)
        code = np.dtype(getattr(r, 'code_dtype', r.dtype))
        got = tp.DeviceBatchDecoder(r, 'cpu').decode_batch(parsed, T)
        want = JaxDecoder(r).decode_batch(parsed, T)
        assert got.dtype == want.dtype == code
        assert got.shape == want.shape == (len(parsed), T, arr.shape[1])
        assert np.array_equal(got, want)
        src = arr[:len(parsed) * T].view(code)
        assert np.array_equal(got.reshape(src.shape), src)
    finally:
        r.close()


@pytest.mark.parametrize('name', sorted(GEOMS))
def test_reader_generic_entry_points(tmp_path_, monkeypatch, name):
    """decompress(...).to_array / to_tensor / tofile and a mid-file span,
    byte-exact, with no chunk on the host codec."""
    arr, r, T = _file(tmp_path_, monkeypatch, name)
    r.close()
    mt.reset_launch_counts()
    rp = mt.decompress(tmp_path_ / 'g.cbin', tmp_path_ / 'g.ch',
                       device='cpu', quiet=True)
    try:
        assert np.array_equal(rp.to_array(), arr)
        assert np.array_equal(rp.to_array(1, rp.n_chunks - 1), arr[T:])
        t = rp.to_tensor()
        assert tuple(t.shape) == arr.shape
        assert np.array_equal(t.numpy(), arr)
        out = tmp_path_ / 'o.bin'
        rp.tofile(out)
        assert np.array_equal(
            np.fromfile(out, arr.dtype).reshape(arr.shape), arr)
        counts = mt.launch_counts()
        assert counts['host_fallback_chunks'] == 0
        # CPU decodes run the twins: no kernel launch is counted.
        assert sum(v for k, v in counts.items()
                   if k != 'host_fallback_chunks') == 0
    finally:
        rp.close()


def test_long_word_stream_decodes_through_k1(tmp_path_, monkeypatch):
    """A group whose word stream exceeds the TPU kernel's VMEM window
    (WR > 16384 rows of 128 words): the JAX package takes its XLA scan
    decoder there, the port its one K1; both give the source."""
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    rng = np.random.default_rng(13)
    T, C = 100000, 64
    arr = np.cumsum(rng.normal(0, 60, size=(T, C)), axis=0).astype(np.int16)
    path = write_arr(tmp_path_ / 'w.bin', arr)
    mt.compress(path, tmp_path_ / 'w.cbin', tmp_path_ / 'w.ch',
                sample_rate=float(T), n_channels=C, dtype='int16',
                algorithm='ans', quiet=True, check_after_compress=False,
                device='none', **ORDER1)
    r = decompress(tmp_path_ / 'w.cbin', tmp_path_ / 'w.ch', quiet=True)
    try:
        parsed = _parsed(r, T)
        assert len(parsed[0]['groups']) == 1
        fn, args = tp.DeviceBatchDecoder(r, 'cpu').pack(parsed, T)
        assert args[1].shape[1] // 128 > 16384          # WR rows
        got = tp.DeviceBatchDecoder(r, 'cpu').decode_batch(parsed, T)
        assert np.array_equal(got.reshape(arr.shape), arr)
        assert np.array_equal(JaxDecoder(r).decode_batch(parsed, T), got)
    finally:
        r.close()
