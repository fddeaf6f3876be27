"""PyTorch port: the staged batch decode and the user entry points.

The port's ``pack`` stages the same arrays as the JAX package's, and its
``decode_batch`` returns the same bytes as the JAX package's (Pallas in
interpret mode) and as the source, on the 129-channel ragged-tail
geometry, the 128-channel uniform one and 40-channel int16/uint16 (the
fuse8 route; ``test_torch_generic.py`` holds the other layouts), and
every frozen ans file decodes through the port.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from mtscomp_tpu import compress, decompress  # noqa: E402
from mtscomp_tpu.parallel.pipeline import (  # noqa: E402
    DeviceBatchDecoder as JaxDecoder, _read_payload)

import mtscomp_tpu_torch as mt  # noqa: E402
from mtscomp_tpu_torch.device import resolve_device  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

from conftest import make_signal, to_int16, write_arr  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _file(tmp_path, name, monkeypatch, step=5.0, **kw):
    """The JAX device tests' geometries: (source array, reader, T).

    Random walks with small steps (``step``) keep each chunk's high
    byte constant, so every geometry takes the fused u8 route.
    """
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    dtype = 'int16'
    if name == 'ragged129':
        # 4-channel segments, a 1-channel tail split into 8 sub-rows.
        C, T, n, seed, opts = 129, 1000, 4, 7, {'ans_seg_log2': 12}
    elif name == 'uniform128':
        C, T, n, seed, opts = 128, 1000, 2, 8, {'ans_seg_log2': 12}
    else:                                     # wide40_int16 / _uint16
        C, T, n, seed, opts = 40, 300, 4, 9, {}
        dtype = name.split('_')[1]
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.normal(0, step, size=(n * T, C)),
                    axis=0).astype(np.int16).astype(dtype)
    opts.update(kw)
    return arr, _compressed(tmp_path, arr, T, **opts), T


def _compressed(tmp_path, arr, T, **opts):
    path = write_arr(tmp_path / 'p.bin', arr)
    compress(path, tmp_path / 'p.cbin', tmp_path / 'p.ch',
             sample_rate=float(T), n_channels=arr.shape[1],
             dtype=arr.dtype, algorithm='ans', quiet=True,
             check_after_compress=False, device='none', **opts)
    return decompress(tmp_path / 'p.cbin', tmp_path / 'p.ch', quiet=True)


def _parsed(r):
    return [r.codec.parse(_read_payload(r, i)) for i in range(r.n_chunks)]


GEOMS = ['ragged129', 'uniform128', 'wide40_int16', 'wide40_uint16']
TAILS = {'ragged129': (1, 8, (128,) * 8)}


@pytest.mark.parametrize('name', GEOMS)
def test_pack_matches_jax_pack(tmp_path_, monkeypatch, name):
    _arr, r, T = _file(tmp_path_, name, monkeypatch)
    try:
        parsed = _parsed(r)
        dec = tp.DeviceBatchDecoder(r, 'cpu')
        assert dec.supported(parsed, T)
        fn, args = dec.pack(parsed, T)
        jdec = JaxDecoder(r)
        _jfn, jargs = jdec.pack(parsed, T)
        assert dec.last_tail == jdec.last_tail == TAILS.get(name)
        want = tp.args_from_jax_pack(jargs, 'cpu')
        assert len(args) == len(want) == 8
        for a, b in zip(args, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert fn.keywords['tail'] == dec.last_tail
    finally:
        r.close()


@pytest.mark.parametrize('name', GEOMS)
def test_decode_batch_matches_jax_and_source(tmp_path_, monkeypatch, name):
    arr, r, T = _file(tmp_path_, name, monkeypatch)
    try:
        parsed = _parsed(r)
        got = tp.DeviceBatchDecoder(r, 'cpu').decode_batch(parsed, T)
        want = JaxDecoder(r).decode_batch(parsed, T)
        assert got.dtype == want.dtype == arr.dtype
        assert got.shape == want.shape == (len(parsed), T, arr.shape[1])
        assert np.array_equal(got, want)
        assert np.array_equal(got.reshape(arr.shape), arr)
    finally:
        r.close()


@pytest.mark.parametrize('name', ['ragged129', 'uniform128'])
def test_dropped_word_fails_the_audit(tmp_path_, monkeypatch, name):
    _arr, r, T = _file(tmp_path_, name, monkeypatch)
    try:
        parsed = _parsed(r)
        g = parsed[1]['groups'][0]
        assert g['words'].size > 1
        g['words'] = g['words'][:-1]
        with pytest.raises(IOError, match='payload words'):
            tp.DeviceBatchDecoder(r, 'cpu').decode_batch(parsed, T)
        with pytest.raises(IOError, match='payload words'):
            JaxDecoder(r).decode_batch(parsed, T)
    finally:
        r.close()


def _decodes_on_the_port(r, arr, T, tmp_path):
    """The JAX package decodes this file's batch on its device, and so
    does the port, byte for byte, from the batch decoder and from the
    reader, with no chunk on the host codec."""
    try:
        parsed = _parsed(r)
        dec = tp.DeviceBatchDecoder(r, 'cpu')
        assert dec.supported(parsed, T)
        got = dec.decode_batch(parsed, T)
        want = JaxDecoder(r).decode_batch(parsed, T)
        assert np.array_equal(got, want)
        assert np.array_equal(got.reshape(arr.shape), arr)
    finally:
        r.close()
    mt.reset_launch_counts()
    rp = mt.decompress(tmp_path / 'p.cbin', tmp_path / 'p.ch', device='cpu',
                       quiet=True)
    try:
        assert np.array_equal(rp.to_array(), arr)
        assert mt.launch_counts()['host_fallback_chunks'] == 0
    finally:
        rp.close()


def test_order2_fuse8_decodes(tmp_path_, monkeypatch):
    """Second-order time diff on the fuse8 route (finalize, then K5)."""
    # Small steps keep the second diffs' high byte constant: fuse8 + K5.
    arr, r, T = _file(tmp_path_, 'ragged129', monkeypatch, step=0.5,
                      time_diff_order=2)
    fn, _args = tp.DeviceBatchDecoder(r, 'cpu').pack(_parsed(r), T)
    assert fn.func is tp._decode_fuse8 and fn.keywords['diff_order'] == 2
    _decodes_on_the_port(r, arr, T, tmp_path_)


def test_raw_low_plane_takes_generic_route(tmp_path_, monkeypatch):
    """The 40-channel signal of the JAX fuse8 test codes its low byte
    plane RAW, which takes the generic route (K4)."""
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    arr = to_int16(make_signal('colored', ns=4 * 300, nc=40))
    r = _compressed(tmp_path_, arr, 300)
    fn, _args = tp.DeviceBatchDecoder(r, 'cpu').pack(_parsed(r), 300)
    assert fn.func is tp._decode_generic
    _decodes_on_the_port(r, arr, 300, tmp_path_)


@pytest.mark.parametrize('name', GEOMS)
def test_reader_entry_points(tmp_path_, monkeypatch, name):
    """decompress(...).to_array / to_tensor / tofile through the port,
    plus a span that starts and ends mid-file."""
    arr, r, T = _file(tmp_path_, name, monkeypatch)
    r.close()
    mt.reset_launch_counts()
    rp = mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch',
                       device='cpu', quiet=True)
    try:
        assert isinstance(rp, mt.Reader)
        assert np.array_equal(rp.to_array(), arr)
        n = rp.n_chunks
        assert np.array_equal(rp.to_array(1, n - 1), arr[T:])
        assert np.array_equal(rp.to_array(0, n - 2), arr[:(n - 1) * T])
        t = rp.to_tensor()
        assert t.device.type == 'cpu' and tuple(t.shape) == arr.shape
        assert np.array_equal(t.numpy(), arr)
        out = tmp_path_ / 'o.bin'
        rp.tofile(out)
        assert np.array_equal(np.fromfile(out, arr.dtype).reshape(arr.shape),
                              arr)
        # Windows stay on the host codec in this slice.
        assert np.array_equal(rp[5:T + 7, 2:9], arr[5:T + 7, 2:9])
        counts = mt.launch_counts()
        assert counts['host_fallback_chunks'] == 0
        # CPU decodes run the twins: no kernel launch is counted.
        assert len(counts) == 16
        assert not any(counts.values())
    finally:
        rp.close()


def test_unsupported_batch_goes_to_the_host(tmp_path_, monkeypatch):
    """A batch the JAX package also leaves to the host (supported()
    False: here int64) decodes on the host codec and is counted."""
    rng = np.random.default_rng(4)
    arr = np.cumsum(rng.integers(-9, 10, size=(600, 6)), axis=0)
    path = write_arr(tmp_path_ / 'q.bin', arr.astype(np.int64))
    compress(path, tmp_path_ / 'q.cbin', tmp_path_ / 'q.ch',
             sample_rate=200.0, n_channels=6, dtype='int64',
             algorithm='ans', quiet=True, check_after_compress=False,
             device='none')
    mt.reset_launch_counts()
    rp = mt.decompress(tmp_path_ / 'q.cbin', tmp_path_ / 'q.ch',
                       device='cpu', quiet=True)
    try:
        assert np.array_equal(rp.to_array(), arr)
        assert mt.launch_counts()['host_fallback_chunks'] == rp.n_chunks
        assert np.array_equal(rp.to_tensor().numpy(), arr)
    finally:
        rp.close()


def test_peek_desc_guards_tail_split(tmp_path_, monkeypatch):
    """A header whose bit6 sub-row count is out of range is rejected
    before it shapes the run grouping (the port's ``peek_desc`` checks
    the range the full parse checks)."""
    _arr, r, _T = _file(tmp_path_, 'ragged129', monkeypatch)
    r.close()
    cbin = tmp_path_ / 'p.cbin'
    good = cbin.read_bytes()
    assert good[6] & 64 and good[18:20] == (8).to_bytes(2, 'little')
    for bad in (0, 257, 1000):
        cbin.write_bytes(good[:18] + bad.to_bytes(2, 'little') + good[20:])
        rp = mt.decompress(cbin, tmp_path_ / 'p.ch', device='cpu',
                           quiet=True)
        try:
            with pytest.raises(IOError, match='tail_split'):
                rp.to_array()
        finally:
            rp.close()


def test_cuda_device_raises_without_a_gpu(tmp_path_, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        resolve_device('cuda')
    _arr, r, _T = _file(tmp_path_, 'wide40_int16', monkeypatch)
    r.close()
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', quiet=True)
    with pytest.raises(ValueError):
        resolve_device('meta')
    assert resolve_device('cpu') == torch.device('cpu')


def test_port_never_imports_jax(tmp_path_):
    """Compressing and decoding with the port loads neither JAX nor any
    module of the JAX package (this test process has both loaded
    already, so it runs in a fresh one)."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import mtscomp_tpu_torch as mt
        d = sys.argv[1]
        rng = np.random.default_rng(1)
        arr = np.cumsum(rng.normal(0, 5, size=(2000, 129)),
                        axis=0).astype(np.int16)
        arr.tofile(d + '/s.bin')
        mt.compress(d + '/s.bin', d + '/s.cbin', d + '/s.ch',
                    sample_rate=1000.0, n_channels=129, dtype='int16',
                    algorithm='ans', quiet=True, device='cpu',
                    ans_seg_log2=12, check_after_compress=False)
        assert mt.launch_counts()['host_encoded_chunks'] == 0
        r = mt.decompress(d + '/s.cbin', d + '/s.ch', device='cpu',
                          quiet=True)
        assert np.array_equal(r.to_array(), arr)
        assert mt.launch_counts()['host_fallback_chunks'] == 0
        r.close()
        bad = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'mtscomp_tpu')]
        assert not bad, 'loaded %s' % bad
        print('OK')
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop('MTSCOMP_PALLAS_INTERPRET', None)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path_)],
                          cwd=str(tmp_path_), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('OK')


GOLDEN = Path(__file__).resolve().parent / 'golden'


@pytest.mark.parametrize('stem', ['ts_int16_129ch', 'int16_19ch',
                                  'mt_int16_48ch', 'o2_int16_17ch',
                                  'adapt_int16_13ch', 'f32_11ch',
                                  'uint8_7ch'])
def test_golden_files(stem):
    """Every frozen ans file decodes byte-exactly through the port with
    no chunk on the host codec: the ragged-tail artifact on the fuse8
    route, the others (multi-table, order 2, adaptive bit5, bitcast
    float32, uint8) on the generic one."""
    mt.reset_launch_counts()
    rp = mt.decompress(GOLDEN / ('ans_%s.cbin' % stem),
                       GOLDEN / ('ans_%s.ch' % stem), device='cpu',
                       quiet=True)
    try:
        want = np.fromfile(GOLDEN / ('np_%s.bin' % stem),
                           rp.dtype).reshape(-1, rp.n_channels)
        assert np.array_equal(rp.to_array(), want)
        assert np.array_equal(rp.to_tensor().numpy(), want)
        assert mt.launch_counts()['host_fallback_chunks'] == 0
        assert np.array_equal(rp[:], want)           # host windows
    finally:
        rp.close()


def test_mixed_plane_modes_decode_in_mode_uniform_batches(monkeypatch):
    """A run whose plane modes change between chunks (the frozen order-2
    file: chunk 0 codes its high byte CONST, chunks 1 and 2 rANS; chunk
    3 is shorter) decodes on the device one mode-uniform batch at a
    time, where the JAX package sends the run to the host codec."""
    batches = []
    real = tp.DeviceBatchDecoder.decode_tensor

    def spy(self, parsed_list, n_samples):
        batches.append(len(parsed_list))
        return real(self, parsed_list, n_samples)

    monkeypatch.setattr(tp.DeviceBatchDecoder, 'decode_tensor', spy)
    stem = 'o2_int16_17ch'
    rp = mt.decompress(GOLDEN / ('ans_%s.cbin' % stem),
                       GOLDEN / ('ans_%s.ch' % stem), device='cpu',
                       quiet=True)
    try:
        want = np.fromfile(GOLDEN / ('np_%s.bin' % stem),
                           rp.dtype).reshape(-1, rp.n_channels)
        mt.reset_launch_counts()
        assert np.array_equal(rp.to_array(), want)
        assert batches == [1, 2, 1]
        assert mt.launch_counts()['host_fallback_chunks'] == 0
    finally:
        rp.close()
