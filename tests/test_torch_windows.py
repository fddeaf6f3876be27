"""PyTorch port: random-access windows through the device chunk cache.

``Reader[...]`` of an ans file opened on a device (``'cpu'`` here: the
kernels' plain twins) decodes the covering chunks one by one through
``DeviceChunkCache``, keeps them on the device in an LRU, slices there
and copies the window alone to the host. Held, byte for byte (tolerance
0), against numpy indexing of the source, against the port's host route
(``device='none'``) and against the JAX package's reader on its device
route (``device='cpu'``, Pallas in interpret mode), on every layout the
generic decode tests cover plus the fuse8 ones.

On the CPU the wrappers run their twins and count no launch, so "a
cached read decodes nothing" is read from a spy on
``DeviceBatchDecoder.decode_tensor`` (one call per uncached chunk).
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.codec.ans as ans_mod  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

from conftest import (N_SAMPLES, SAMPLE_RATE, make_signal,  # noqa: E402
                      to_int16, write_arr)
from chip_smoke import foreign_quantizer  # noqa: E402
from test_torch_generic import GEOMS, ORDER1, S12  # noqa: E402


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')


def _walk(n, C, seed, std=5.0):
    return np.cumsum(np.random.default_rng(seed).normal(
        0, std, size=(n, C)), axis=0).astype(np.int16)


# Layouts beside the generic tests' (name: source, samples per chunk,
# options, foreign min frequency, route): the fuse8 route with its ragged
# tail (K3) and without (K2), a short last chunk, adaptive windows (bit5)
# and a bitcast float16.
EXTRA = {
    'fuse8_tail': (lambda: _walk(3500, 129, 20), 1000, dict(S12, **ORDER1),
                   None, 'fuse8'),
    'fuse8_uniform': (lambda: _walk(2000, 128, 21), 1000,
                      dict(S12, **ORDER1), None, 'fuse8'),
    'adaptive': (lambda: np.concatenate([
        _walk(3000, 40, 22),
        (2000 * np.sin(np.arange(3000)[:, None] / 150.0
                       + np.arange(40)[None, :])).astype(np.int16)]),
        1000, dict(transform_adapt=2), None, None),
    'float16': (lambda: (_walk(2500, 24, 23) / 64.0).astype(np.float16),
                1000, ORDER1, None, 'generic'),
}
LAYOUTS = dict(GEOMS, **EXTRA)


def _compress(tmp_path, name):
    """Compress layout ``name`` with the port's host codec (the JAX
    package's bytes): (source, .cbin, .ch, samples per chunk)."""
    make, T, opts, min_freq, _route = LAYOUTS[name]
    arr = make()
    path = write_arr(tmp_path / 'w.bin', arr)
    quantize = ans_mod._quantize_rows
    if min_freq is not None:
        ans_mod._quantize_rows = foreign_quantizer(min_freq)
    try:
        mt.compress(path, tmp_path / 'w.cbin', tmp_path / 'w.ch',
                    sample_rate=float(T), n_channels=arr.shape[1],
                    dtype=arr.dtype, algorithm='ans', quiet=True,
                    check_after_compress=False, device='none', **opts)
    finally:
        ans_mod._quantize_rows = quantize
    return arr, tmp_path / 'w.cbin', tmp_path / 'w.ch', T


def _same(got, want):
    """Byte equality, dtype and shape included (NaN-safe for floats)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == np.ascontiguousarray(want).tobytes()


def _windows(ns, T):
    """Inside one chunk, across two and three chunks, first and last
    samples, a step of 3, everything."""
    return [slice(7, 37), slice(T - 5, T + 9), slice(T // 2, ns),
            slice(0, 1), slice(ns - 1, ns), slice(3, ns - 2, 3),
            slice(None)]


@pytest.fixture
def decode_calls(monkeypatch):
    """Chunks per ``decode_tensor`` call, in call order."""
    calls = []
    real = tp.DeviceBatchDecoder.decode_tensor

    def spy(self, parsed_list, n_samples):
        calls.append(len(parsed_list))
        return real(self, parsed_list, n_samples)

    monkeypatch.setattr(tp.DeviceBatchDecoder, 'decode_tensor', spy)
    return calls


@pytest.mark.parametrize('name', sorted(LAYOUTS))
def test_windows_match_numpy_host_route_and_jax(tmp_path, name,
                                                decode_calls):
    arr, cbin, ch, T = _compress(tmp_path, name)
    ns = arr.shape[0]
    mt.reset_launch_counts()
    rp = mt.decompress(cbin, ch, device='cpu', quiet=True, cache_size=8)
    rh = mt.decompress(cbin, ch, device='none', quiet=True)
    rj = ref.decompress(cbin, ch, device='cpu', quiet=True)
    try:
        assert rp._use_device(window=(0, 1)) and rj._use_device(window=(0, 1))
        for k, win in enumerate(_windows(ns, T)):
            got = rp[win]
            _same(got, arr[win])
            _same(got, rh[win])
            if k < 3:       # the JAX device route compiles per layout
                _same(got, rj[win])
            assert got.flags.writeable
        _same(rp[ns // 2], arr[ns // 2])
        _same(rp[-1], arr[-1])
        _same(rp[ns // 2], rj[ns // 2])
        _same(rp[5:T + 5, 3], arr[5:T + 5, 3])
        _same(rp[5:50, 1:9:2], arr[5:50, 1:9:2])
        # One decode_tensor call a chunk, each of one chunk, no more than
        # the file's chunks (the LRU holds them all), none on the host.
        assert decode_calls == [1] * rp.n_chunks
        assert len(rp._dev_cache._cache) == rp.n_chunks
        assert mt.launch_counts()['host_fallback_chunks'] == 0
        # A second pass over every window decodes nothing.
        for win in _windows(ns, T):
            _same(rp[win], arr[win])
        assert len(decode_calls) == rp.n_chunks
    finally:
        rp.close()
        rh.close()
        rj.close()
    assert rp._dev_cache is None            # close() drops the cache


@pytest.fixture(scope='module', params=['zlib-none', 'ans-none', 'ans-cpu'])
def reader_and_arr(request, tmp_path_factory):
    """The indexing oracle's file (tests/test_indexing.py), written by the
    JAX package and read by the port on each route."""
    algorithm, device = request.param.split('-')
    tmp = tmp_path_factory.mktemp('tidx_%s' % request.param)
    arr = to_int16(make_signal('colored'))
    path = write_arr(tmp / 'data.bin', arr)
    ref.compress(path, tmp / 'data.cbin', tmp / 'data.ch',
                 sample_rate=SAMPLE_RATE, n_channels=arr.shape[1],
                 dtype=arr.dtype, algorithm=algorithm, quiet=True,
                 device='none', ans_seg_log2=12)
    r = mt.decompress(tmp / 'data.cbin', tmp / 'data.ch', device=device,
                      quiet=True, cache_size=2)
    yield r, arr
    r.close()


def _check(r, arr, expr):
    try:
        expected = arr[expr]
    except IndexError:
        with pytest.raises(IndexError):
            r[expr]
        return
    _same(r[expr], expected)


def test_slices(reader_and_arr):
    r, arr = reader_and_arr
    ns = arr.shape[0]
    assert ns == N_SAMPLES
    exprs = [slice(None), slice(0, ns), slice(0, 10), slice(0, 10, 2),
             slice(10, 0), slice(5, 5), slice(-10, None), slice(None, -10),
             slice(-100000, 100000), slice(1233, 1235), slice(1234, 2468),
             slice(0, ns, 7), slice(ns - 1, ns), slice(6996, 6997)]
    rng = np.random.default_rng(21)
    for _ in range(150):
        a, b = (int(v) for v in rng.integers(-ns - 10, ns + 10, 2))
        exprs.append(slice(a, b, int(rng.integers(1, 5))))
    for expr in exprs:
        _check(r, arr, expr)


def test_numpy_int_slice_fields(reader_and_arr):
    r, arr = reader_and_arr
    for kind in (np.int8, np.int16, np.int32, np.int64, np.uint8):
        _check(r, arr, slice(kind(10), kind(100), None))


def test_tuples_and_scalars(reader_and_arr):
    r, arr = reader_and_arr
    ns = arr.shape[0]
    for expr in [(slice(None),), (slice(0, 100), slice(None)),
                 (slice(0, 100), slice(2, 7)), (slice(0, 100), 3),
                 (slice(0, 100, 3), slice(None, None, 2)),
                 (50, slice(2, 5)), (50, 3), (-1, -1),
                 0, 1, 100, ns - 1, -1, -10, -ns]:
        _check(r, arr, expr)
    for item in (ns, ns + 100):
        with pytest.raises(IndexError):
            r[item]
    for item in ([1, 2, 3], np.array([1, 2, 3])):
        with pytest.raises(NotImplementedError):
            r[item]


def test_negative_step_takes_the_host_path(reader_and_arr, decode_calls):
    """Only positive steps go through the cache; the others give what the
    host route gives (the reference reader supports positive steps
    only)."""
    r, arr = reader_and_arr
    rh = mt.decompress(r.cdata.name, device='none', quiet=True)
    try:
        for expr in (slice(100, 10, -1), slice(10, 100, -1),
                     slice(None, None, -2)):
            _same(r[expr], rh[expr])
    finally:
        rh.close()
    assert decode_calls == []


def test_lru_evicts_at_cache_size(reader_and_arr, decode_calls):
    r, arr = reader_and_arr
    if not r._use_device():
        _ = r[0:10]
        assert r._dev_cache is None         # zlib, 'none': host LRU only
        assert decode_calls == []
        return
    r._dev_cache = None
    b = r.chunk_bounds
    for idx in (0, 1, 2):
        _same(r[b[idx] + 3:b[idx] + 9], arr[b[idx] + 3:b[idx] + 9])
    cache = r._dev_cache
    assert cache.capacity == r.cache_size == 2
    assert list(cache._cache) == [1, 2]
    assert decode_calls == [1, 1, 1]
    _same(r[b[2] + 1:b[2] + 5], arr[b[2] + 1:b[2] + 5])    # cached
    assert decode_calls == [1, 1, 1]
    _same(r[b[0]:b[0] + 5], arr[b[0]:b[0] + 5])            # evicted: again
    assert decode_calls == [1, 1, 1, 1] and list(cache._cache) == [2, 0]
    # A window over more chunks than the cache holds is still whole.
    _same(r[:], arr)
    assert list(cache._cache) == [r.n_chunks - 2, r.n_chunks - 1]
    assert all(t.device.type == 'cpu' for t, _ in cache._cache.values())


def test_windows_are_fresh_and_writable(reader_and_arr):
    """Mutating a returned window never reaches the cached chunk."""
    r, arr = reader_and_arr
    for expr in (slice(10, 50), slice(1200, 1300), slice(None)):
        win = r[expr]
        assert win.flags.writeable
        win[:] = -1
        _same(r[expr], arr[expr])


def test_numpy_asarray_protocol(reader_and_arr):
    r, arr = reader_and_arr
    _same(np.asarray(r), arr)
    _same(np.asarray(r, dtype=np.int32), arr.astype(np.int32))


@pytest.mark.parametrize('dtype', ['int64', 'uint64', 'float64'])
def test_declined_dtypes_read_through_the_host_path(tmp_path, dtype,
                                                    decode_calls):
    """8-byte dtypes, which the JAX package's ``supported()`` declines
    (`tests/test_device.py`) and the port declined before its int64
    scans, now read through the device chunk cache: one chunk a decode,
    kept in the LRU, no chunk on the host codec, and every window the
    source's and the host route's."""
    arr = (_walk(2500, 12, 30).astype(np.int64) * 3
           + (np.int64(7) << 40)).astype(dtype)
    path = write_arr(tmp_path / 'd.bin', arr)
    mt.compress(path, tmp_path / 'd.cbin', tmp_path / 'd.ch',
                sample_rate=1000.0, n_channels=12, dtype=dtype,
                algorithm='ans', quiet=True, device='none')
    r = mt.decompress(tmp_path / 'd.cbin', tmp_path / 'd.ch', device='cpu',
                      quiet=True)
    host = mt.decompress(tmp_path / 'd.cbin', tmp_path / 'd.ch',
                         device='none', quiet=True)
    try:
        mt.reset_launch_counts()
        _same(r._device_window(10, 20), arr[10:20])
        assert decode_calls == [1]
        _same(tp.DeviceChunkCache(r).read_window(900, 2100), arr[900:2100])
        assert decode_calls == [1] * 4
        for win in (slice(10, 20), slice(900, 2100, 2), slice(None)):
            _same(r[win], arr[win])
            _same(r[win], host[win])
        assert list(r._dev_cache._cache) == [0, 1, 2]
        assert mt.launch_counts()['host_fallback_chunks'] == 0
    finally:
        r.close()
        host.close()


@pytest.mark.parametrize('error', [NotImplementedError, RuntimeError])
def test_an_error_of_the_device_decode_is_not_served_by_the_host(
        tmp_path, monkeypatch, error):
    """Only ``supported()`` sends a window to the host codec: whatever
    the decode itself raises (an operator a device lacks raises
    NotImplementedError) reaches the caller."""
    arr, cbin, ch, T = _compress(tmp_path, 'fuse8_tail')
    r = mt.decompress(cbin, ch, device='cpu', quiet=True)

    def failing(self, parsed_list, n_samples):
        raise error('no kernel for this device')

    try:
        monkeypatch.setattr(tp.DeviceBatchDecoder, 'decode_tensor', failing)
        mt.reset_launch_counts()
        with pytest.raises(error, match='no kernel'):
            r[10:20]
        with pytest.raises(error, match='no kernel'):
            r[T + 5]
        assert mt.launch_counts()['host_fallback_chunks'] == 0
        assert not r._dev_cache._cache
    finally:
        r.close()


def test_window_audit_raises_on_a_corrupt_stream(tmp_path, monkeypatch):
    """A group whose stream lost a word: the window read raises the
    words-used IOError, and nothing is cached."""
    arr, cbin, ch, T = _compress(tmp_path, 'fuse8_tail')
    r = mt.decompress(cbin, ch, device='cpu', quiet=True)
    real = r.codec.parse

    def parse_dropping_a_word(payload):
        parsed = dict(real(payload))
        groups = [dict(g) for g in parsed['groups']]
        groups[0]['words'] = groups[0]['words'][:-1]
        parsed['groups'] = groups
        return parsed

    try:
        monkeypatch.setattr(r.codec, 'parse', parse_dropping_a_word)
        with pytest.raises(IOError, match='payload words'):
            r[10:20]
        assert not r._dev_cache._cache
        monkeypatch.setattr(r.codec, 'parse', real)
        _same(r[10:20], arr[10:20])
    finally:
        r.close()


def test_cache_is_exported_and_takes_a_capacity(tmp_path):
    arr, cbin, ch, T = _compress(tmp_path, 'fuse8_tail')
    assert mt.DeviceChunkCache is tp.DeviceChunkCache
    r = mt.decompress(cbin, ch, device='cpu', quiet=True)
    try:
        cache = mt.DeviceChunkCache(r, capacity=1)
        _same(cache.read_window(T - 3, T + 3), arr[T - 3:T + 3])
        assert list(cache._cache) == [1]
        cache.clear()
        assert not cache._cache
        assert mt.DeviceChunkCache(r).capacity == r.cache_size
    finally:
        r.close()


def test_jax_written_device_file_reads_the_same(tmp_path):
    """A file the JAX package wrote on ITS device route reads through the
    port's windows, and the port's device-written file through the JAX
    package's: same bytes on disk, same windows."""
    arr = _walk(3000, 129, 40)
    path = write_arr(tmp_path / 'x.bin', arr)
    kw = dict(sample_rate=1000.0, n_channels=129, dtype='int16',
              algorithm='ans', quiet=True, device='cpu', ans_seg_log2=12,
              check_after_compress=False, **ORDER1)
    ref.compress(path, tmp_path / 'j.cbin', tmp_path / 'j.ch', **kw)
    mt.compress(path, tmp_path / 't.cbin', tmp_path / 't.ch', **kw)
    assert (tmp_path / 'j.cbin').read_bytes() == \
        (tmp_path / 't.cbin').read_bytes()
    rp = mt.decompress(tmp_path / 'j.cbin', tmp_path / 'j.ch', device='cpu',
                       quiet=True)
    rj = ref.decompress(tmp_path / 't.cbin', tmp_path / 't.ch',
                        device='cpu', quiet=True)
    try:
        for win in _windows(3000, 1000):
            _same(rp[win], arr[win])
            _same(rj[win], arr[win])
    finally:
        rp.close()
        rj.close()
