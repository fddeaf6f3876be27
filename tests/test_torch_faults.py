"""PyTorch port: what a caller of ``mtscomp_tpu`` meets at the port's
entry points, held against the JAX package on the CPU.

- a zlib file compresses, opens and decodes under the default
  configuration on a host with no GPU (the device is resolved once the
  file's algorithm is known), while an ans file still refuses
  ``device='cuda'`` there;
- the ``device`` key takes ``'auto'`` and refuses unknown names with the
  port's own message;
- ``Reader.to_array(writable=...)`` and ``decompress_to_array(out=...,
  writable=...)`` with the JAX package's meaning, and the same bytes;
- ``decode_identity``, ``write_config`` and ``add_default_handler``, the
  port's own copies, give the JAX package's results.

Tolerance 0 everywhere: the decodes are compared byte for byte.
"""

import json
import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu  # noqa: E402
import mtscomp_tpu.config as ref_config  # noqa: E402
from mtscomp_tpu.format import decode_identity as ref_identity  # noqa: E402
from mtscomp_tpu.utils.misc import (  # noqa: E402
    add_default_handler as ref_add_handler)

import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch import format as mt_format  # noqa: E402
from mtscomp_tpu_torch.device import (  # noqa: E402
    configured_device, resolve_device)
from mtscomp_tpu_torch.utils import misc as mt_misc  # noqa: E402

from conftest import write_arr  # noqa: E402

T, C, N = 300, 40, 4


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A directory that also holds both packages' user config files."""
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setattr(ref_config, 'CONFIG_PATH', tmp_path / '.mtscomp_ref')
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    return tmp_path


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def _source(seed=3, n=N):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 5.0, size=(n * T, C)),
                     axis=0).astype(np.int16)


def _compress(workdir, arr, algorithm, **kw):
    """Compress ``arr`` with the port; the paths of the pair."""
    raw = write_arr(workdir / 'p.bin', arr)
    kw.setdefault('check_after_compress', False)
    mt.compress(raw, workdir / 'p.cbin', workdir / 'p.ch',
                sample_rate=float(T), n_channels=C, dtype=arr.dtype,
                algorithm=algorithm, quiet=True, **kw)
    return workdir / 'p.cbin', workdir / 'p.ch'


# --- the device is resolved once the algorithm is known -------------------

def test_zlib_file_needs_no_gpu_under_the_default_config(workdir, no_gpu):
    assert dict(mt_config.DEFAULT_CONFIG)['device'] == 'cuda'
    arr = _source()
    # The default configuration all the way: device 'cuda', the automatic
    # check after compressing.
    cbin, ch = _compress(workdir, arr, 'zlib', check_after_compress=True)
    r = mt.decompress(cbin, ch, quiet=True)
    try:
        assert r.algorithm == 'zlib' and r.device is None
        assert np.array_equal(r.to_array(), arr)
        assert np.array_equal(r[10:700], arr[10:700])
        r.tofile(workdir / 'back.bin')
        assert np.array_equal(
            np.fromfile(workdir / 'back.bin', np.int16).reshape(arr.shape),
            arr)
        # to_tensor resolves the device when it is called.
        with pytest.raises(RuntimeError, match='no CUDA GPU'):
            r.to_tensor()
    finally:
        r.close()
    r = mt.decompress(cbin, ch, quiet=True, device='cpu')
    try:
        t = r.to_tensor()
        assert t.device.type == 'cpu' and np.array_equal(t.numpy(), arr)
    finally:
        r.close()


def test_ans_file_still_refuses_cuda_without_a_gpu(workdir, no_gpu):
    cbin, ch = _compress(workdir, _source(), 'ans', device='none')
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        mt.decompress(cbin, ch, quiet=True)
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        mt.Reader(device='cuda:0', quiet=True).open(cbin, ch)
    # The constructor alone does not know the algorithm yet.
    assert mt.Reader(quiet=True).device is None


# --- the device key: 'auto', and unknown names -----------------------------

def test_config_file_with_auto_opens(workdir, no_gpu):
    arr = _source()
    cbin, ch = _compress(workdir, arr, 'ans', device='none')
    mt_config.CONFIG_PATH.write_text(json.dumps({'device': 'auto'}))
    assert mt_config.read_config().device == 'auto'
    # No GPU: 'auto' is the host codec.
    r = mt.decompress(cbin, ch, quiet=True)
    try:
        assert r.device is None
        assert np.array_equal(r.to_array(), arr)
    finally:
        r.close()
    w = mt.Writer(algorithm='ans', quiet=True)
    assert w.device is None
    w.close()


def test_auto_is_cuda_where_a_gpu_is_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert configured_device('auto') == torch.device('cuda')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert configured_device('auto') is None
    assert configured_device('none') is None
    assert configured_device('cpu') == torch.device('cpu')
    # 'auto' is no fallback for an explicit 'cuda'.
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        configured_device('cuda')


@pytest.mark.parametrize('name', ['tpu', 'gpu0', 'gpu', 'cuda0', 'cuda:',
                                  'meta', 'mps', ''])
def test_unknown_device_names_are_refused(workdir, name):
    with pytest.raises(ValueError, match="'cuda'.*'cpu'.*'none'.*'auto'"):
        resolve_device(name)
    with pytest.raises(ValueError, match="'auto'"):
        configured_device(name)


def test_config_file_with_tpu_says_what_to_write(workdir, no_gpu):
    cbin, ch = _compress(workdir, _source(), 'ans', device='none')
    mt_config.CONFIG_PATH.write_text(json.dumps({'device': 'tpu'}))
    with pytest.raises(ValueError, match="unknown device 'tpu'.*'auto'"):
        mt.decompress(cbin, ch, quiet=True)
    with pytest.raises(ValueError, match="unknown device 'tpu'"):
        mt.Writer(algorithm='ans', quiet=True)


def test_resolve_device_takes_names_and_devices():
    assert resolve_device('cpu') == torch.device('cpu')
    assert resolve_device(torch.device('cpu')) == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_device(torch.device('meta'))
    with pytest.raises(ValueError):
        resolve_device(0)


# --- to_array / decompress_to_array signatures -----------------------------

@pytest.fixture
def pair(workdir):
    """(source, port reader on the twins, JAX-package reader) of one ans
    container."""
    arr = _source(seed=5)
    cbin, ch = _compress(workdir, arr, 'ans', device='none')
    r = mt.decompress(cbin, ch, quiet=True, device='cpu')
    ref = mtscomp_tpu.decompress(cbin, ch, quiet=True)
    yield arr, r, ref
    r.close()
    ref.close()


@pytest.mark.parametrize('span', [(0, None), (1, 2), (3, 3)])
@pytest.mark.parametrize('writable', [True, False])
def test_to_array_writable_matches_the_reference(pair, span, writable):
    arr, r, ref = pair
    first, last = span
    want = ref.to_array(first, last, writable=writable)
    got = r.to_array(first, last, writable=writable)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    stop = r.chunk_bounds[(r.n_chunks - 1 if last is None else last) + 1]
    assert np.array_equal(got, arr[r.chunk_bounds[first]:stop])
    if writable:
        assert got.flags.writeable
        got[0, 0] += 1                      # and it really is


@pytest.mark.parametrize('span', [(0, None), (1, 2)])
def test_decompress_to_array_out_matches_the_reference(pair, span):
    arr, r, ref = pair
    first, last = span
    want = ref.to_array(first, last)
    out = np.full(want.shape, -1, dtype=arr.dtype)
    got = mt.decompress_to_array(r, first, last, out=out, device='cpu')
    assert got is out and np.array_equal(out, want)
    out2 = np.empty_like(out)
    got = mt.decompress_to_array(r, first, last, out2, False, device='cpu')
    assert got is out2 and np.array_equal(out2, want)
    from mtscomp_tpu.parallel.pipeline import (
        decompress_to_array as ref_to_array)
    out3 = np.empty_like(out)
    assert ref_to_array(ref, first, last, out=out3) is out3
    assert np.array_equal(out3, out)


@pytest.mark.parametrize('bad', [
    lambda s: np.empty((s[0] + 1, s[1]), np.int16),
    lambda s: np.empty((s[0], s[1] - 1), np.int16),
    lambda s: np.empty(s, np.int32),
    lambda s: np.empty(s[0] * s[1], np.int16),
    lambda s: [[0] * s[1]] * s[0],
])
def test_decompress_to_array_rejects_a_wrong_out(pair, bad):
    _arr, r, _ref = pair
    with pytest.raises(ValueError, match='out must be'):
        mt.decompress_to_array(r, 0, None, out=bad(r.shape), device='cpu')


def test_tofile_takes_the_read_only_route(pair, workdir, monkeypatch):
    arr, r, _ref = pair
    seen = []
    to_array = r.to_array
    monkeypatch.setattr(r, 'to_array', lambda *a, **kw: (
        seen.append(kw.get('writable')), to_array(*a, **kw))[1])
    r.tofile(workdir / 'back.bin')
    assert seen and set(seen) == {False}
    assert np.array_equal(
        np.fromfile(workdir / 'back.bin', np.int16).reshape(arr.shape), arr)


# --- the three copied functions --------------------------------------------

IDENTITY_CASES = [
    {'algorithm': 'ans', 'dtype': 'int16', 'n_channels': 385},
    {'algorithm': 'zlib', 'dtype': '<i2', 'n_channels': 4.0,
     'chunk_order': 'C', 'do_time_diff': 0, 'do_spatial_diff': 1,
     'time_diff_order': None, 'float_bitcast': 0},
    {'algorithm': 'ans', 'dtype': np.float32, 'n_channels': '7',
     'time_diff_order': 2, 'float_bitcast': True,
     'ans_seg_log2': 12, 'ans_table_mode': 'plane'},
]


@pytest.mark.parametrize('cmeta', IDENTITY_CASES)
def test_decode_identity_matches_the_reference(cmeta):
    got = mt_format.decode_identity(cmeta)
    assert got == ref_identity(cmeta)
    assert tuple(got) == mt_format.DECODE_IDENTITY_KEYS
    assert got == mt_format.decode_identity(mt_misc.Bunch(cmeta))


def test_decode_identity_of_a_written_sidecar(workdir):
    _cbin, ch = _compress(workdir, _source(), 'ans', device='none')
    cmeta = mt_format.read_cmeta(ch)
    assert mt_format.decode_identity(cmeta) == ref_identity(cmeta)


def test_write_config_matches_the_reference(workdir):
    kw = {'algorithm': 'ans', 'n_threads': 3, 'cache_size': None}
    got = mt_config.write_config(**kw)
    want = ref_config.write_config(**kw)
    assert got.algorithm == 'ans' and got.n_threads == 3
    a = json.loads(mt_config.CONFIG_PATH.read_text())
    b = json.loads(ref_config.CONFIG_PATH.read_text())
    assert a == dict(got) and b == dict(want)
    # The same keys; the values differ where the defaults do (the device).
    assert set(a) == set(b)
    assert {k for k in a if a[k] != b[k]} == {'device'}
    # Same layout on disk: indented, sorted keys.
    assert mt_config.CONFIG_PATH.read_text() == json.dumps(
        a, indent=2, sort_keys=True)
    # And the file is read back as the new defaults.
    assert mt_config.read_config().n_threads == 3
    assert mt_config.read_config(n_threads=5).n_threads == 5


@pytest.mark.parametrize('level', ['DEBUG', 'INFO', 'WARNING',
                                   logging.ERROR])
def test_add_default_handler_matches_the_reference(level):
    def run(add, name):
        lg = logging.getLogger(name)
        lg.setLevel(logging.INFO)
        h = add(level, logger=lg)
        try:
            rec = logging.LogRecord(name, logging.WARNING, '/x/mod.py', 12,
                                    'hello %s', ('you',), None)
            rec.created, rec.msecs = 0.0, 7.0
            text = h.format(rec)
            # The shared record is left as it was.
            assert rec.levelname == 'WARNING'
            return (h.level, lg.level, type(h).__name__, text,
                    h in lg.handlers)
        finally:
            lg.removeHandler(h)

    got = run(mt_misc.add_default_handler, 'mtscomp_faults_port')
    want = run(ref_add_handler, 'mtscomp_faults_ref')
    assert got == want
    assert '[W] mod:12' in got[3] and got[3].endswith('hello you\33[0m')


def test_add_default_handler_defaults_to_the_package_logger():
    h = mt.add_default_handler('WARNING')
    try:
        assert h in mt_misc.logger.handlers
        assert mt_misc.logger.name == 'mtscomp_tpu_torch'
    finally:
        mt_misc.logger.removeHandler(h)


# --- bounded decode batches -------------------------------------------------

from mtscomp_tpu_torch.parallel import pipeline as mt_pipeline  # noqa: E402


@pytest.fixture
def decode_calls(monkeypatch):
    """Chunks per device decode of the port (``_decode_shards``, which
    ``decode_tensor`` and ``decode_batch`` call), in call order."""
    calls = []
    real = mt_pipeline.DeviceBatchDecoder._decode_shards

    def spy(self, parsed_list, n_samples, mesh=None):
        calls.append(len(parsed_list))
        return real(self, parsed_list, n_samples, mesh)

    monkeypatch.setattr(mt_pipeline.DeviceBatchDecoder, '_decode_shards', spy)
    return calls


def _ten_chunks(workdir):
    arr = _source(seed=8, n=10)
    cbin, ch = _compress(workdir, arr, 'ans', device='none')
    return arr, cbin, ch


BULK_CALLS = {
    'to_array': lambda rs: [rs[0].to_array()],
    'to_array_span': lambda rs: [rs[0].to_array(0, rs[0].n_chunks - 1)],
    'to_tensor': lambda rs: [rs[0].to_tensor().numpy()],
    'decompress_to_array_out': lambda rs: [mt.decompress_to_array(
        rs[0], out=np.empty(rs[0].shape, rs[0].dtype), device='cpu')],
    'decompress_multi_one_probe': lambda rs: mt.decompress_multi(rs[:1]),
    'decompress_multi_two_probes': lambda rs: mt.decompress_multi(rs),
}


@pytest.mark.parametrize('call', sorted(BULK_CALLS))
def test_batch_chunks_bounds_every_decode_batch(workdir, decode_calls, call):
    """``batch_chunks=4``: a 10-chunk file decodes in batches of 4, 4 and
    2 chunks (two probes: 2 chunks of each a batch), and gives the bytes
    of the one-batch call."""
    arr, cbin, ch = _ten_chunks(workdir)

    def run(**kw):
        readers = [mt.decompress(cbin, ch, device='cpu', quiet=True, **kw)
                   for _ in range(2)]
        del decode_calls[:]
        try:
            return BULK_CALLS[call](readers), list(decode_calls)
        finally:
            for r in readers:
                r.close()

    whole, calls = run()
    assert calls == [20 if call.endswith('two_probes') else 10]
    bounded, calls = run(batch_chunks=4)
    assert calls == ([4] * 5 if call.endswith('two_probes') else [4, 4, 2])
    assert len(bounded) == len(whole)
    for got, want in zip(bounded, whole):
        assert got.dtype == want.dtype == arr.dtype
        assert got.tobytes() == want.tobytes() == arr.tobytes()


@pytest.mark.parametrize('call', ['to_array', 'to_tensor',
                                  'decompress_multi_two_probes'])
def test_default_bound_cuts_a_run_by_decoded_bytes(workdir, decode_calls,
                                                   monkeypatch, call):
    """No ``batch_chunks``: a batch holds as many chunks as decode to
    ``DECODE_BATCH_BYTES``, at least one."""
    arr, cbin, ch = _ten_chunks(workdir)
    chunk_bytes = T * C * 2
    assert mt_pipeline.DECODE_BATCH_BYTES == 1 << 30
    # The bound that keeps a 32-chunk batch of 1-s 385-channel int16
    # chunks whole.
    assert mt_pipeline.DECODE_BATCH_BYTES // (30000 * 385 * 2) >= 32
    readers = [mt.decompress(cbin, ch, device='cpu', quiet=True)
               for _ in range(2)]
    try:
        for bound, want in ((3 * chunk_bytes + 5, [3, 3, 3, 1]),
                            (chunk_bytes - 1, [1] * 10)):
            monkeypatch.setattr(mt_pipeline, 'DECODE_BATCH_BYTES', bound)
            assert mt_pipeline.batch_limit(readers[0], T) == want[0]
            del decode_calls[:]
            outs = BULK_CALLS[call](readers)
            if call.endswith('two_probes'):
                per = max(1, want[0] // 2)
                assert decode_calls == [2 * per] * (10 // per)
            else:
                assert decode_calls == want
            for got in outs:
                assert got.tobytes() == arr.tobytes()
    finally:
        for r in readers:
            r.close()


def test_tofile_keeps_its_own_batching(workdir, decode_calls):
    """``tofile`` cuts the file by ``batch_chunks`` itself: each of its
    spans is then one batch."""
    arr, cbin, ch = _ten_chunks(workdir)
    r = mt.decompress(cbin, ch, device='cpu', quiet=True, batch_chunks=4,
                      check_after_decompress=False)
    try:
        r.tofile(workdir / 'o.bin')
        assert decode_calls == [4, 4, 2]
        assert (workdir / 'o.bin').read_bytes() == arr.tobytes()
    finally:
        r.close()


@pytest.mark.parametrize('writable', [True, False])
def test_one_block_span_is_returned_without_a_copy(workdir, decode_calls,
                                                   writable):
    """A span that decodes as one batch comes back as the fetched buffer
    itself (its memory is the fetched tensor's, not a destination
    allocated here); a span cut in batches lands in one destination."""
    arr, cbin, ch = _ten_chunks(workdir)

    def root(a):
        return a if a.base is None else a.base

    r = mt.decompress(cbin, ch, device='cpu', quiet=True)
    try:
        got = r.to_array(writable=writable)
        assert decode_calls == [10] and got.flags.writeable
        assert not root(got).flags.owndata       # the tensor's storage
        assert np.array_equal(got, arr)
    finally:
        r.close()
    r = mt.decompress(cbin, ch, device='cpu', quiet=True, batch_chunks=4)
    try:
        got = r.to_array(writable=writable)
        assert root(got).flags.owndata and got.flags.writeable
        assert np.array_equal(got, arr)
    finally:
        r.close()


# --- StreamReader: the configured device, one chunk cache for the tail -----

def _live(workdir, arr, n):
    """A live ans stream of ``arr``'s first ``n`` samples (its writer is
    returned open)."""
    w = mt.StreamWriter(workdir / 'live.cbin', workdir / 'live.ch',
                        sample_rate=float(T), n_channels=C, dtype='int16',
                        algorithm='ans', live_sidecar=True)
    w.append(arr[:n])
    return w


def test_stream_reader_reads_on_the_configured_device(workdir, decode_calls):
    """With no device named, the tail's snapshots open on the configured
    one (the JAX package's rule) and its windows decode through the
    device chunk cache: one ``decode_tensor`` call a chunk."""
    mt_config.CONFIG_PATH.write_text(json.dumps({'device': 'cpu'}))
    arr = _source(seed=5)
    w = _live(workdir, arr, 2 * T)
    t = mt.StreamReader(workdir / 'live.cbin', workdir / 'live.ch')
    try:
        assert t._reader.device == torch.device('cpu')
        assert np.array_equal(t[10:T + 40], arr[10:T + 40])
        assert decode_calls == [1, 1]
    finally:
        t.close()
        w.close()


def test_stream_reader_keeps_its_chunk_cache_across_snapshots(
        workdir, decode_calls):
    """A published chunk is decoded once for the life of the tail: the
    next snapshot takes over the cache and decodes only new chunks."""
    arr = _source(seed=6)
    w = _live(workdir, arr, 2 * T)
    t = mt.StreamReader(workdir / 'live.cbin', workdir / 'live.ch',
                        device='cpu')
    try:
        assert np.array_equal(t[5:2 * T], arr[5:2 * T])
        assert decode_calls == [1, 1]
        cache = t._reader._dev_cache
        w.append(arr[2 * T:3 * T + 17])
        assert t.refresh() and t.n_samples == 3 * T
        assert t._reader._dev_cache is cache and cache.reader is t._reader
        assert np.array_equal(t[T:3 * T], arr[T:3 * T])
        assert decode_calls == [1, 1, 1]
        w.close()
        assert t.refresh() and t.finalized
        assert np.array_equal(t[:], arr[:3 * T + 17])
    finally:
        t.close()


def test_stream_reader_drops_chunks_a_new_stream_rewrote(workdir,
                                                         decode_calls):
    """A stream written anew at the same path keeps the geometry but not
    the bytes: the cached chunks are dropped and decoded again."""
    first, second = _source(seed=7), _source(seed=9)
    w = _live(workdir, first, 2 * T)
    t = mt.StreamReader(workdir / 'live.cbin', workdir / 'live.ch',
                        device='cpu')
    try:
        assert np.array_equal(t[:2 * T], first[:2 * T])
        w.close()
        w = _live(workdir, second, 3 * T)
        assert t.refresh() and t.n_samples == 3 * T
        assert np.array_equal(t[:3 * T], second[:3 * T])
        assert decode_calls == [1] * 5
    finally:
        t.close()
        w.close()
