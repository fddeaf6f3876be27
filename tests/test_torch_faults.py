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
