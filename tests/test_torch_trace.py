"""PyTorch port: phase tracing (``utils/trace.py``).

``phase`` is a no-op until tracing is on; on, it counts and times the
phase, logs it at the trace level and opens a
``torch.profiler.record_function`` span. The port's pipeline reports the
JAX package's phase names (``decode.pack`` / ``decode.device`` /
``decode.fetch``, ``encode.transform`` / ``encode.seghist`` /
``encode.kernel`` / ``encode.align``) with the same counts as the JAX
package on the same work, and adds no ``synchronize`` when tracing is
off.
"""

import importlib
import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
from mtscomp_tpu.utils import trace as ref_trace  # noqa: E402
import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch.utils import misc as mt_misc  # noqa: E402
from mtscomp_tpu_torch.utils import trace  # noqa: E402

from conftest import write_arr  # noqa: E402

DECODE = ('decode.pack', 'decode.device', 'decode.fetch')
ENCODE = ('encode.transform', 'encode.seghist', 'encode.kernel',
          'encode.align')


@pytest.fixture(autouse=True)
def _tracing_off_again(tmp_path, monkeypatch):
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    level = mt_misc.logger.level
    ref_level = logging.getLogger('mtscomp_tpu').level
    yield
    for mod in (trace, ref_trace):
        mod.enable_tracing(False)
        mod.reset_stats()
    mt_misc.logger.setLevel(level)
    logging.getLogger('mtscomp_tpu').setLevel(ref_level)


def _file(tmp_path, n_chunks=3, C=129):
    arr = np.cumsum(np.random.default_rng(1).normal(
        0, 5, size=(n_chunks * 1000, C)), axis=0).astype(np.int16)
    path = write_arr(tmp_path / 't.bin', arr)
    return arr, path, dict(sample_rate=1000.0, n_channels=C, dtype='int16',
                           algorithm='ans', quiet=True, ans_seg_log2=12,
                           check_after_compress=False)


def test_public_names_are_the_reference_s():
    for name in ('enable_tracing', 'reset_stats', 'phase_stats', 'phase'):
        assert callable(getattr(trace, name))
        assert callable(getattr(ref_trace, name))
    assert trace.TRACE == 5


def test_phase_is_a_noop_until_enabled():
    trace.reset_stats()
    with trace.phase('x'):
        pass
    assert trace.phase_stats() == {}
    trace.enable_tracing()
    with trace.phase('x'):
        pass
    with trace.phase('x'):
        pass
    with trace.phase('y'):
        pass
    stats = trace.phase_stats()
    assert {k: v[0] for k, v in stats.items()} == {'x': 2, 'y': 1}
    assert all(v[1] >= 0 for v in stats.values())
    trace.reset_stats()
    assert trace.phase_stats() == {}
    trace.enable_tracing(False)
    with trace.phase('x'):
        pass
    assert trace.phase_stats() == {}


def test_phase_counts_a_raising_body_and_lets_it_raise():
    trace.enable_tracing()
    trace.reset_stats()
    with pytest.raises(KeyError):
        with trace.phase('boom'):
            raise KeyError('x')
    assert trace.phase_stats()['boom'][0] == 1


def test_phase_logs_at_the_trace_level(caplog):
    trace.enable_tracing()
    assert mt_misc.logger.getEffectiveLevel() <= trace.TRACE
    with caplog.at_level(trace.TRACE, logger='mtscomp_tpu_torch'):
        with trace.phase('logged.phase'):
            pass
    assert any('phase logged.phase' in r.getMessage()
               and r.levelno == trace.TRACE for r in caplog.records)


def test_phase_opens_a_profiler_span():
    trace.enable_tracing()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.phase('span.in.profile'):
            torch.ones(8).sum()
    assert 'span.in.profile' in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize('value,on', [('1', True), ('yes', True),
                                      ('0', False), ('', False)])
def test_env_var_enables_tracing(monkeypatch, value, on):
    monkeypatch.setenv('MTSCOMP_TRACE', value)
    try:
        assert importlib.reload(trace)._enabled is on
    finally:
        monkeypatch.delenv('MTSCOMP_TRACE')
        importlib.reload(trace)
    assert trace._enabled is False


def test_decode_phases_match_the_reference_s_counts(tmp_path):
    """to_array of a 3-chunk file (one batch) and a window over two
    chunks (two batches of one): the same phase counts in both
    packages."""
    arr, path, kw = _file(tmp_path)
    mt.compress(path, tmp_path / 't.cbin', tmp_path / 't.ch', device='none',
                **kw)
    counts = {}
    for name, pkg, mod in (('port', mt, trace), ('jax', ref, ref_trace)):
        mod.enable_tracing()
        mod.reset_stats()
        r = pkg.decompress(tmp_path / 't.cbin', tmp_path / 't.ch',
                           device='cpu', quiet=True)
        try:
            assert np.array_equal(r.to_array(), arr)
            assert np.array_equal(r[900:1100], arr[900:1100])
        finally:
            r.close()
        counts[name] = {k: v[0] for k, v in mod.phase_stats().items()
                        if k.startswith('decode.')}
        mod.enable_tracing(False)
    assert counts['port'] == dict.fromkeys(DECODE, 3)
    # The JAX package's window cache stages without the phases; its bulk
    # decode reports each once.
    assert counts['jax'] == dict.fromkeys(DECODE, 1)


def test_encode_phases_match_the_reference_s_names(tmp_path):
    arr, path, kw = _file(tmp_path, n_chunks=4)
    names = {}
    for name, pkg, mod in (('port', mt, trace), ('jax', ref, ref_trace)):
        mod.enable_tracing()
        mod.reset_stats()
        pkg.compress(path, tmp_path / (name + '.cbin'),
                     tmp_path / (name + '.ch'), device='cpu', n_threads=4,
                     **kw)
        names[name] = {k: v[0] for k, v in mod.phase_stats().items()
                       if k.startswith('encode.')}
        mod.enable_tracing(False)
    assert (tmp_path / 'port.cbin').read_bytes() == \
        (tmp_path / 'jax.cbin').read_bytes()
    assert set(names['port']) == set(ENCODE)
    assert names['port'] == names['jax']


def test_no_synchronize_is_added(tmp_path, monkeypatch):
    """Neither with tracing off nor on does a phase synchronize the
    device (the decode's one wait is the fetch of the word counts)."""
    arr, path, kw = _file(tmp_path)
    mt.compress(path, tmp_path / 't.cbin', tmp_path / 't.ch', device='none',
                **kw)
    calls = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda *a, **k: calls.append(a))
    for on in (False, True):
        trace.enable_tracing(on)
        r = mt.decompress(tmp_path / 't.cbin', tmp_path / 't.ch',
                          device='cpu', quiet=True)
        try:
            assert np.array_equal(r.to_array(), arr)
            assert np.array_equal(r[10:20], arr[10:20])
        finally:
            r.close()
        mt.compress(path, tmp_path / 'u.cbin', tmp_path / 'u.ch',
                    device='cpu', **kw)
    assert calls == []
    assert set(DECODE + ENCODE) <= set(trace.phase_stats())
