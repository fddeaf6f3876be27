"""PyTorch port: phase tracing (``utils/trace.py``).

``phase`` is a no-op until tracing is on; on, it counts and times the
phase, logs it at the trace level and opens a
``torch.profiler.record_function`` span. The port's pipeline reports the
JAX package's phase names (``decode.pack`` / ``decode.device`` /
``decode.fetch``, ``encode.transform`` / ``encode.seghist`` /
``encode.kernel`` / ``encode.align``) with the same counts as the JAX
package on the same work, and adds no ``synchronize`` when tracing is
off. The port adds its own spans (``decode.parse`` / ``decode.upload``
/ ``decode.to_host`` / ``decode.assemble``, ``write.*``), span events
with their thread, parent and request, and counters.
"""

import contextvars
import importlib
import logging
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

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
                        if k in DECODE}
        if mod is trace:
            own = {k: v[0] for k, v in mod.phase_stats().items()
                   if k not in DECODE}
        mod.enable_tracing(False)
    assert counts['port'] == dict.fromkeys(DECODE, 3)
    # The JAX package's window cache stages without the phases; its bulk
    # decode reports each once.
    assert counts['jax'] == dict.fromkeys(DECODE, 1)
    # The port's own: the header peek of the bulk decode and each
    # chunk's parse (three in bulk, two in the window), one upload a
    # batch, one fetch of the bulk decode's one batch (returned as it
    # comes: nothing to assemble).
    assert own == {'decode.parse': 6, 'decode.upload': 3,
                   'decode.to_host': 1}


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


def test_two_batches_are_fetched_and_assembled(tmp_path):
    """A bulk decode in two batches fetches each and copies each into
    the result."""
    arr, path, kw = _file(tmp_path)
    mt.compress(path, tmp_path / 't.cbin', tmp_path / 't.ch', device='none',
                **kw)
    trace.enable_tracing()
    trace.reset_stats()
    r = mt.decompress(tmp_path / 't.cbin', tmp_path / 't.ch', device='cpu',
                      batch_chunks=2, quiet=True)
    try:
        assert np.array_equal(r.to_array(), arr)
    finally:
        r.close()
    counts = {k: v[0] for k, v in trace.phase_stats().items()}
    assert counts == {'decode.parse': 4, 'decode.pack': 2,
                      'decode.upload': 2, 'decode.device': 2,
                      'decode.fetch': 2, 'decode.to_host': 2,
                      'decode.assemble': 2}


def _names(events):
    return [e.name for e in events]


@trace.request_scope
def _entry(inner=None):
    with trace.phase('outer'):
        with trace.phase('inner'):
            if inner is not None:
                inner()


def test_events_carry_name_parent_thread_and_request():
    trace.enable_tracing()
    trace.reset_stats()
    _entry()
    _entry(inner=_entry)     # a nested entry keeps its caller's request
    ev = trace.span_events()
    assert _names(ev) == ['inner', 'outer'] * 3
    inner, outer = ev[0], ev[1]
    assert inner.parent == outer.span and outer.parent == 0
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert {e.thread for e in ev} == {threading.get_ident()}
    assert {e.thread_name for e in ev} == {'MainThread'}
    first, second = ev[0].request, ev[2].request
    assert first and second and first != second
    assert [e.request for e in ev] == [first] * 2 + [second] * 4
    # The nested entry's spans open under the outer call's inner span.
    assert ev[2].parent == ev[3].span and ev[3].parent == ev[4].span
    assert ev[4].parent == ev[5].span
    assert len({e.span for e in ev}) == 6
    # Outside an entry point, no request.
    with trace.phase('loose'):
        pass
    assert trace.span_events()[-1].request == 0


def test_worker_threads_inherit_the_request_and_the_parent():
    trace.enable_tracing()
    trace.reset_stats()
    pool = ThreadPoolExecutor(2, thread_name_prefix='worker')

    def work():
        with trace.phase('in.worker'):
            pass

    @trace.request_scope
    def call():
        with trace.phase('submit'):
            pool.submit(contextvars.copy_context().run, work).result(
                timeout=30)

    try:
        call()
    finally:
        pool.shutdown()
    worker, submit = trace.span_events()
    assert (worker.name, submit.name) == ('in.worker', 'submit')
    assert worker.parent == submit.span
    assert worker.request == submit.request != 0
    assert worker.thread != submit.thread
    assert worker.thread_name.startswith('worker')


def test_counters_sum_and_reset_clears_events_and_counters():
    trace.enable_tracing()
    trace.reset_stats()
    trace.count('a', 3)
    trace.count('a', 4)
    trace.count('b')
    with trace.phase('x'):
        pass
    assert trace.counter_stats() == {'a': 7, 'b': 1}
    assert 'a' not in trace.phase_stats()
    assert _names(trace.span_events()) == ['x']
    trace.reset_stats()
    assert trace.counter_stats() == {} and trace.span_events() == []
    assert trace.phase_stats() == {}


def test_off_records_nothing_and_phase_is_the_shared_noop():
    trace.enable_tracing(False)
    trace.reset_stats()
    assert trace.phase('a') is trace.phase('b')
    with trace.phase('a'):
        trace.count('c', 5)
    _entry()
    assert trace.span_events() == [] and trace.counter_stats() == {}
    assert trace.phase_stats() == {}


def test_the_cap_counts_what_is_dropped(monkeypatch):
    monkeypatch.setattr(trace, 'MAX_EVENTS', 3)
    trace.enable_tracing()
    trace.reset_stats()
    for _ in range(5):
        with trace.phase('capped'):
            pass
    assert _names(trace.span_events()) == ['capped'] * 3
    assert trace.counter_stats() == {'trace.dropped_events': 2}
    assert trace.phase_stats()['capped'][0] == 5


def test_threads_lose_no_span_or_count():
    """More threads than cores, switching often: every span and every
    count lands once."""
    trace.enable_tracing()
    trace.reset_stats()
    n_threads, n_spans = 24, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n_spans):
            with trace.phase('busy'):
                trace.count('n')

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_spans
    assert trace.counter_stats() == {'n': total}
    assert trace.phase_stats()['busy'][0] == total
    ev = trace.span_events()
    assert len(ev) == total and len({e.span for e in ev}) == total
    assert len({e.thread for e in ev}) > 1


def test_compress_records_the_writer_s_threads_under_one_request(tmp_path):
    """compress() on the CPU twins: the Writer's spans and the encoder's,
    from the main thread and its prefetch and hasher threads, all under
    the call's request; every reader entry point a request of its own."""
    arr, path, kw = _file(tmp_path, n_chunks=4)
    trace.enable_tracing()
    trace.reset_stats()
    mt.compress(path, tmp_path / 't.cbin', tmp_path / 't.ch', device='cpu',
                n_threads=2, **kw)
    ev = trace.span_events()
    names = set(_names(ev))
    assert {'write.read', 'write.upload', 'write.decide', 'write.assemble',
            'write.writeback', 'write.hash'} | set(ENCODE) <= names
    assert all(n.startswith(('write.', 'encode.')) for n in names)
    threads = {e.thread for e in ev}
    assert len(threads) >= 2
    prefixes = {e.thread_name.split('_')[0] for e in ev}
    assert prefixes == {'MainThread', 'mts-prefetch', 'mts-hasher'}
    assert len({e.request for e in ev}) == 1 and ev[0].request != 0
    write_request = ev[0].request

    trace.reset_stats()
    r = mt.decompress(tmp_path / 't.cbin', tmp_path / 't.ch', device='cpu',
                      quiet=True)
    try:
        r.to_array()
        r[10]
        r.to_tensor()
    finally:
        r.close()
    requests = [e.request for e in trace.span_events()]
    assert len(set(requests)) == 3 and write_request not in requests
    assert requests == sorted(requests)


def test_copies_to_a_card_are_counted_and_host_copies_are_not():
    """``device.to_device`` / ``to_host`` count the bytes that cross to
    or from a card (a ``meta`` tensor stands for one here)."""
    from mtscomp_tpu_torch.device import to_device, to_host
    trace.enable_tracing()
    trace.reset_stats()
    a = np.arange(12, dtype=np.int16)
    assert np.array_equal(to_host(to_device(a, torch.device('cpu'))), a)
    assert trace.counter_stats() == {}
    on_card = to_device(a, torch.device('meta'))
    assert on_card.device.type == 'meta' and on_card.shape == (12,)
    assert trace.counter_stats() == {'transfer.h2d_bytes': 24}
