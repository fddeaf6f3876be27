"""The program's spans and counters as the benchmark reads them: the
clock mapping onto the device trace, the idle time no span covers, the
readers of the new per-layer metrics, and the cell that decodes onto
the device (on the CPU, at a tiny size, the kernels' plain twins
standing in for the card)."""

import contextvars
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from mtscomp_tpu_torch.utils import trace
from portbench import progspans
from portbench.devtrace import Trace
from portbench.run import Run, load_cell, metric_reader, run_cell

SPAN_METRICS = {
    'read.parse_s_per_gb': 'decode.parse',
    'read.upload_s_per_gb': 'decode.upload',
    'read.to_host_s_per_gb': 'decode.to_host',
    'read.assemble_s_per_gb': 'decode.assemble',
    'write.read_s_per_gb': 'write.read',
    'write.upload_s_per_gb': 'write.upload',
    'write.decide_s_per_gb': 'write.decide',
    'write.assemble_s_per_gb': 'write.assemble',
    'write.writeback_s_per_gb': 'write.writeback',
    'write.hash_s_per_gb': 'write.hash',
}


@pytest.fixture(autouse=True)
def _tracing_off_again():
    yield
    trace.enable_tracing(False)
    trace.reset_stats()


def _run(calls, spans=None, tr=None):
    return Run(calls, calls[0][0] if calls else 0.0, setup_s=1.0, ratio=3.0,
               spans=spans, trace=tr)


def _event(cat, name, ts_us, dur_us):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts_us, 'dur': dur_us}


def _span(name, start_s, end_s, thread='MainThread'):
    return trace.SpanEvent(name, int(round(start_s * 1e9)),
                           int(round(end_s * 1e9)), 1, thread, 1, 0, 1)


# Two calls at perf_counter 10.0-10.001 and 20.0-20.001; in the trace
# (microseconds) they start 1000 s later. The device is busy 10-30 us
# into each call, and 60-70 us into the second.
CALLS = [(10.0, 10.0001, 1e9, 2.5e8), (20.0, 20.0001, 1e9, 2.5e8)]


def _trace():
    base = 1000e6
    return Trace([
        _event('user_annotation', 'portbench.to_array', base + 10e6, 100),
        _event('user_annotation', 'portbench.to_array', base + 20e6, 100),
        _event('kernel', 'k1', base + 10e6 + 10, 20),
        _event('kernel', 'k1', base + 20e6 + 10, 20),
        _event('gpu_memcpy', 'Memcpy DtoH', base + 20e6 + 60, 10),
    ])


def test_the_offset_is_the_median_over_the_calls():
    run = _run(CALLS, tr=_trace())
    assert progspans.clock_offset(run) == pytest.approx(1000.0)
    # A call the trace holds and the run does not (a failed one): no
    # offset, and nothing placed on the clock.
    assert progspans.clock_offset(_run(CALLS[:1], tr=_trace())) is None
    assert progspans.mapped_spans(_run(CALLS[:1], tr=_trace()), []) is None


def test_unspanned_idle_from_spans_of_every_thread():
    run = _run(CALLS, tr=_trace())
    # Idle in the window: 0-10 and 30-100 us into the first call, the
    # 10 s between the calls, 0-10, 30-60 and 70-100 us into the second.
    events = [
        # 0-30 us into the first call on the main thread, 50-100 us in
        # a worker: 30-50 us stays dark.
        _span('decode.parse', 10.0, 10.00003),
        _span('write.hash', 10.00005, 10.0001, 'mts-hasher_0'),
        # All of the gap between the calls in a worker, and all of the
        # second call but its first 10 us.
        _span('write.read', 10.0001, 20.0, 'mts-prefetch_0'),
        _span('decode.pack', 20.00001, 20.0001),
    ]
    dark = 20e-6 + 10e-6
    idle = (10e-6 + 70e-6) + (10.0 - 100e-6) + (10e-6 + 30e-6 + 30e-6)
    got = progspans.unspanned_idle_pct(run, events)
    assert got == pytest.approx(100 * dark / idle)
    assert progspans.unspanned_idle_pct(run, []) == pytest.approx(100.0)
    by = progspans.idle_by_thread(run, events)
    assert set(by) == {'MainThread', 'mts-hasher', 'mts-prefetch'}
    assert dict(by['mts-prefetch'])['write.read'] == pytest.approx(
        10.0 - 100e-6)
    assert dict(by['MainThread'])['decode.parse'] == pytest.approx(10e-6)
    assert progspans.thread_group('mts-hasher_12') == 'mts-hasher'
    assert progspans.thread_group('MainThread') == 'MainThread'


def test_the_idle_readers_read_the_program_s_events(monkeypatch):
    run = _run(CALLS, tr=_trace())
    trace.enable_tracing()
    trace.reset_stats()
    monkeypatch.setattr(trace, 'span_events', lambda: [
        _span('decode.parse', 10.0, 20.0)])
    for name in ('read.unspanned_idle_pct', 'write.unspanned_idle_pct'):
        assert metric_reader(name)(run) == pytest.approx(
            100 * (10e-6 + 30e-6 + 30e-6)
            / (80e-6 + 10.0 - 100e-6 + 70e-6))
    # No device operation, or no trace: nothing to read.
    empty = Trace([_event('user_annotation', 'portbench.to_array', 0, 9)])
    assert metric_reader('read.unspanned_idle_pct')(
        _run(CALLS[:1], tr=empty)) is None
    assert metric_reader('write.unspanned_idle_pct')(_run(CALLS)) is None


def test_a_program_without_events_or_counters_reads_nothing(monkeypatch):
    monkeypatch.delattr(trace, 'span_events')
    run = _run(CALLS, spans={}, tr=_trace())
    assert progspans.program() is None
    for name in ('read.unspanned_idle_pct', 'write.transfer_bytes_per_byte',
                 'read.transfer_bytes_per_byte'):
        assert metric_reader(name)(run) is None


def test_span_metrics_per_gb():
    spans = {span: (3, 0.1 * (i + 1))
             for i, span in enumerate(SPAN_METRICS.values())}
    run = _run([(0.0, 1.0, 4e9, 1e9)], spans=spans)
    for i, name in enumerate(SPAN_METRICS):
        assert metric_reader(name)(run) == pytest.approx(
            0.1 * (i + 1) / 4), name
        # A span that never opened, or an untraced run: nothing.
        assert metric_reader(name)(_run(run.calls, spans={})) is None
        assert metric_reader(name)(_run(run.calls)) is None


def test_transfer_bytes_per_byte():
    run = _run([(0.0, 1.0, 4e9, 1e9)])
    trace.enable_tracing()
    trace.reset_stats()
    for name in ('read.transfer_bytes_per_byte',
                 'write.transfer_bytes_per_byte'):
        assert metric_reader(name)(run) is None
    trace.count('transfer.h2d_bytes', 3e9)
    trace.count('transfer.d2h_bytes', 5e9)
    trace.count('trace.dropped_events', 7)
    for name in ('read.transfer_bytes_per_byte',
                 'write.transfer_bytes_per_byte'):
        assert metric_reader(name)(run) == pytest.approx(2.0)


def test_a_worker_span_lands_inside_its_main_thread_span(tmp_path):
    """A real CPU profiler trace: the span a worker thread opened (which
    the profiler does not record) is placed inside the main thread's
    span it ran under, within 1 ms at either edge."""
    trace.enable_tracing()
    trace.reset_stats()
    pool = ThreadPoolExecutor(1, thread_name_prefix='worker')

    def work():
        with trace.phase('worker.span'):
            time.sleep(0.02)

    calls = []
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                s = time.perf_counter()
                with torch.profiler.record_function('portbench.to_array'):
                    with trace.phase('main.span'):
                        time.sleep(0.005)
                        pool.submit(contextvars.copy_context().run,
                                    work).result(timeout=30)
                        time.sleep(0.005)
                calls.append((s, time.perf_counter(), 1, 1))
    finally:
        pool.shutdown()
    path = os.path.join(tmp_path, 'trace.json')
    prof.export_chrome_trace(path)
    tr = Trace.load(path)
    run = _run(calls, tr=tr)
    mapped = progspans.mapped_spans(run)
    main = sorted((s, e) for s, e, n in tr.spans if n == 'main.span')
    workers = sorted((s, e) for s, e, n, t in mapped if n == 'worker.span')
    assert len(main) == len(workers) == 3
    for (ms, me), (ws, we) in zip(main, workers):
        assert ms - 1e-3 <= ws and we <= me + 1e-3
        assert we - ws >= 0.02
    placed = sorted((s, e) for s, e, n, t in mapped if n == 'main.span')
    for (ms, me), (ps, pe) in zip(main, placed):
        assert abs(ps - ms) <= 1e-3 and abs(pe - me) <= 1e-3


def _tiny(cell):
    spec = load_cell(cell)
    spec['config']['sample_rate'] = 3000.0
    spec['config']['n_channels'] = 40
    spec['traffic']['recording_s'] = 6
    return spec


def test_the_cell_that_decodes_onto_the_device():
    spec = load_cell('ap_to_tensor')
    assert spec['traffic'] == {'call': 'to_tensor', 'recording_s': 64}
    assert spec['cell']['chips'] == 1 and spec['cell']['config'] == 'np1_ap'
    # Its rate is per layer: one host thread bounds it, at the host's speed.
    assert [m['name'] for m in spec['end_to_end']] == [
        'compress_ratio', 'setup_s']
    per_layer = {m['name'] for m in spec['per_layer']}
    assert 'tensor.decode_gbps' in per_layer
    assert all(n.startswith('tensor.') for n in per_layer)
    assert 'tensor.to_host_s_per_gb' not in per_layer
    assert 'tensor.assemble_s_per_gb' not in per_layer
    seed = 2**31 + 17
    res = run_cell(_tiny('ap_to_tensor'), seed, 0.5, 0, torch.device('cpu'),
                   log=lambda s: None)
    assert res['correct'] and res['failed'] == 0 and res['attempted'] >= 1
    assert set(res['metrics']) == {'compress_ratio', 'setup_s'}
    json.dumps(res)
    assert not run_cell(_tiny('ap_to_tensor'), seed, 0.5, 0,
                        torch.device('cpu'), control=True,
                        log=lambda s: None)['correct']


@pytest.mark.parametrize('cell, spans', [
    ('ap_to_tensor', ['tensor.parse_s_per_gb', 'tensor.upload_s_per_gb',
                      'tensor.decode_gbps']),
    ('ap_to_array', ['read.parse_s_per_gb', 'read.upload_s_per_gb',
                     'read.to_host_s_per_gb']),
    ('ap_compress', ['write.read_s_per_gb', 'write.upload_s_per_gb',
                     'write.decide_s_per_gb', 'write.assemble_s_per_gb',
                     'write.writeback_s_per_gb', 'write.hash_s_per_gb']),
])
def test_a_traced_run_reads_the_program_s_spans(cell, spans):
    """On the CPU the span metrics have something to read; the idle
    share and the transfers (no device operation, no copy to a card)
    do not."""
    res = run_cell(_tiny(cell), 2**31 + 23, 0.5, 1, torch.device('cpu'),
                   log=lambda s: None)
    assert res['correct']
    listed = {m['name'] for m in _tiny(cell)['per_layer']}
    assert set(spans) <= set(res['metrics']) <= listed
    for name in spans:
        assert res['metrics'][name]['value'] > 0
    for name in listed:
        if 'unspanned' in name or 'transfer' in name:
            assert name not in res['metrics']
