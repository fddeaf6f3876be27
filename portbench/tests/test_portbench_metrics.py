"""The metric arithmetic: rates over the whole window, the tail over
every request, the idle share and idle gaps from intervals, and the
roofline from bytes."""

import json
from pathlib import Path

import pytest

from portbench import roofline, stats
from portbench.devtrace import Trace
from portbench.run import Run, metric_reader


def _run(calls, t0=0.0, spans=None, trace=None):
    return Run(calls, t0, setup_s=12.5, ratio=3.4, spans=spans, trace=trace)


def test_rate_is_taken_over_the_whole_window():
    # Three calls of 2 GB; the window starts at 0 and the last call ends
    # at 5 s: a gap between calls counts, as a stall in the window would.
    calls = [(0.0, 1.0, 2e9, 5e8), (1.0, 2.0, 2e9, 5e8),
             (4.0, 5.0, 2e9, 5e8)]
    assert metric_reader('decode_gbps')(_run(calls)) == pytest.approx(1.2)
    assert metric_reader('write.compress_mbps')(
        _run(calls)) == pytest.approx(1200.0)


def test_p95_is_over_every_request():
    # 100 requests: 94 of 1 ms, then 2, 3, ..., 7 ms. Nearest rank 95
    # is the 95th smallest, 2 ms; a percentile of medians would say 1.
    lat = [1.0] * 94 + [2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    calls, t = [], 0.0
    for ms in lat:
        calls.append((t, t + ms / 1e3, 1, 0))
        t += ms / 1e3
    assert metric_reader('window_p95_ms')(
        _run(calls)) == pytest.approx(2.0)
    assert metric_reader('browse.window_p50_ms')(
        _run(calls)) == pytest.approx(1.0)
    assert stats.percentile([5, 1, 3], 95) == 5
    assert stats.percentile([5, 1, 3], 50) == 3


def _event(cat, name, ts_us, dur_us):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts_us, 'dur': dur_us}


def _trace():
    # A call span from 0 to 100 us; kernels 10-30 and 20-40 (overlapping)
    # and a copy 70-80; the host is in decode.pack until 50, then in
    # decode.fetch. Device events outside the call span are not counted.
    return Trace([
        _event('user_annotation', 'portbench.to_array', 0, 100),
        _event('user_annotation', 'decode.pack', 0, 50),
        _event('user_annotation', 'decode.fetch', 50, 50),
        _event('kernel', 'k1', 10, 20), _event('kernel', 'k3', 20, 20),
        _event('gpu_memcpy', 'Memcpy DtoH', 70, 10),
        _event('kernel', 'late', 150, 10),
        _event('cpu_op', 'aten::copy_', 60, 5),
    ])


def test_idle_share_from_intervals():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.idle_pct() == pytest.approx(60.0)
    assert metric_reader('read.device_idle_pct')(
        _run([(0, 1, 1, 1)], trace=tr)) == pytest.approx(60.0)
    assert tr.kernel_s() == pytest.approx(40e-6)


def test_idle_gaps_are_named_by_the_open_host_span():
    gaps = dict(_trace().idle_gaps())
    # Idle 0-10 and 40-50 in decode.pack, 50-70 and 80-100 in
    # decode.fetch.
    assert gaps['decode.pack'] == pytest.approx(20e-6)
    assert gaps['decode.fetch'] == pytest.approx(40e-6)
    ops = dict(_trace().device_ops())
    assert ops['k1'] == pytest.approx(20e-6) and 'late' not in ops


def test_a_trace_without_device_work_reads_nothing():
    tr = Trace([_event('user_annotation', 'portbench.to_array', 0, 100)])
    assert tr.idle_pct() is None and tr.idle_gaps() == []
    run = _run([(0, 1, 1, 1)], trace=tr)
    for name in ('read.device_idle_pct', 'read.kernels_roofline'):
        assert metric_reader(name)(run) is None
    assert metric_reader('read.pack_s_per_gb')(run) is None


def test_roofline_from_bytes():
    # 1 GB of payload and 3 GB decoded at 3.35 TB/s: 1.194 ms at least;
    # over 10 ms of kernels, 11.94 %.
    assert roofline.decode_bytes(1e9, 3e9) == 4e9
    assert roofline.decode_least_s(1e9, 3e9) == pytest.approx(4e9 / 3.35e12)
    tr = Trace([_event('user_annotation', 'portbench.to_array', 0, 20000),
                _event('kernel', 'k1', 0, 10000)])
    run = _run([(0, 1, 3e9, 1e9)], trace=tr)
    assert metric_reader('read.kernels_roofline')(run) == pytest.approx(
        100 * 4e9 / 3.35e12 / 10e-3)


def test_span_metrics_per_gb():
    spans = {'decode.pack': (4, 0.5), 'decode.fetch': (4, 0.25),
             'encode.transform': (2, 0.1), 'encode.kernel': (2, 0.05)}
    run = _run([(0, 1, 2e9, 1e9)], spans=spans)
    assert metric_reader('read.pack_s_per_gb')(run) == pytest.approx(0.25)
    assert metric_reader('read.fetch_s_per_gb')(run) == pytest.approx(0.125)
    assert metric_reader('write.encoder_s_per_gb')(run) == pytest.approx(
        0.075)
    assert metric_reader('setup_s')(run) == 12.5
    assert metric_reader('compress_ratio')(run) == 3.4


def test_union_and_spread():
    assert stats.merge([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]
    assert stats.union_length([(0, 2), (1, 3), (5, 9)], 1, 6) == 3
    assert stats.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / 'BENCHMARK.json').read_text())
TENSOR = sorted(m['name'] for m in BENCH['per_layer']
                if m['name'].startswith('tensor.'))


@pytest.mark.parametrize('name', TENSOR)
def test_a_decode_onto_the_card_reads_as_a_bulk_read_does(name):
    """Each ``tensor.<q>`` reads what ``read.<q>`` (``decode_gbps`` for
    the rate) reads of the same window: spans, counters, a trace, or
    nothing at all."""
    twin = 'decode_gbps' if name == 'tensor.decode_gbps' \
        else 'read.' + name.split('.', 1)[1]
    spans = {'decode.pack': (4, 0.5), 'decode.fetch': (4, 0.25),
             'decode.parse': (4, 0.2), 'decode.upload': (2, 0.1)}
    calls = [(0.0, 1.0, 2e9, 5e8), (1.0, 3.0, 2e9, 5e8)]
    runs = [_run(calls, spans=spans, trace=_trace()), _run(calls),
            _run(calls, trace=Trace([_event(
                'user_annotation', 'portbench.to_tensor', 0, 100)]))]
    for run in runs:
        assert metric_reader(name)(run) == metric_reader(twin)(run)
    assert metric_reader(name)(runs[0]) is not None or name in (
        'tensor.transfer_bytes_per_byte', 'tensor.unspanned_idle_pct')
