"""PyTorch port: ``mtscomp_tpu_torch/benchmarks`` (the harness, the
BASELINE.json report and the plots) against the JAX package's
``mtscomp_tpu/benchmarks`` on the CPU.

Tolerance 0 everywhere: the synthetic datasets bit for bit (the port
draws them block by block in rows, the JAX package in one call), the
ratios and the rows' keys exactly. The device routes run the kernels'
plain twins (``device='cpu'``), which count no launch; the report runs
at a few thousand samples a recording, its synthesis capped, and its
ratios are held against the JAX package's host compress of the same
arrays (the JAX report itself is not run).
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu  # noqa: E402
import mtscomp_tpu.config as ref_config  # noqa: E402
from mtscomp_tpu.benchmarks import baseline_report as ref_report  # noqa: E402
from mtscomp_tpu.benchmarks import harness as ref_harness  # noqa: E402

import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch.benchmarks import baseline_report, harness  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as mt_pipeline  # noqa: E402


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """Both packages' user config files in the test's directory, the
    port's naming the twins; the port's profile cache there too."""
    monkeypatch.setattr(ref_config, 'CONFIG_PATH', tmp_path / '.mtscomp_ref')
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    mt_config.CONFIG_PATH.write_text(json.dumps({'device': 'cpu'}))
    monkeypatch.setattr(mt_pipeline, '_profile_cache_path',
                        lambda name: str(tmp_path / 'cache' / name))
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    return tmp_path


def _launched():
    return {k: v for k, v in mt.launch_counts().items()
            if v and k not in ('host_fallback_chunks', 'host_encoded_chunks')}


# --- the datasets ------------------------------------------------------------

@pytest.mark.parametrize('duration', [0.3, 1.0])
@pytest.mark.parametrize('name', sorted(ref_harness.DATASETS))
def test_make_dataset_equals_the_jax_arrays(name, duration):
    assert harness.DATASETS == ref_harness.DATASETS
    got, sr = harness.make_dataset(name, duration)
    want, want_sr = ref_harness.make_dataset(name, duration)
    assert sr == want_sr and got.dtype == want.dtype == np.int16
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize('block_rows', [1, 7, 1000])
def test_blockwise_synthesis_equals_the_one_call_synthesis(block_rows,
                                                           monkeypatch):
    """``_synth`` (no clip: values past int16 wrap as the JAX cast
    wraps them), ``_synth_gradient`` and ``make_dataset`` drawn 1, 7 or
    more rows than the recording at a time (``SYNTH_BLOCK_BYTES`` set to
    that many rows of float64 steps)."""
    def blocks_of(nc):
        monkeypatch.setattr(harness, 'SYNTH_BLOCK_BYTES', 8 * nc * block_rows)

    ns, nc = 300, 9
    blocks_of(nc)
    got = baseline_report._synth(ns, nc, 3000.0, seed=4)
    want = ref_report._synth(ns, nc, 3000.0, seed=4)
    assert np.abs(np.cumsum(np.random.default_rng(4).normal(
        0.0, 3000.0, (ns, nc)), axis=0)).max() > 32767   # a wrap is tested
    assert np.array_equal(got, want)
    got = baseline_report._synth_gradient(ns, nc, 3.0, 4000.0, seed=2)
    want = ref_report._synth_gradient(ns, nc, 3.0, 4000.0, seed=2)
    assert np.array_equal(got, want) and np.abs(want).max() == 30000
    blocks_of(64)
    got, _ = harness.make_dataset('small_64', 0.01, seed=3)
    assert got.shape == (200, 64)
    assert np.array_equal(got, ref_harness.make_dataset('small_64', 0.01,
                                                        seed=3)[0])


def test_the_synthesis_is_drawn_in_blocks(monkeypatch):
    """``synth_walk`` asks ``draw`` for at most ``SYNTH_BLOCK_BYTES`` of
    float64 steps a call: blocks of 7 rows, the last one short."""
    monkeypatch.setattr(harness, 'SYNTH_BLOCK_BYTES', 8 * 5 * 7)
    asked = []

    def draw(n):
        asked.append(n)
        return np.ones((n, 5))

    got = harness.synth_walk(30, 5, draw, clip=False)
    assert asked == [7, 7, 7, 7, 2]
    assert np.array_equal(got[:, 0], np.arange(1, 31))


def test_bench_tmp_base_prefers_tmpdir(monkeypatch, tmp_path):
    """``$TMPDIR`` when set (every file of the run stays there), else
    tmpfs where there is one."""
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    assert harness.bench_tmp_base() == str(tmp_path)
    d = harness.bench_tmpdir()
    assert d.parent == tmp_path and d.is_dir()
    monkeypatch.delenv('TMPDIR')
    want = '/dev/shm' if os.path.isdir('/dev/shm') else None
    assert harness.bench_tmp_base() == want == ref_harness.bench_tmp_base()


def test_an_empty_synthesis_has_the_jax_shape():
    got = baseline_report._synth(0, 5, 6.0)
    want = ref_report._synth(0, 5, 6.0)
    assert got.shape == want.shape and got.dtype == want.dtype


# --- mtscomp_perf, format_report ----------------------------------------------

@pytest.mark.parametrize('device', [False, True])
@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
def test_mtscomp_perf_gives_the_jax_row(workdir, algorithm, device):
    """The JAX keys and ratio; ``device=True`` under a configuration
    naming the CPU decodes on the twins (so launches nothing) and
    ``device=False`` on the host codec."""
    arr, sr = harness.make_dataset('small_64', duration=0.3)
    mt.reset_launch_counts()
    row = harness.mtscomp_perf(arr, sr, algorithm=algorithm, device=device,
                               read_windows=3)
    assert _launched() == {}
    want = ref_harness.mtscomp_perf(arr, sr, algorithm=algorithm,
                                    device=False, read_windows=3)
    assert list(row) == list(want)
    assert row['ratio'] == want['ratio'] > 1.5
    for key in ('algorithm', 'n_threads', 'chunk_duration'):
        assert row[key] == want[key]


def test_mtscomp_perf_routes(workdir, monkeypatch):
    """``device=False`` sends ``'none'`` to both compress and decompress;
    ``device=True`` leaves both to the configuration."""
    seen = []
    for name in ('compress', 'decompress'):
        real = getattr(mt, name)

        def spy(*a, _name=name, _real=real, **kw):
            seen.append((_name, kw.get('device')))
            return _real(*a, **kw)

        monkeypatch.setattr(mt, name, spy)
    arr, sr = harness.make_dataset('small_64', duration=0.1)
    harness.mtscomp_perf(arr, sr, device=False, read_windows=1)
    harness.mtscomp_perf(arr, sr, device=True, read_windows=1)
    assert seen == [('compress', 'none'), ('decompress', 'none'),
                    ('compress', None), ('decompress', None)]


def test_format_report_gives_the_jax_text():
    rows = [{'dataset': 'ap_385', 'algorithm': 'zlib', 'n_threads': 1,
             'ratio': 2.913, 'write_mbps': 20.5, 'read_mbps': 116.4,
             'window_ms': 0.41},
            {'dataset': 'ap_385', 'algorithm': 'ans', 'n_threads': 4,
             'ratio': 3.388, 'write_mbps': 270.2, 'read_mbps': 1338.0,
             'window_ms': 12.25, 'extra': 'x'}]
    for case in (rows, rows[:1], []):
        assert harness.format_report(case) == ref_harness.format_report(case)
    from mtscomp_tpu_torch.benchmarks import format_report, mtscomp_perf
    assert format_report is harness.format_report
    assert mtscomp_perf is harness.mtscomp_perf


def test_the_timer_needs_a_card(monkeypatch):
    """No card, no time: the timer raises (torch built without CUDA
    asserts, one built with it raises RuntimeError), never falls back to
    the host clock."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        harness.cuda_ms(lambda: None, 1)


def test_benchmark_plots_on_the_port(tmp_path):
    """The JAX package's ``test_benchmark_plots``, on the port's plots."""
    matplotlib = pytest.importorskip('matplotlib')
    matplotlib.use('Agg')
    from mtscomp_tpu_torch.benchmarks.plots import bar_chart, benchmark_plots
    rows = [
        {'dataset': 'ap', 'algorithm': 'zlib', 'n_threads': 1,
         'ratio': 2.9, 'write_mbps': 10, 'read_mbps': 20, 'window_ms': 5},
        {'dataset': 'ap', 'algorithm': 'zlib', 'n_threads': 4,
         'ratio': 2.9, 'write_mbps': 30, 'read_mbps': 21, 'window_ms': 5},
        {'dataset': 'ap', 'algorithm': 'ans', 'n_threads': 1,
         'ratio': 3.3, 'write_mbps': 40, 'read_mbps': 90, 'window_ms': 2},
        {'dataset': 'ap', 'algorithm': 'ans', 'n_threads': 4,
         'ratio': 3.3, 'write_mbps': 90, 'read_mbps': 91, 'window_ms': 2},
    ]
    fig = bar_chart(rows, metric='read_mbps', group_by='algorithm',
                    bar_by='n_threads')
    assert fig.axes[0].get_ylabel() == 'read_mbps'
    figs = benchmark_plots(output_dir=tmp_path / 'plots', rows=rows)
    assert set(figs) == {'ratio', 'write_mbps', 'read_mbps', 'window_ms'}
    for metric in figs:
        assert (tmp_path / 'plots' / ('%s.png' % metric)).exists()


# --- baseline_report ------------------------------------------------------------

#: Most samples the report's ``_synth`` draws in these tests.
CAP = 6000


def _ref_ratio(tmp, arr, sr, algorithm, **kw):
    """The JAX package's host compress of ``arr``: raw / compressed."""
    arr.tofile(tmp / 'ref.bin')
    return 1 / mtscomp_tpu.compress(
        tmp / 'ref.bin', tmp / 'ref.cbin', tmp / 'ref.ch', sample_rate=sr,
        n_channels=arr.shape[1], dtype=arr.dtype, algorithm=algorithm,
        quiet=True, check_after_compress=False, device='none', **kw)


def test_baseline_report_on_the_twins(workdir, monkeypatch, capsys):
    """``main(['--device', 'cpu', ...])`` at a few thousand samples a
    recording: every config runs, every byte-exact cell holds, the
    staged rates are measured, nothing launches, and every ratio is the
    JAX package's host compress of the same array. The configured
    device is ``'cuda'``, which raises on a host without a GPU: every
    call of the report names its device, so the report never reads it."""
    real = baseline_report._synth
    monkeypatch.setattr(baseline_report, '_synth',
                        lambda ns, *a, **kw: real(min(ns, CAP), *a, **kw))
    mt_config.CONFIG_PATH.write_text(json.dumps({'device': 'cuda'}))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    mt.reset_launch_counts()
    assert baseline_report.main(['--device', 'cpu', '--seconds', '1',
                                 '--lfp-seconds', '4', '--reps', '1']) == 0
    assert _launched() == {}
    text = capsys.readouterr().out
    assert text.startswith('# BASELINE.json configs on the port')
    lines = [ln for ln in text.splitlines()
             if ln.startswith('{"baseline_report"')]
    assert len(lines) == 1
    res = json.loads(lines[0])['baseline_report']
    assert res['device'] == 'cpu' and res['cuda'] is None
    for name in ('config%d' % i for i in range(1, 7)):
        assert res[name]['launches'].keys() <= {'host_encoded_chunks'}
    c1, c2, c3, c4, c5, c6 = (res['config%d' % i] for i in range(1, 7))
    assert all(c1[a]['exact'] for a in ('zlib', 'ans'))
    assert c2['staged']['exact'] and c2['to_array']['cpu']['exact'] \
        and c2['to_array']['host']['exact']
    assert c2['staged']['gbps'] > 0 and c2['staged']['batches'] == 1
    assert c2['staged']['batch_limit'] == \
        mt_pipeline.DECODE_BATCH_BYTES // (CAP * 385 * 2)
    assert c3['exact'] and c3['auto_route'] == 'host'
    assert set(c3['window_ms']) == {'host', 'cpu', 'auto'}
    assert c4['decompress_multi']['exact'] and c4['staged']['exact'] \
        and c4['mesh']['exact']
    assert c4['staged']['gbps'] > 0 and c4['mesh']['width'] == 1
    assert c4['staged']['widest_batch'] == 4
    assert c5['exact'] and c5['writer'].startswith('self-written')
    assert c6['ans']['exact']
    # The ratios: the JAX package's host compress of the same arrays.
    tmp = workdir
    a1 = ref_report._synth(CAP, 256, 4.0)
    for algo in ('zlib', 'ans'):
        assert c1[algo]['ratio'] == _ref_ratio(tmp, a1, 20000.0, algo)
    assert c2['ratio'] == _ref_ratio(tmp, ref_report._synth(CAP, 385, 6.0),
                                     30000.0, 'ans')
    a3 = ref_report._synth_gradient(2500 * 4, 385, 3.0, 40.0)
    for mode in ('segment', 'plane'):
        assert c3['ratio_' + mode] == _ref_ratio(tmp, a3, 2500.0, 'ans',
                                                 ans_table_mode=mode)
    a5 = ref_report._synth(CAP, 385, 6.0)
    assert c5['zlib_ratio'] == _ref_ratio(tmp, a5, 30000.0, 'zlib')
    assert c5['ans_ratio'] == _ref_ratio(tmp, a5, 30000.0, 'ans')
    rng = np.random.default_rng(6)
    a6 = np.cumsum(rng.normal(0.0, 1.0, size=(20 * 2500, 64)),
                   axis=0).astype(np.float32)
    a6 -= a6.mean(axis=0, keepdims=True)
    for algo in ('zlib', 'ans'):
        assert c6[algo]['ratio'] == _ref_ratio(tmp, a6, 2500.0, algo)
    r = mtscomp_tpu.decompress(tmp / 'ref.cbin', tmp / 'ref.ch', quiet=True,
                               device='none')
    try:
        assert np.array_equal(r[:].view(np.uint32), a6.view(np.uint32))
    finally:
        r.close()
    _ref_ratio(tmp, a6, 2500.0, 'zlib')
    r = mtscomp_tpu.decompress(tmp / 'ref.cbin', tmp / 'ref.ch', quiet=True,
                               device='none')
    try:
        assert c6['zlib']['bit_exact'] == np.array_equal(
            r[:].view(np.uint32), a6.view(np.uint32))
    finally:
        r.close()


def test_baseline_report_without_a_gpu_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert baseline_report.main(['--device', 'cuda']) == 2
    captured = capsys.readouterr()
    assert captured.out == '' and 'no CUDA GPU' in captured.err
