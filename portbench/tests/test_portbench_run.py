"""Whole runs of the harness: what it loads, where it refuses to run,
and that its check separates sound runs from the control and from a
timed path broken underneath (on the CPU, at a tiny size, with the
kernels' plain twins standing in for the card)."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mtscomp_tpu_torch.parallel import pipeline
from portbench import run

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / 'portbench'


def _imports(path):
    """(top-level name, level) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or '').split('.')[0], node.level


def test_nothing_of_portbench_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob('*.py'))
    assert PKG / 'run.py' in files
    for path in files:
        for name, level in _imports(path):
            assert level or name not in run.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / 'reference').rglob('*.py')):
        for name, level in _imports(path):
            assert level == 1 or name in ('json', 'struct', 'zlib',
                                          'numpy'), (path, name)


def _main(args, cwd, env=None):
    env = dict(os.environ if env is None else env, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, '-m', 'portbench.run'] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


ARGS = ['--workload', 'ap_to_array', '--seed', '2147483650', '--seconds',
        '1', '--trace', '0']


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith('{')


def test_a_run_without_a_card_exits_with_no_result():
    proc = _main(ARGS, ROOT)
    assert proc.returncode == 2 and _no_result(proc)
    assert 'CUDA card' in proc.stderr


def test_a_run_with_only_the_benchmark_exits_with_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(PKG, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = _main(ARGS, tmp_path, env)
    assert proc.returncode == 2 and _no_result(proc)
    assert 'cannot be imported' in proc.stderr


CELLS = ['ap_to_array', 'lfp_to_array', 'ap_compress', 'ap_browse']
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
#: A viewer's cell, left out of BENCHMARK.json (its tail spread too
#: widely from run to run on the card for any bound): its call kind and
#: metric readers stay, so that it can come back as data alone.
BROWSE = {
    'workloads': [{'name': 'ap_browse', 'config': 'np1_ap',
                   'traffic': 'browse_1s_of_32s', 'chips': 1}],
    'end_to_end': [{'name': 'window_p95_ms', 'unit': 'ms',
                    'workloads': ['ap_browse']}],
    'per_layer': [{'name': 'browse.window_p50_ms', 'unit': 'ms',
                   'workloads': ['ap_browse']},
                  {'name': 'browse.device_idle_pct', 'unit': '%',
                   'workloads': ['ap_browse']}],
}


def _spec(cell):
    if any(w['name'] == cell for w in BENCH['workloads']):
        return run.load_cell(cell)
    bench = {k: BENCH[k] + BROWSE.get(k, []) for k in
             ('configs', 'workloads', 'end_to_end', 'per_layer')}
    return run.load_cell(cell, bench)


def _tiny(cell):
    spec = _spec(cell)
    spec['config']['sample_rate'] = 3000.0 if cell.startswith('ap') else 500.
    spec['config']['n_channels'] = 40
    spec['traffic']['recording_s'] = 6
    return spec


def _run(cell, trace=0, control=False, seed=2**31 + 11):
    return run.run_cell(_tiny(cell), seed, 0.5, trace, torch.device('cpu'),
                        control=control, log=lambda s: None)


@pytest.mark.parametrize('cell', CELLS)
def test_sound_runs_are_correct_and_the_control_is_not(cell):
    res = _run(cell)
    assert res['correct'] and res['failed'] == 0 and res['attempted'] >= 1
    names = {m['name'] for m in _spec(cell)['end_to_end']}
    assert set(res['metrics']) == names
    assert list(res)[-1] == 'checks'
    json.dumps(res)
    control = _run(cell, control=True)
    assert not control['correct']
    assert control['checks']['samples_wrong']['value'] > 0


@pytest.mark.parametrize('cell', CELLS)
def test_a_traced_run_reports_per_layer_metrics_it_can_read(cell):
    res = _run(cell, trace=1)
    assert res['correct']
    assert res['device']['window_s'] > 0 and 'breakdown' in res
    listed = {m['name'] for m in _spec(cell)['per_layer']}
    # On the CPU no device operation is traced: only span and host-clock
    # metrics have something to read.
    assert set(res['metrics']) <= listed
    host = {m['name'] for m in _spec(cell)['per_layer']
            if m.get('source') == 'host_clock'}
    assert host <= set(res['metrics'])


def _decode_fault(fault):
    real = pipeline.DeviceBatchDecoder.decode_tensor

    def decode_tensor(self, parsed_list, n_samples):
        out = real(self, parsed_list, n_samples)
        if fault == 'unchanged':
            return torch.zeros_like(out)
        out = out.clone()
        if fault == 'half':
            out[(out.shape[0] + 1) // 2:] = 0
        else:
            out.view(-1)[out.numel() // 3] += 1
        return out
    return pipeline.DeviceBatchDecoder, 'decode_tensor', decode_tensor


def _encode_fault(fault):
    real = pipeline.DeviceBatchEncoder.encode_batch

    def encode_batch(self, chunks, mesh=None):
        if fault == 'half':
            chunks = np.array(chunks)
            chunks[(len(chunks) + 1) // 2:] = 0
        payloads = real(self, chunks, mesh=mesh)
        if fault == 'unchanged':
            return [payloads[0]] * len(payloads)
        if fault == 'altered':
            p = bytearray(payloads[-1])
            p[len(p) // 2] ^= 1
            payloads[-1] = bytes(p)
        return payloads
    return pipeline.DeviceBatchEncoder, 'encode_batch', encode_batch


def _window_fault(fault):
    real = pipeline.DeviceChunkCache.read_window
    first = []

    def read_window(self, i0, i1):
        out = real(self, i0, i1)
        if fault == 'unchanged':
            first.append(out)
            return first[0].copy()
        if fault == 'half':
            out[(out.shape[0] + 1) // 2:] = 0
        else:
            out.reshape(-1)[out.size // 3] += 1
        return out
    return pipeline.DeviceChunkCache, 'read_window', read_window


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered'])
@pytest.mark.parametrize('cell, patch', [('ap_to_array', _decode_fault),
                                         ('ap_compress', _encode_fault),
                                         ('ap_browse', _window_fault)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, patch, fault):
    owner, name, broken = patch(fault)
    monkeypatch.setattr(owner, name, broken)
    res = _run(cell)
    assert not res['correct'], res['checks']


@pytest.mark.chip
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    spec = run.load_cell('ap_to_array')
    device = torch.device('cuda', 0)
    res = run.run_cell(spec, 2**31 + 3, 2.0, 1, device, log=lambda s: None)
    assert res['correct'] and res['device']['busy_s'] > 0
    assert not run.run_cell(spec, 2**31 + 3, 2.0, 0, device, control=True,
                            log=lambda s: None)['correct']
