"""PyTorch port: ``mtscomp_tpu_torch/bench.py`` (the headline benchmark)
on the CPU, against the JAX package's ``bench.py`` and
``mtscomp_tpu.compress``.

The phases run on the kernels' plain twins (``device='cpu'``) at a
small geometry passed as arguments (2 chunks of 1,000 samples x 385
channels): every byte check runs, every rate is ``None`` (a CPU time is
no device number). The orchestrator runs its phases in child processes,
so the tests that drive it spend most of their time starting them.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu  # noqa: E402
import mtscomp_tpu.config as ref_config  # noqa: E402

import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch import bench  # noqa: E402
from mtscomp_tpu_torch.benchmarks import harness  # noqa: E402
from mtscomp_tpu_torch.parallel.pipeline import DeviceBatchDecoder  # noqa: E402

SR, SECONDS = 1000.0, 2
RATES = ('value', 'vs_baseline', 'encode_mbps', 'device_encode_gbps',
         'e2e_decomp_mbps', 'device_compress_mbps', 'e2e_host_mbps')
KEYS = set(RATES) | {
    'metric', 'unit', 'compression_ratio', 'e2e_decomp_path', 'bench_fs',
    'byte_exact', 'phase_errors', 'device', 'launches', 'geometry',
    'elapsed_s'}


@pytest.fixture(scope='module')
def encoded(tmp_path_factory):
    """A bench directory as the orchestrator leaves it after the encode
    phase (run in this process), both packages' user config files
    redirected; ``(directory, source array, the phase's result)``."""
    tmp = tmp_path_factory.mktemp('bench')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, 'CONFIG_PATH', tmp / '.mtscomp_ref')
        mp.setattr(mt_config, 'CONFIG_PATH', tmp / '.mtscomp')
        arr = bench.synthesize(SECONDS, SR)
        arr.tofile(tmp / 'bench.bin')
        (tmp / 'bench.json').write_text(json.dumps(
            {'device': 'cpu', 'seconds': SECONDS, 'sample_rate': SR,
             'n_channels': bench.C}))
        res = bench._phase_encode(tmp, arr, 'cpu', SR)
        yield tmp, arr, res


@pytest.fixture
def bench_env(tmp_path, monkeypatch):
    """The orchestrator's working files under the test's directory."""
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    for knob in ('BENCH_SECONDS', 'BENCH_INNER', 'BENCH_REPS', 'BENCH_BUDGET',
                 'BENCH_PHASE_TIMEOUT', 'MTSCOMP_BENCH_FAULT'):
        monkeypatch.delenv(knob, raising=False)
    return tmp_path


def _json_line(out):
    lines = [line for line in out.splitlines() if line.startswith('{')]
    assert len(lines) == 1, out
    return json.loads(lines[0])


# --- (a) the synthesis -----------------------------------------------------

@pytest.mark.parametrize('block_rows', [7, 1 << 20])
@pytest.mark.parametrize('seconds', [1, 3])
def test_synthesis_is_the_jax_bench_formula(seconds, block_rows, monkeypatch):
    """``bench.py:100-104``: one call's walk, cast to int16; the port's
    drawn 7 rows at a time or in one block."""
    monkeypatch.setattr(harness, 'SYNTH_BLOCK_BYTES', 8 * bench.C * block_rows)
    T = 1000
    rng = np.random.default_rng(0)
    want = np.cumsum(rng.normal(0.0, 6.0, size=(T * seconds, bench.C)),
                     axis=0).astype(np.int16)
    got = bench.synthesize(seconds, float(T))
    assert got.dtype == np.int16 and np.array_equal(got, want)
    assert (bench.C, bench.SR) == (385, 30000.0)


# --- (b, c) the phases in this process ----------------------------------------

def test_encode_phase_routes_equal_the_jax_package(encoded):
    tmp, arr, res = encoded
    assert res['byte_exact'] and res['launches'] == {}
    assert res['enc_mbps'] is None and res['device_compress_mbps'] is None
    for ext in ('cbin', 'ch'):
        assert ((tmp / ('bench.' + ext)).read_bytes()
                == (tmp / ('bench_dev.' + ext)).read_bytes())
    ratio = mtscomp_tpu.compress(
        tmp / 'bench.bin', tmp / 'jax.cbin', tmp / 'jax.ch', sample_rate=SR,
        n_channels=bench.C, dtype='int16', algorithm='ans', device='none',
        quiet=True, check_after_compress=False)
    assert res['ratio'] == 1.0 / ratio
    for ext in ('cbin', 'ch'):
        assert ((tmp / ('bench.' + ext)).read_bytes()
                == (tmp / ('jax.' + ext)).read_bytes())


@pytest.mark.parametrize('phase', ['dev_decode', 'e2e', 'dev_encode'])
def test_phase_on_the_twins_is_byte_exact_with_no_rate(phase, encoded,
                                                       monkeypatch):
    """Each device phase takes the device route (the twins count no
    launch: ``pack`` is spied) and gives ``null`` rates."""
    tmp, arr, _ = encoded
    packs = []
    pack = DeviceBatchDecoder.pack
    monkeypatch.setattr(DeviceBatchDecoder, 'pack',
                        lambda self, *a, **k: packs.append(1)
                        or pack(self, *a, **k))
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp / '.mtscomp')
    res = getattr(bench, '_phase_' + phase)(tmp, arr, 'cpu', SR)
    assert 'error' not in res and res['byte_exact'] is True
    assert res['launches'] == {}
    rates = {'dev_decode': ('gbps',), 'e2e': ('e2e_mbps', 'e2e_host_mbps'),
             'dev_encode': ('dev_enc_gbps',)}[phase]
    assert all(res[k] is None for k in rates)
    assert bool(packs) == (phase != 'dev_encode')
    if phase == 'dev_decode':
        assert (res['batches'], res['widest_batch']) == (1, SECONDS)


# --- (d, f) the orchestrator ---------------------------------------------------

def test_orchestrate_on_the_twins(bench_env, capsys):
    rc = bench.orchestrate(device='cpu', seconds=SECONDS, sample_rate=SR)
    line = _json_line(capsys.readouterr().out)
    assert rc == 0, line
    assert set(line) == KEYS
    assert line['metric'] == 'decompress_throughput_neuropixels_385ch_int16'
    assert line['byte_exact'] is True and line['phase_errors'] == {}
    assert all(line[k] is None for k in RATES)
    assert line['device'] == {'platform': 'cpu', 'name': None,
                              'power_limit': None, 'count': None}
    assert line['launches'] == dict.fromkeys(
        ('encode', 'dev_decode', 'e2e', 'dev_encode'), {})
    assert line['compression_ratio'] > 3
    assert line['e2e_decomp_path'] == 'device'
    # The working files are removed at exit; the directory is the test's.
    assert line['bench_fs'] == bench._fs_type(str(bench_env))


def test_no_card_is_an_error_without_a_rate(bench_env, capsys):
    """``--device cuda`` (the default) without a GPU: the probe child
    says so and the bench exits 2, no phase runs and no rate is given."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is visible: the bench would run')
    rc = bench.main([])
    line = _json_line(capsys.readouterr().out)
    assert rc == 2
    assert 'no CUDA GPU' in line['error'] and line['phase_errors']
    assert all(line[k] is None for k in RATES)
    assert line['byte_exact'] is False and line['launches'] == {}


# --- (e) deadlines -------------------------------------------------------------

def test_a_hung_phase_child_is_killed_and_retried(encoded, monkeypatch):
    tmp, _, _ = encoded
    monkeypatch.setenv('MTSCOMP_BENCH_FAULT', 'hang:dev_decode:1')
    deadline = 12.0
    t0 = time.time()
    res, note = bench._run_phase('dev_decode', tmp, timeout=deadline,
                                 attempts=2, budget_left=lambda: 1000.0)
    elapsed = time.time() - t0
    assert note is None and res['byte_exact'] is True, (res, note)
    assert deadline <= elapsed < 2 * deadline


GRANDCHILD = """
import subprocess, sys, time
p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(600)'])
open(sys.argv[1], 'w').write(str(p.pid))
print('grandchild started', flush=True)
if sys.argv[2] == 'sleeps':
    time.sleep(600)
"""


def _gone(pid):
    """The process has exited (or is a zombie nobody has reaped yet)."""
    try:
        with open('/proc/%d/stat' % pid) as f:
            return f.read().rsplit(')', 1)[1].split()[0] == 'Z'
    except FileNotFoundError:
        return True


@pytest.mark.parametrize('child', ['sleeps', 'exits'])
def test_a_grandchild_holding_the_pipe_is_killed_at_the_deadline(child,
                                                                 tmp_path):
    """A child that hangs is killed with its process group at the
    deadline (rc None). A child that exits and leaves a grandchild
    behind, which would hold a pipe of its output open
    (``subprocess.run(timeout=)`` would wait for it), gives its own code
    at once, and the grandchild is killed with the group."""
    pid_file = tmp_path / 'pid'
    deadline = 4.0
    t0 = time.time()
    rc, out = bench._run_child(
        [sys.executable, '-c', GRANDCHILD, str(pid_file), child], deadline)
    elapsed = time.time() - t0
    assert 'grandchild started' in out
    if child == 'sleeps':
        assert rc is None
        assert deadline <= elapsed < deadline + 8
    else:
        assert rc == 0 and elapsed < deadline
    pid = int(pid_file.read_text())
    for _ in range(50):
        if _gone(pid):
            break
        time.sleep(0.1)
    assert _gone(pid)


def test_a_finished_child_gives_its_code_and_output():
    rc, out = bench._run_child(
        [sys.executable, '-c', 'import sys; print("out"); sys.exit(3)'], 30)
    assert (rc, out.strip()) == (3, 'out')


def test_run_module_puts_the_package_first_on_the_childs_path(monkeypatch):
    """The child is ``python -m mtscomp_tpu_torch.bench *args``, with the
    package's directory ahead of any ``PYTHONPATH`` it was given and the
    other variables of this process kept."""
    calls = []
    monkeypatch.setattr(bench, '_run_child', lambda cmd, timeout, env: (
        calls.append((cmd, timeout, env)) or (0, '')))
    monkeypatch.setenv('BENCH_KEPT', '1')
    assert bench.run_module(['--phase', 'e2e'], 7.0,
                            env={'PYTHONPATH': 'elsewhere'}) == (0, '')
    (cmd, timeout, env), = calls
    assert cmd == [sys.executable, '-m', 'mtscomp_tpu_torch.bench',
                   '--phase', 'e2e'] and timeout == 7.0
    assert env['PYTHONPATH'].split(os.pathsep) == [bench._ROOT, 'elsewhere']
    assert env['BENCH_KEPT'] == '1'
    assert os.path.isfile(os.path.join(bench._ROOT, 'mtscomp_tpu_torch',
                                       'bench.py'))


def test_fs_type_reads_the_mounts():
    assert bench._fs_type('/proc/self') == 'proc'
    assert bench._fs_type('/') is not None

