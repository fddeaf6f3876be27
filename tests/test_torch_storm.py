"""PyTorch port: the hardware storm (``mtscomp_tpu_torch/storm.py``), the
port's counterpart of ``tools/tpu_storm.py``, on the CPU twins.

The storm's data and foreign quantizer equal the JAX tool's (loaded from
its path; it imports only numpy at module level); its quick grid passes
cell by cell on the twins, with the random cells drawing the JAX storm's
geometry (``TPU_STORM.json``); a file a cell writes decodes to the same
bytes through the JAX package's host codec and through the port; a
failing cell makes ``main()`` return 1 with its error in the report;
``--device cuda`` without a GPU exits non-zero before any cell runs.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mtscomp_tpu
import mtscomp_tpu_torch as mt
from mtscomp_tpu_torch import storm
from mtscomp_tpu_torch.ops import device_delta, rans_decode

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def jax_storm():
    spec = importlib.util.spec_from_file_location(
        'tpu_storm', REPO / 'tools' / 'tpu_storm.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('kind,dtype,seed', [
    ('walk', 'int8', 0), ('walk', 'uint16', 3), ('gradient', 'int16', 1),
    ('common', 'int16', 2), ('walk', 'uint32', 4), ('gradient', 'float16', 5),
    ('walk', 'float32', 6)])
def test_make_data_equals_the_jax_tool(jax_storm, kind, dtype, seed):
    got = storm.make_data(kind, dtype, 517, 37, seed=seed)
    want = jax_storm.make_data(kind, dtype, 517, 37, seed=seed)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('seed', range(4))
def test_quantize_foreign_equals_the_jax_tool(jax_storm, seed):
    rng = np.random.default_rng(seed)
    counts = np.zeros(256, np.int64)
    present = rng.choice(256, size=int(rng.integers(2, 200)), replace=False)
    counts[present] = rng.integers(1, 5000, size=present.size)
    got = storm.quantize_foreign(counts)
    want = jax_storm.quantize_foreign(counts)
    assert np.array_equal(got, want)
    assert got.sum() == 4096 and got[present].min() >= 8
    single = np.zeros(256, np.int64)
    single[7] = 9
    assert storm.quantize_foreign(single) is None
    assert jax_storm.quantize_foreign(single) is None


def _report(base):
    return json.loads(Path(str(base) + '.json').read_text())


QUICK_CELLS = ('dtype_int16', 'dtype_uint32', 'foreign_two_fixup_int16',
               'ragged_tail_split', 'wide_dtype_int64', 'corruption_detected',
               'encode_region_bound')


@pytest.mark.parametrize('name', QUICK_CELLS)
def test_quick_cell_passes_on_the_twins(tmp_path, name):
    base = tmp_path / 'report' / 'storm'
    rc = storm.main(['--quick', '--device', 'cpu', '--cells', name,
                     '--out', str(base)])
    rep = _report(base)
    assert rc == 0, rep['cells']
    assert [c['cell'] for c in rep['cells']] == [name]
    cell = rep['cells'][0]
    assert cell['ok'] and 'error' not in cell
    # The twins never count a launch.
    assert cell['launches'] == {} and rep['summary']['launches'] == dict.fromkeys(
        rep['summary']['launches'], 0)
    assert rep['summary']['device'] == 'cpu'
    assert rep['summary']['geometry'] == dict(sr=2000.0, n_channels=385,
                                              n_samples=5000)
    md = Path(str(base) + '.md').read_text()
    assert '| %s | PASS |' % name in md
    if name.startswith('foreign'):
        assert cell['two_fixup'] > 0
    if name == 'ragged_tail_split':
        assert cell['tail'][:2] == [1, 8] and len(cell['tail'][2]) == 8
    if name == 'wide_dtype_int64':
        # Every decode and the encode on the device route (the twins):
        # no chunk on the host codec.
        assert cell['host'] == {} and cell['encode'] == 'twin'
    if name == 'corruption_detected':
        assert cell['detected'] == 'OSError'
    if name == 'encode_region_bound':
        assert cell['short_region'] == 'RuntimeError'
        assert cell['max_words'] <= cell['cap']


def test_random_cells_draw_the_jax_storms_geometry(tmp_path):
    base = tmp_path / 'storm'
    assert storm.main(['--quick', '--device', 'cpu', '--random', '2',
                       '--seed', '0', '--cells', 'random_',
                       '--out', str(base)]) == 0
    cells = _report(base)['cells']
    tpu = {c['cell']: c for c in json.loads(
        (REPO / 'TPU_STORM.json').read_text())['cells']}
    assert [c['cell'] for c in cells] == ['random_00', 'random_01']
    for c in cells:
        assert c['ok']
        for key in ('dtype', 'nc', 'csize', 'ns', 'mode', 'aligned', 'order'):
            assert c[key] == tpu[c['cell']][key], key
        assert c['encode'] == 'twin'


@pytest.mark.parametrize('name,sub', [('dtype_int16', 'cell_0'),
                                      ('foreign_two_fixup_int16', 'cell_0'),
                                      ('ragged_tail_split', 'cell_0'),
                                      ('random_00', 'rand_0')])
def test_a_storm_file_decodes_alike_in_both_packages(tmp_path, name, sub):
    st = storm.Storm(torch.device('cpu'), tmp_path, quick=True,
                     cell_filter=name)
    st.run_grid()
    st.run_random(1, 0)
    assert [r['ok'] for r in st.results] == [True]
    cbin, ch = tmp_path / sub / 'x.cbin', tmp_path / sub / 'x.ch'
    raw = np.fromfile(tmp_path / sub / 'x.bin', np.uint8)
    host = mtscomp_tpu.decompress(cbin, ch, quiet=True, device='none')
    port = mt.decompress(cbin, ch, quiet=True, device='cpu')
    try:
        a, b = host[:], port.to_array()
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes() == raw.tobytes()
    finally:
        host.close()
        port.close()


def test_a_failing_cell_makes_main_return_1(tmp_path, monkeypatch):
    def broken(reader, arr, device):
        raise AssertionError('planted decode fault')

    monkeypatch.setattr(storm, 'device_decode_all', broken)
    base = tmp_path / 'storm'
    rc = storm.main(['--quick', '--device', 'cpu', '--cells', 'dtype_int8',
                     '--out', str(base)])
    assert rc == 1
    rep = _report(base)
    assert rep['summary']['failed'] == 1 and rep['summary']['passed'] == 0
    assert rep['cells'][0]['error'] == 'AssertionError: planted decode fault'
    md = Path(str(base) + '.md').read_text()
    assert '| dtype_int8 | **FAIL** |' in md and 'planted decode fault' in md


def test_cuda_without_a_gpu_runs_nothing(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(storm.Storm, 'run_cell',
                        lambda self, *a: calls.append(a))
    real = rans_decode._decode_ref
    monkeypatch.setattr(rans_decode, '_decode_ref',
                        lambda *a: calls.append(a) or real(*a))
    base = tmp_path / 'storm'
    rc = storm.main(['--quick', '--device', 'cuda', '--out', str(base)])
    assert rc != 0
    assert calls == []
    assert list(tmp_path.iterdir()) == []


def test_no_report_without_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert storm.main(['--quick', '--device', 'cpu', '--cells',
                       'wide_dtype_uint64']) == 0
    assert list(tmp_path.iterdir()) == []


class _Card:
    """Stands for a CUDA device where the storm asks for one: the checks
    that hold only on the card (launch counts) run, while the patched
    decoder and encoder run the twins."""
    type = 'cuda'


def _small_file(tmp_path):
    arr = storm.make_data('walk', 'int16', 700, 40, seed=1)
    arr.tofile(tmp_path / 'x.bin')
    mt.compress(tmp_path / 'x.bin', tmp_path / 'x.cbin', tmp_path / 'x.ch',
                sample_rate=300., n_channels=40, dtype='int16',
                algorithm='ans', device='none', quiet=True,
                check_after_compress=False)
    return arr


def test_on_the_card_a_decode_batch_without_k1_fails(tmp_path, monkeypatch):
    arr = _small_file(tmp_path)
    r = mt.decompress(tmp_path / 'x.cbin', tmp_path / 'x.ch', device='cpu',
                      quiet=True)
    try:
        storm.device_decode_all(r, arr, torch.device('cpu'))
        real = storm.DeviceBatchDecoder
        monkeypatch.setattr(storm, 'DeviceBatchDecoder',
                            lambda reader, device: real(reader, 'cpu'))
        with pytest.raises(AssertionError,
                           match='launched K1 0 times, expected 1'):
            storm.device_decode_all(r, arr, _Card())
    finally:
        r.close()


def test_on_the_card_a_device_encode_without_k6_fails(tmp_path, monkeypatch):
    arr = _small_file(tmp_path)
    w = mt.Writer(algorithm='ans', quiet=True, device='cpu')
    try:
        w.open(tmp_path / 'x.bin', sample_rate=300., n_channels=40,
               dtype='int16')
        chunks = np.stack([w.get_chunk(0), w.get_chunk(1)])
        payloads, _ = storm.device_encode(w, chunks, torch.device('cpu'))
        assert storm._encode_label(w, payloads, torch.device('cpu')) == 'twin'
        real = storm.DeviceBatchEncoder
        monkeypatch.setattr(storm, 'DeviceBatchEncoder',
                            lambda writer, device: real(writer,
                                                        device='cpu'))
        with pytest.raises(AssertionError, match='never launched K6'):
            storm.device_encode(w, chunks, _Card())
    finally:
        w.close()


def test_a_wide_dtype_cell_that_launches_fails(tmp_path, monkeypatch):
    """A cell of 8-byte items that launches a scan narrower than 64 bits
    (where an upper half would be lost) fails."""
    real = storm.decompress_to_array

    def launching(*a, **k):
        device_delta.launches['scan_transposed_i32_seeded'] += 1
        return real(*a, **k)

    monkeypatch.setitem(device_delta.launches, 'scan_transposed_i32_seeded',
                        0)
    monkeypatch.setattr(storm, 'decompress_to_array', launching)
    st = storm.Storm(torch.device('cpu'), tmp_path, quick=True)
    st.run_cell('wide_dtype_int64', 'planted launch',
                st.cell_wide_dtype('int64'))
    assert not st.results[0]['ok']
    assert 'launched' in st.results[0]['error']
    assert st.results[0]['launches'] == {'scan_transposed_i32_seeded': 1}


@pytest.mark.parametrize('dtype', ['int64', 'uint64', 'float64'])
def test_a_wide_dtype_cell_that_leaves_a_chunk_to_the_host_fails(
        tmp_path, monkeypatch, dtype):
    """A cell of 8-byte items whose decoder declines a batch (the host
    codec then serves it) fails."""
    monkeypatch.setattr(storm.DeviceBatchDecoder, 'supported',
                        lambda self, parsed_list, n_samples: False)
    st = storm.Storm(torch.device('cpu'), tmp_path, quick=True)
    st.run_cell('wide_dtype_' + dtype, 'declined',
                st.cell_wide_dtype(dtype))
    assert not st.results[0]['ok']
    assert 'declined' in st.results[0]['error']


def test_on_the_card_a_wide_dtype_cell_without_an_int64_scan_fails(
        tmp_path, monkeypatch):
    """On the card, a cell of 8-byte items must launch an int64 form of
    K4 or K5; here the twins, which count nothing, stand for the card."""
    monkeypatch.setattr(storm.Storm, 'on_card', property(lambda self: True))
    st = storm.Storm(torch.device('cpu'), tmp_path, quick=True)
    st.run_cell('wide_dtype_int64', 'no int64 scan',
                st.cell_wide_dtype('int64'))
    assert not st.results[0]['ok']
    assert 'without an int64 scan' in st.results[0]['error']
