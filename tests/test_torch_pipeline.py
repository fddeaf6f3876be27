"""PyTorch port: the staged batch decode and the user entry points.

The port's ``pack`` stages the same arrays as the JAX package's, and its
``decode_batch`` returns the same bytes as the JAX package's (Pallas in
interpret mode) and as the source, on the 129-channel ragged-tail
geometry, the 128-channel uniform one and 40-channel int16/uint16 (the
fuse8 route; ``test_torch_generic.py`` holds the other layouts), and
every frozen ans file decodes through the port.
"""

import collections
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from mtscomp_tpu import compress, decompress  # noqa: E402
from mtscomp_tpu.parallel.pipeline import (  # noqa: E402
    DeviceBatchDecoder as JaxDecoder, _read_payload)

import mtscomp_tpu_torch as mt  # noqa: E402
from mtscomp_tpu_torch.codec import ans as ans_mod  # noqa: E402
from mtscomp_tpu_torch.device import resolve_device  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402
from mtscomp_tpu_torch.parallel.mesh import chunk_mesh  # noqa: E402

from chip_smoke import foreign_quantizer, heavy_tailed_steps  # noqa: E402
from conftest import make_signal, to_int16, write_arr  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _file(tmp_path, name, monkeypatch, step=5.0, **kw):
    """The JAX device tests' geometries: (source array, reader, T).

    Random walks with small steps (``step``) keep each chunk's high
    byte constant, so every geometry takes the fused u8 route.
    """
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    dtype = 'int16'
    if name == 'ragged129':
        # 4-channel segments, a 1-channel tail split into 8 sub-rows.
        C, T, n, seed, opts = 129, 1000, 4, 7, {'ans_seg_log2': 12}
    elif name == 'uniform128':
        C, T, n, seed, opts = 128, 1000, 2, 8, {'ans_seg_log2': 12}
    else:                                     # wide40_int16 / _uint16
        C, T, n, seed, opts = 40, 300, 4, 9, {}
        dtype = name.split('_')[1]
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.normal(0, step, size=(n * T, C)),
                    axis=0).astype(np.int16).astype(dtype)
    opts.update(kw)
    return arr, _compressed(tmp_path, arr, T, **opts), T


def _compressed(tmp_path, arr, T, **opts):
    path = write_arr(tmp_path / 'p.bin', arr)
    compress(path, tmp_path / 'p.cbin', tmp_path / 'p.ch',
             sample_rate=float(T), n_channels=arr.shape[1],
             dtype=arr.dtype, algorithm='ans', quiet=True,
             check_after_compress=False, device='none', **opts)
    return decompress(tmp_path / 'p.cbin', tmp_path / 'p.ch', quiet=True)


def _parsed(r):
    return [r.codec.parse(_read_payload(r, i)) for i in range(r.n_chunks)]


GEOMS = ['ragged129', 'uniform128', 'wide40_int16', 'wide40_uint16']
TAILS = {'ragged129': (1, 8, (128,) * 8)}


def word_rows(parsed):
    """Rows of 128 words the port stages for each group: the longest
    stream's, no slack."""
    return -(-max(g['words'].size for p in parsed for g in p['groups'])
             // 128)


@pytest.mark.parametrize('name', GEOMS)
def test_pack_matches_jax_pack(tmp_path_, monkeypatch, name):
    """The port stages the JAX package's arrays, states, tables and
    counts in full, each group's words in the longest stream's rows (the
    JAX package's further rows all zero), and the staged batch decodes
    to the source and to the JAX package's bytes."""
    arr, r, T = _file(tmp_path_, name, monkeypatch)
    try:
        parsed = _parsed(r)
        dec = tp.DeviceBatchDecoder(r, 'cpu')
        assert dec.supported(parsed, T)
        fn, args = dec.pack(parsed, T)
        jdec = JaxDecoder(r)
        _jfn, jargs = jdec.pack(parsed, T)
        assert dec.last_tail == jdec.last_tail == TAILS.get(name)
        rows = word_rows(parsed)
        assert args[1].shape[1] == rows * 128
        assert not tp.args_from_jax_pack(jargs, 'cpu')[1][:, rows * 128:].any()
        want = tp.args_from_jax_pack(jargs, 'cpu', rows=rows)
        assert len(args) == len(want) == 8
        for a, b in zip(args, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert fn.keywords['tail'] == dec.last_tail
        out, used = fn(*args)
        tp.check_words_used(parsed, used)
        got = out.numpy().view(arr.dtype)
        assert got.tobytes() == JaxDecoder(r).decode_batch(parsed, T).tobytes()
        assert np.array_equal(got.reshape(arr.shape), arr)
    finally:
        r.close()


@pytest.mark.parametrize('name', GEOMS)
def test_decode_batch_matches_jax_and_source(tmp_path_, monkeypatch, name):
    arr, r, T = _file(tmp_path_, name, monkeypatch)
    try:
        parsed = _parsed(r)
        got = tp.DeviceBatchDecoder(r, 'cpu').decode_batch(parsed, T)
        want = JaxDecoder(r).decode_batch(parsed, T)
        assert got.dtype == want.dtype == arr.dtype
        assert got.shape == want.shape == (len(parsed), T, arr.shape[1])
        assert np.array_equal(got, want)
        assert np.array_equal(got.reshape(arr.shape), arr)
    finally:
        r.close()


# --- K1's tables: built from the frequency tables, or packed on the host ---

def _counted(monkeypatch):
    """The pipeline's counters of one test, whatever tracing says."""
    seen = collections.Counter()
    monkeypatch.setattr(tp, 'count',
                        lambda name, n=1: seen.update({name: n}))
    return seen


def _rans_planes(parsed):
    return [p for p, m in enumerate(parsed[0]['modes'])
            if m == ans_mod.MODE_RANS]


#: The fuse8 layouts (walks of small steps: one rANS plane), and walks of
#: heavy-tailed steps on the generic route (both byte planes rANS).
TABLE_LAYOUTS = [('ragged129', 'fuse8'), ('uniform128', 'fuse8'),
                 ('wide40_uint16', 'fuse8'), ('ragged129', 'generic'),
                 ('uniform128', 'generic')]


@pytest.mark.parametrize('width', [None, 2])
@pytest.mark.parametrize('name,route', TABLE_LAYOUTS)
def test_pack_builds_k1_tables_from_freqs(tmp_path_, monkeypatch, name,
                                          route, width):
    """An 8-aligned batch (every batch this codec writes) stages K1's
    octet and dense tables built from the containers' frequency tables:
    the host packer's rows bit for bit, every table counted on the card,
    and the batch decodes to the source, with and without a mesh."""
    arr, r, T = _file(tmp_path_, name, monkeypatch)
    if route == 'generic':
        r.close()
        rng = np.random.default_rng(T)
        arr = np.cumsum(heavy_tailed_steps(rng, arr.shape),
                        axis=0).astype(np.int16)
        r = _compressed(tmp_path_, arr, T, ans_seg_log2=12)
    seen = _counted(monkeypatch)
    try:
        parsed = _parsed(r)
        dec = tp.DeviceBatchDecoder(r, 'cpu')
        assert dec.supported(parsed, T)
        mesh = None if width is None else chunk_mesh(['cpu'] * width)
        fn, staged = dec.pack(parsed, T, mesh=mesh)
    finally:
        r.close()
    assert fn.func is (tp._decode_fuse8 if route == 'fuse8'
                       else tp._decode_generic)
    planes = _rans_planes(parsed)
    assert len(planes) == (1 if route == 'fuse8' else 2)
    freqs, tbase = tp.freq_stack(parsed, planes)
    assert tbase[-1] == len(freqs) > 0
    assert seen == {'decode.tables_on_card': len(freqs)}
    shards = [staged] if mesh is None else staged
    assert len(shards) == (width or 1)
    B, G = len(parsed), len(parsed[0]['groups'])
    slots = tp.group_slots(B, G, B // len(shards), dec.last_tail)
    lookup, dense, fixups = tp.host_tables(parsed, slots, B * G)
    assert fixups == 0
    for got, want in ((torch.cat([a[2] for a in shards]), lookup),
                      (torch.cat([a[3] for a in shards]), dense)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    outs, used = zip(*(fn(*a) for a in shards))
    tp.check_words_used(parsed, torch.cat(used))
    got = torch.cat(outs).numpy().view(arr.dtype)
    assert np.array_equal(got.reshape(arr.shape), arr)


@pytest.mark.parametrize('seed', range(4))
def test_pack_packs_on_the_host_for_a_foreign_table(tmp_path_, monkeypatch,
                                                    seed):
    """A batch holding one table off the 8-slot grid (another writer's
    quantizer at unit granularity, one table for its plane) beside this
    writer's chunk packs every table on the host, K1 reading coarse
    rows, and decodes to both sources."""
    C, T = 40, 300
    rng = np.random.default_rng(seed)
    readers, arrs = [], []
    for name, opts in (('own', {}), ('foreign', {'ans_table_mode': 'plane'})):
        arr = np.cumsum(rng.normal(0, 5, size=(T, C)), axis=0).astype(
            np.int16)
        path = write_arr(tmp_path_ / (name + '.bin'), arr)
        cbin, ch = tmp_path_ / (name + '.cbin'), tmp_path_ / (name + '.ch')
        with monkeypatch.context() as m:
            if name == 'foreign':
                m.setattr(ans_mod, '_quantize_rows', foreign_quantizer(16))
            mt.compress(path, cbin, ch, sample_rate=float(T), n_channels=C,
                        dtype='int16', algorithm='ans', quiet=True,
                        check_after_compress=False, device='none', **opts)
        readers.append(mt.decompress(cbin, ch, device='cpu', quiet=True))
        arrs.append(arr)
    seen = _counted(monkeypatch)
    try:
        parsed = [rd.codec.parse(tp._read_payload(rd, 0)) for rd in readers]
        planes = _rans_planes(parsed)
        foreign = tp.plane_tables(parsed[1], planes[0])
        assert len(foreign) == 1 and np.any(foreign & 7)
        assert not np.any(tp.freq_stack(parsed[:1], planes)[0] & 7)
        dec = tp.DeviceBatchDecoder(readers[0], 'cpu')
        assert dec.supported(parsed, T)
        fn, args = dec.pack(parsed, T)
    finally:
        for rd in readers:
            rd.close()
    n_tables = len(tp.freq_stack(parsed, planes)[0])
    assert seen == {'decode.tables_on_host': n_tables}
    fixups = (fn.keywords['fixups'] if 'fixups' in fn.keywords
              else fn.keywords['lay'].fixups)
    assert fixups in (1, 2)
    NG = len(parsed) * len(parsed[0]['groups'])
    assert args[2].shape == (NG, 32, 256)
    out, used = fn(*args)
    tp.check_words_used(parsed, used)
    assert np.array_equal(out.numpy(), np.stack(arrs))


@pytest.mark.parametrize('name', ['ragged129', 'uniform128'])
def test_dropped_word_fails_the_audit(tmp_path_, monkeypatch, name):
    _arr, r, T = _file(tmp_path_, name, monkeypatch)
    try:
        parsed = _parsed(r)
        g = parsed[1]['groups'][0]
        assert g['words'].size > 1
        g['words'] = g['words'][:-1]
        with pytest.raises(IOError, match='payload words'):
            tp.DeviceBatchDecoder(r, 'cpu').decode_batch(parsed, T)
        with pytest.raises(IOError, match='payload words'):
            JaxDecoder(r).decode_batch(parsed, T)
    finally:
        r.close()


def _decodes_on_the_port(r, arr, T, tmp_path):
    """The JAX package decodes this file's batch on its device, and so
    does the port, byte for byte, from the batch decoder and from the
    reader, with no chunk on the host codec."""
    try:
        parsed = _parsed(r)
        dec = tp.DeviceBatchDecoder(r, 'cpu')
        assert dec.supported(parsed, T)
        got = dec.decode_batch(parsed, T)
        want = JaxDecoder(r).decode_batch(parsed, T)
        assert np.array_equal(got, want)
        assert np.array_equal(got.reshape(arr.shape), arr)
    finally:
        r.close()
    mt.reset_launch_counts()
    rp = mt.decompress(tmp_path / 'p.cbin', tmp_path / 'p.ch', device='cpu',
                       quiet=True)
    try:
        assert np.array_equal(rp.to_array(), arr)
        assert mt.launch_counts()['host_fallback_chunks'] == 0
    finally:
        rp.close()


def test_order2_fuse8_decodes(tmp_path_, monkeypatch):
    """Second-order time diff on the fuse8 route (finalize, then K5)."""
    # Small steps keep the second diffs' high byte constant: fuse8 + K5.
    arr, r, T = _file(tmp_path_, 'ragged129', monkeypatch, step=0.5,
                      time_diff_order=2)
    fn, _args = tp.DeviceBatchDecoder(r, 'cpu').pack(_parsed(r), T)
    assert fn.func is tp._decode_fuse8 and fn.keywords['diff_order'] == 2
    _decodes_on_the_port(r, arr, T, tmp_path_)


def test_raw_low_plane_takes_generic_route(tmp_path_, monkeypatch):
    """The 40-channel signal of the JAX fuse8 test codes its low byte
    plane RAW, which takes the generic route (K4)."""
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    arr = to_int16(make_signal('colored', ns=4 * 300, nc=40))
    r = _compressed(tmp_path_, arr, 300)
    fn, _args = tp.DeviceBatchDecoder(r, 'cpu').pack(_parsed(r), 300)
    assert fn.func is tp._decode_generic
    _decodes_on_the_port(r, arr, 300, tmp_path_)


@pytest.mark.parametrize('name', GEOMS)
def test_reader_entry_points(tmp_path_, monkeypatch, name):
    """decompress(...).to_array / to_tensor / tofile through the port,
    plus a span that starts and ends mid-file."""
    arr, r, T = _file(tmp_path_, name, monkeypatch)
    r.close()
    mt.reset_launch_counts()
    rp = mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch',
                       device='cpu', quiet=True)
    try:
        assert isinstance(rp, mt.Reader)
        assert np.array_equal(rp.to_array(), arr)
        n = rp.n_chunks
        assert np.array_equal(rp.to_array(1, n - 1), arr[T:])
        assert np.array_equal(rp.to_array(0, n - 2), arr[:(n - 1) * T])
        t = rp.to_tensor()
        assert t.device.type == 'cpu' and tuple(t.shape) == arr.shape
        assert np.array_equal(t.numpy(), arr)
        out = tmp_path_ / 'o.bin'
        rp.tofile(out)
        assert np.array_equal(np.fromfile(out, arr.dtype).reshape(arr.shape),
                              arr)
        # Windows stay on the host codec in this slice.
        assert np.array_equal(rp[5:T + 7, 2:9], arr[5:T + 7, 2:9])
        counts = mt.launch_counts()
        assert counts['host_fallback_chunks'] == 0
        # CPU decodes run the twins: no kernel launch is counted (18
        # kernel forms, the int64 scans and the table builder among them,
        # and 2 host counters).
        assert len(counts) == 20
        assert not any(counts.values())
    finally:
        rp.close()


def test_unsupported_batch_goes_to_the_host(tmp_path_, monkeypatch):
    """A batch the JAX package also leaves to the host (supported()
    False: here a non-native byte order, big-endian int16) decodes on
    the host codec and is counted."""
    rng = np.random.default_rng(4)
    arr = np.cumsum(rng.integers(-9, 10, size=(600, 6)), axis=0).astype(
        '>i2')
    path = write_arr(tmp_path_ / 'q.bin', arr)
    compress(path, tmp_path_ / 'q.cbin', tmp_path_ / 'q.ch',
             sample_rate=200.0, n_channels=6, dtype='>i2',
             algorithm='ans', quiet=True, check_after_compress=False,
             device='none')
    mt.reset_launch_counts()
    rp = mt.decompress(tmp_path_ / 'q.cbin', tmp_path_ / 'q.ch',
                       device='cpu', quiet=True)
    try:
        assert np.array_equal(rp.to_array(), arr)
        assert mt.launch_counts()['host_fallback_chunks'] == rp.n_chunks
        assert np.array_equal(rp.to_tensor().numpy(), arr)
    finally:
        rp.close()


def test_peek_desc_guards_tail_split(tmp_path_, monkeypatch):
    """A header whose bit6 sub-row count is out of range is rejected
    before it shapes the run grouping (the port's ``peek_desc`` checks
    the range the full parse checks)."""
    _arr, r, _T = _file(tmp_path_, 'ragged129', monkeypatch)
    r.close()
    cbin = tmp_path_ / 'p.cbin'
    good = cbin.read_bytes()
    assert good[6] & 64 and good[18:20] == (8).to_bytes(2, 'little')
    for bad in (0, 257, 1000):
        cbin.write_bytes(good[:18] + bad.to_bytes(2, 'little') + good[20:])
        rp = mt.decompress(cbin, tmp_path_ / 'p.ch', device='cpu',
                           quiet=True)
        try:
            with pytest.raises(IOError, match='tail_split'):
                rp.to_array()
        finally:
            rp.close()


def test_cuda_device_raises_without_a_gpu(tmp_path_, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        resolve_device('cuda')
    _arr, r, _T = _file(tmp_path_, 'wide40_int16', monkeypatch)
    r.close()
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', quiet=True)
    with pytest.raises(ValueError):
        resolve_device('meta')
    assert resolve_device('cpu') == torch.device('cpu')


def test_port_never_imports_jax(tmp_path_):
    """Compressing and decoding with the port, reading a window,
    verifying, transcoding, streaming, decoding two probes, running a
    command of its CLI and a phase of its bench (``--device cpu``) load
    neither JAX nor any module of the JAX
    package (this test process has both loaded already, so it runs in a
    fresh one)."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import mtscomp_tpu_torch as mt
        d = sys.argv[1]
        rng = np.random.default_rng(1)
        arr = np.cumsum(rng.normal(0, 5, size=(2000, 129)),
                        axis=0).astype(np.int16)
        arr.tofile(d + '/s.bin')
        mt.compress(d + '/s.bin', d + '/s.cbin', d + '/s.ch',
                    sample_rate=1000.0, n_channels=129, dtype='int16',
                    algorithm='ans', quiet=True, device='cpu',
                    ans_seg_log2=12, check_after_compress=False)
        assert mt.launch_counts()['host_encoded_chunks'] == 0
        r = mt.decompress(d + '/s.cbin', d + '/s.ch', device='cpu',
                          quiet=True)
        assert np.array_equal(r.to_array(), arr)
        assert mt.launch_counts()['host_fallback_chunks'] == 0
        assert np.array_equal(r[900:1100], arr[900:1100])   # a window
        assert r._dev_cache is not None
        r2 = mt.decompress(d + '/s.cbin', d + '/s.ch', device='cpu',
                           quiet=True)
        for out in mt.decompress_multi([r, r2]):
            assert np.array_equal(out, arr)
        r.close()
        r2.close()
        assert mt.verify_file(d + '/s.cbin', quiet=True,
                              device='cpu')['ok']
        mt.transcode(d + '/s.cbin', out=d + '/z.cbin', algorithm='zlib',
                     quiet=True, device='cpu')
        mt.transcode(d + '/z.cbin', out=d + '/a.cbin', algorithm='ans',
                     quiet=True, device='cpu', ans_seg_log2=12)
        assert (open(d + '/a.cbin', 'rb').read()
                == open(d + '/s.cbin', 'rb').read())
        with mt.StreamWriter(d + '/l.cbin', d + '/l.ch', sample_rate=1000.0,
                             n_channels=129, dtype='int16',
                             algorithm='ans') as w:
            w.append(arr)
        from mtscomp_tpu_torch.parallel.distributed import compress_multihost
        compress_multihost(d + '/s.bin', d + '/m.cbin', d + '/m.ch', 2,
                           sample_rate=1000.0, n_channels=129,
                           dtype='int16', algorithm='ans', quiet=True,
                           device='none', ans_seg_log2=12)
        from mtscomp_tpu_torch import cli
        from mtscomp_tpu_torch.utils import trace
        trace.enable_tracing()
        cli.main(['mtsdecomp', d + '/z.cbin', '-o', d + '/z.bin',
                  '--device', 'none'])
        assert open(d + '/z.bin', 'rb').read() == arr.tobytes()
        import json, os
        from mtscomp_tpu_torch import bench
        b = d + '/bench'
        os.mkdir(b)
        arr.tofile(b + '/bench.bin')
        open(b + '/bench.json', 'w').write(json.dumps(
            {'device': 'cpu', 'seconds': 2, 'sample_rate': 1000.0,
             'n_channels': 129}))
        bench.main(['--phase', 'encode', '--dir', b])   # a bench phase
        assert json.load(open(b + '/phase_encode.json'))['byte_exact']
        bad = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'mtscomp_tpu')]
        assert not bad, 'loaded %s' % bad
        print('OK')
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop('MTSCOMP_PALLAS_INTERPRET', None)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path_)],
                          cwd=str(tmp_path_), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('OK')


GOLDEN = Path(__file__).resolve().parent / 'golden'


@pytest.mark.parametrize('stem', ['ts_int16_129ch', 'int16_19ch',
                                  'mt_int16_48ch', 'o2_int16_17ch',
                                  'adapt_int16_13ch', 'f32_11ch',
                                  'uint8_7ch'])
def test_golden_files(stem):
    """Every frozen ans file decodes byte-exactly through the port with
    no chunk on the host codec: the ragged-tail artifact on the fuse8
    route, the others (multi-table, order 2, adaptive bit5, bitcast
    float32, uint8) on the generic one."""
    mt.reset_launch_counts()
    rp = mt.decompress(GOLDEN / ('ans_%s.cbin' % stem),
                       GOLDEN / ('ans_%s.ch' % stem), device='cpu',
                       quiet=True)
    try:
        want = np.fromfile(GOLDEN / ('np_%s.bin' % stem),
                           rp.dtype).reshape(-1, rp.n_channels)
        assert np.array_equal(rp.to_array(), want)
        assert np.array_equal(rp.to_tensor().numpy(), want)
        assert mt.launch_counts()['host_fallback_chunks'] == 0
        assert np.array_equal(rp[:], want)           # the chunk cache
    finally:
        rp.close()


def test_mixed_plane_modes_decode_in_mode_uniform_batches(monkeypatch):
    """A run whose plane modes change between chunks (the frozen order-2
    file: chunk 0 codes its high byte CONST, chunks 1 and 2 rANS; chunk
    3 is shorter) decodes on the device one mode-uniform batch at a
    time, where the JAX package sends the run to the host codec."""
    batches = []
    real = tp.DeviceBatchDecoder.decode_tensor

    def spy(self, parsed_list, n_samples):
        batches.append(len(parsed_list))
        return real(self, parsed_list, n_samples)

    monkeypatch.setattr(tp.DeviceBatchDecoder, 'decode_tensor', spy)
    stem = 'o2_int16_17ch'
    rp = mt.decompress(GOLDEN / ('ans_%s.cbin' % stem),
                       GOLDEN / ('ans_%s.ch' % stem), device='cpu',
                       quiet=True)
    try:
        want = np.fromfile(GOLDEN / ('np_%s.bin' % stem),
                           rp.dtype).reshape(-1, rp.n_channels)
        mt.reset_launch_counts()
        assert np.array_equal(rp.to_array(), want)
        assert batches == [1, 2, 1]
        assert mt.launch_counts()['host_fallback_chunks'] == 0
    finally:
        rp.close()


# --- which chunks decode together: judged once, in _uniform_batches --------

def _port_files(tmp_path, arrs, T, stem='j'):
    """Each source compressed by the port's host codec: (cbin, ch)."""
    files = []
    for p, arr in enumerate(arrs):
        path = write_arr(tmp_path / ('%s%d.bin' % (stem, p)), arr)
        cbin = tmp_path / ('%s%d.cbin' % (stem, p))
        ch = tmp_path / ('%s%d.ch' % (stem, p))
        mt.compress(path, cbin, ch, sample_rate=float(T),
                    n_channels=arr.shape[1], dtype=str(arr.dtype),
                    algorithm='ans', quiet=True, device='none',
                    check_after_compress=False)
        files.append((cbin, ch))
    return files


def _judgements(monkeypatch):
    """Every ``supported()`` call's batch, in call order (the lists are
    kept, so that the ids of their parsed chunks stay distinct)."""
    calls = []
    real = tp.DeviceBatchDecoder.supported

    def spy(self, parsed_list, n_samples):
        calls.append(list(parsed_list))
        return real(self, parsed_list, n_samples)

    monkeypatch.setattr(tp.DeviceBatchDecoder, 'supported', spy)
    return calls


def _walks(n_probes, T, n_chunks, C=12):
    rng = np.random.default_rng(21)
    return [np.cumsum(rng.normal(0, 6, size=(n_chunks * T, C)),
                      axis=0).astype(np.int16) for _ in range(n_probes)]


#: call -> (probes, columns judged): ``to_array`` in batches of 2, 2 and
#: 1 chunks (``batch_chunks=2``), a window over chunks 1 and 2 of a
#: fresh reader, ``decompress_multi`` of two probes in batches of 2, 2
#: and 1 chunks a probe (``batch_chunks=4``).
JUDGED = {'to_array': (1, 5), 'window': (1, 2), 'multi': (2, 5)}


@pytest.mark.parametrize('call', sorted(JUDGED))
def test_each_batch_is_judged_once(tmp_path_, monkeypatch, call):
    """``supported()`` judges each column a batch adds once, a first
    column alone and a later one with the batch's first chunk, and never
    a finished batch again."""
    import mtscomp_tpu_torch.config as mt_config
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path_ / '.mtsport')
    T = 200
    n_probes, n_cols = JUDGED[call]
    arrs = _walks(n_probes, T, 5)
    readers = [mt.decompress(c, s, device='cpu', quiet=True,
                             batch_chunks=2 * n_probes)
               for c, s in _port_files(tmp_path_, arrs, T)]
    calls = _judgements(monkeypatch)
    try:
        if call == 'to_array':
            got, want = [readers[0].to_array()], arrs
        elif call == 'window':
            got, want = [readers[0][T + 7:2 * T + 9]], \
                [arrs[0][T + 7:2 * T + 9]]
        else:
            got, want = mt.decompress_multi(readers), arrs
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    finally:
        for r in readers:
            r.close()
    assert len(calls) == n_cols
    added = set()
    for batch in calls:
        assert len(batch) in (n_probes, n_probes + 1)
        added.add(tuple(id(p) for p in batch[-n_probes:]))
    assert len(added) == n_cols


#: case -> what the card declines in a batch's first column alone: a
#: one-chunk file in a foreign byte order (``to_array`` and a window), or
#: probe 1's first chunk, whose plane modes differ from reader 0's
#: (``decompress_multi`` of the whole range, and of chunk 0 alone).
DECLINED = ('foreign_one_chunk', 'multi_first_chunk_differs',
            'multi_first_chunk_differs_one_column')


@pytest.mark.parametrize('case', DECLINED)
def test_a_declined_first_column_goes_to_the_host(tmp_path_, monkeypatch,
                                                  case):
    """A batch whose first column the card declines alone decodes on the
    host codec (counted), or, for probes, falls back per reader."""
    import mtscomp_tpu_torch.config as mt_config
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path_ / '.mtsport')
    T = 200
    decodes = []
    real = tp.DeviceBatchDecoder._decode_shards

    def spy(self, parsed_list, n_samples, mesh=None):
        decodes.append(len(parsed_list))
        return real(self, parsed_list, n_samples, mesh)

    monkeypatch.setattr(tp.DeviceBatchDecoder, '_decode_shards', spy)
    mt.reset_launch_counts()
    if case == 'foreign_one_chunk':
        arr = _walks(1, T, 1, C=6)[0].astype('>i2')
        (cbin, ch), = _port_files(tmp_path_, [arr], T)
        r = mt.decompress(cbin, ch, device='cpu', quiet=True)
        try:
            assert np.array_equal(r.to_array(), arr)
            assert np.array_equal(r[3:150], arr[3:150])
        finally:
            r.close()
        assert mt.launch_counts()['host_fallback_chunks'] == 2
        assert decodes == []
        return
    arrs = _walks(2, T, 3)
    arrs[1][:T] = arrs[1][0]           # CONST planes in chunk 0 alone
    readers = [mt.decompress(c, s, device='cpu', quiet=True)
               for c, s in _port_files(tmp_path_, arrs, T)]
    last = 0 if case.endswith('one_column') else 2
    try:
        for got, arr in zip(mt.decompress_multi(readers, last_chunk=last),
                            arrs):
            assert np.array_equal(got, arr[:(last + 1) * T])
    finally:
        for r in readers:
            r.close()
    # Per-reader to_array: no decode holds chunks of both probes.
    assert decodes and all(n <= last + 1 for n in decodes)
