"""PyTorch port: multi-device ``mesh=`` (``parallel/mesh.py``, the sharded
decode, encode and ``decompress_multi``).

The twin of the JAX package's mesh tests (``tests/test_device.py``:
``test_pipeline_sharded_mesh``, ``test_device_encode_sharded_mesh``,
``test_multi_probe_mesh``, ``test_ragged_tail_split_mesh``) at widths 1,
2, 4 and 8: the port's mesh is ``['cpu'] * n`` (the kernels' plain
twins, one shard each), the JAX package's the first n of the conftest's
8 virtual CPU devices. The port's per-shard staged arrays equal the JAX
``pack(mesh=)`` arrays cut along their leading axis (Pallas interpret
mode, so that the JAX package packs the octet rows and the ragged tail
as its kernel takes them); decodes equal the source and the JAX
``decode_batch(mesh=)`` (its XLA scan decoder on the CPU); encodes equal
the host codec's bytes and the JAX ``encode_batch(mesh=)``'s; tolerance
0 throughout.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
from mtscomp_tpu.parallel import pipeline as jp  # noqa: E402
from mtscomp_tpu.parallel.mesh import chunk_mesh as jax_chunk_mesh  # noqa

import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402
from mtscomp_tpu_torch.parallel.mesh import ChunkMesh, chunk_mesh  # noqa

from conftest import make_signal, to_int16, write_arr  # noqa: E402

WIDTHS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')


def _meshes(n):
    """The port's and the JAX package's mesh of width ``n``."""
    return chunk_mesh(['cpu'] * n), jax_chunk_mesh(jax.devices('cpu')[:n])


def _walk(C, T, n_chunks, seed, step=5.0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, step, size=(n_chunks * T, C)),
                     axis=0).astype(np.int16)


#: name -> (source, samples a chunk, compress options): the ragged-tail
#: fuse8 geometry of ``test_ragged_tail_split_mesh`` (129 channels, a
#: 1-channel tail), the uniform fuse8 one (128 channels), a generic one
#: (16 channels: K1, then K4's plane form) and constant data (no rANS
#: group: never sharded).
FILES = {
    'tail129': (lambda: _walk(129, 1000, 8, 11), 1000,
                {'ans_seg_log2': 12}),
    'uniform128': (lambda: _walk(128, 1000, 8, 8), 1000,
                   {'ans_seg_log2': 12}),
    'generic16': (lambda: to_int16(make_signal('colored', ns=8 * 2000,
                                               nc=16)), 2000,
                  {'ans_seg_log2': 12}),
    'constant': (lambda: np.full((8 * 500, 6), 7, np.int16), 500, {}),
}


def _open(tmp_path, name):
    """(source, T, port reader on 'cpu', JAX reader, parsed chunks)."""
    make, T, opts = FILES[name]
    arr = make()
    path = write_arr(tmp_path / (name + '.bin'), arr)
    cbin, ch = tmp_path / (name + '.cbin'), tmp_path / (name + '.ch')
    mt.compress(path, cbin, ch, sample_rate=float(T), n_channels=arr.shape[1],
                dtype='int16', algorithm='ans', quiet=True, device='none',
                check_after_compress=False, **opts)
    port = mt.decompress(cbin, ch, device='cpu', quiet=True)
    jaxr = ref.decompress(cbin, ch, quiet=True)
    parsed = [port.codec.parse(tp._read_payload(port, i))
              for i in range(port.n_chunks)]
    return arr, T, port, jaxr, parsed


@pytest.mark.parametrize('n', WIDTHS)
def test_chunk_mesh_matches_jax(n):
    mesh, jmesh = _meshes(n)
    assert isinstance(mesh, ChunkMesh)
    assert mesh.axis_names == jmesh.axis_names == ('chunks',)
    assert dict(mesh.shape) == dict(jmesh.shape) == {'chunks': n}
    assert mesh.size == jmesh.size == n
    assert list(mesh) == [torch.device('cpu')] * n


@pytest.mark.parametrize('n', WIDTHS)
@pytest.mark.parametrize('name', ['tail129', 'uniform128', 'generic16'])
def test_pack_shards_equal_jax_pack(tmp_path, monkeypatch, name, n):
    """Each shard's staged tensors are the JAX ``pack(mesh=)`` arrays of
    that shard: groups chunk-major in the shard, the ragged tail after
    the shard's full groups, each group's words in the batch's longest
    stream's rows (the JAX package's further rows all zero); the shards
    decode to the source."""
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    arr, T, port, jaxr, parsed = _open(tmp_path, name)
    mesh, jmesh = _meshes(n)
    try:
        jdec = jp.DeviceBatchDecoder(jaxr)
        _fn, jargs = jdec.pack(parsed, T, mesh=jmesh)
        rows = -(-max(g['words'].size for p in parsed for g in p['groups'])
                 // 128)
        assert not tp.args_from_jax_pack(jargs, 'cpu')[1][:, rows * 128:].any()
        want = tp.args_from_jax_pack(jargs, 'cpu', rows=rows)
        dec = tp.DeviceBatchDecoder(port, 'cpu')
        fn, shards = dec.pack(parsed, T, mesh=mesh)
        assert dec.last_tail == jdec.last_tail
        if name == 'tail129':
            assert dec.last_tail == (1, 8, (128,) * 8)
        assert len(shards) == n
        outs, used = [], []
        for s, shard in enumerate(shards):
            for got, full in zip(shard, want):
                part = full.shape[0] // n
                assert torch.equal(got, full[s * part:(s + 1) * part])
            out, u = fn(*shard)
            outs.append(out)
            used.append(u)
        tp.check_words_used(parsed, torch.cat(used))
        got = torch.cat(outs).numpy().view(arr.dtype)
        assert np.array_equal(got.reshape(arr.shape), arr)
    finally:
        port.close()
        jaxr.close()


@pytest.mark.parametrize('n', WIDTHS)
@pytest.mark.parametrize('name', ['tail129', 'generic16'])
def test_decode_batch_mesh_matches_source_and_jax(tmp_path, name, n):
    arr, T, port, jaxr, parsed = _open(tmp_path, name)
    mesh, jmesh = _meshes(n)
    try:
        dec = tp.DeviceBatchDecoder(port, 'cpu')
        got = dec.decode_batch(parsed, T, mesh=mesh)
        assert got.dtype == arr.dtype
        assert np.array_equal(got.reshape(arr.shape), arr)
        want = jp.DeviceBatchDecoder(jaxr).decode_batch(parsed, T,
                                                        mesh=jmesh)
        assert got.tobytes() == np.asarray(want).tobytes()
    finally:
        port.close()
        jaxr.close()


def test_decode_batch_mesh_audits_every_shard(tmp_path):
    """A group that lost a word in the last shard fails the word audit,
    as it does unsharded."""
    arr, T, port, jaxr, parsed = _open(tmp_path, 'tail129')
    try:
        g = parsed[-1]['groups'][0]
        g['words'] = g['words'][:-1]
        with pytest.raises(IOError, match='payload words'):
            tp.DeviceBatchDecoder(port, 'cpu').decode_batch(
                parsed, T, mesh=chunk_mesh(['cpu'] * 4))
    finally:
        port.close()
        jaxr.close()


@pytest.mark.parametrize('n', [3, 5])
def test_mesh_that_does_not_divide_the_batch_raises(tmp_path, n):
    """8 chunks over 3 or 5 devices: the port's ValueError carries the
    JAX assertion's message."""
    arr, T, port, jaxr, parsed = _open(tmp_path, 'generic16')
    mesh, jmesh = _meshes(n)
    try:
        with pytest.raises(ValueError,
                           match='chunk batch must divide the mesh'):
            tp.DeviceBatchDecoder(port, 'cpu').decode_batch(parsed, T,
                                                            mesh=mesh)
        with pytest.raises(AssertionError,
                           match='chunk batch must divide the mesh'):
            jp.DeviceBatchDecoder(jaxr).pack(parsed, T, mesh=jmesh)
    finally:
        port.close()
        jaxr.close()


def test_batch_without_rans_groups_is_not_sharded(tmp_path):
    """Constant chunks have no rANS group: decoded unsharded (one shard on
    the decoder's device), whatever the width, as in the JAX package."""
    arr, T, port, jaxr, parsed = _open(tmp_path, 'constant')
    mesh, jmesh = _meshes(3)
    try:
        dec = tp.DeviceBatchDecoder(port, 'cpu')
        _fn, shards = dec.pack(parsed, T, mesh=mesh)
        assert len(shards) == 1 and shards[0][0].shape[0] == 1
        got = dec.decode_batch(parsed, T, mesh=mesh)
        assert np.array_equal(got.reshape(arr.shape), arr)
        want = jp.DeviceBatchDecoder(jaxr).decode_batch(parsed, T,
                                                        mesh=jmesh)
        assert got.tobytes() == np.asarray(want).tobytes()
    finally:
        port.close()
        jaxr.close()


def _writers(tmp_path, arr, sr, **opts):
    path = write_arr(tmp_path / 'e.bin', arr)
    kw = dict(algorithm='ans', quiet=True, **opts)
    w = mt.Writer(device='cpu', **kw)
    jw = ref.Writer(**kw)
    for x in (w, jw):
        x.open(path, sample_rate=float(sr), n_channels=arr.shape[1],
               dtype=str(arr.dtype))
    return w, jw


#: name -> (source, samples a chunk, Writer options): the JAX package's
#: sharded-encode file (4 chunks, 32 channels; 4 groups over up to 8
#: devices, so filler groups), its segment-table file, and a batch whose
#: plane modes change (two mode-uniform sub-batches, each sharded).
ENCODE_FILES = {
    'colored32': (lambda: to_int16(make_signal('colored', ns=4 * 2000,
                                               nc=32)), 2000,
                  {'ans_seg_log2': 11}),
    'segment_tables': (lambda: to_int16(make_signal('white_sine',
                                                    ns=4 * 2000, nc=32)),
                       2000, {'ans_seg_log2': 11,
                              'ans_table_mode': 'segment'}),
    'mixed_modes': (lambda: np.concatenate(
        [_walk(24, 1000, 4, 3, step=2.0),
         to_int16(make_signal('randn', ns=4 * 1000, nc=24))]), 1000,
        {'time_diff_order': 1, 'do_spatial_diff': False,
         'ans_seg_log2': 11}),
}


@pytest.mark.parametrize('n', WIDTHS)
@pytest.mark.parametrize('name', sorted(ENCODE_FILES))
def test_encode_batch_mesh_matches_host_codec_and_jax(tmp_path, name, n,
                                                      monkeypatch):
    calls = []
    real = tp.encode_groups

    def spy(symbols, *args):
        calls.append(symbols.shape[0])
        return real(symbols, *args)

    monkeypatch.setattr(tp, 'encode_groups', spy)
    make, sr, opts = ENCODE_FILES[name]
    arr = make()
    w, jw = _writers(tmp_path, arr, sr, **opts)
    mesh, jmesh = _meshes(n)
    try:
        chunks = np.stack([np.asarray(w.get_chunk(i))
                           for i in range(w.n_chunks)])
        got = tp.DeviceBatchEncoder(w).encode_batch(chunks, mesh=mesh)
        assert got is not None and len(got) == len(chunks)
        for chunk, payload in zip(chunks, got):
            assert payload == w.codec.encode(w._transform_chunk(chunk),
                                             order=w.chunk_order)
        if name != 'mixed_modes':     # (its two XLA compiles a width)
            want = jp.DeviceBatchEncoder(jw).encode_batch(chunks,
                                                          mesh=jmesh)
            assert got == want
        # K6 once per shard per (sub-)batch, every shard the same size.
        assert calls and len(calls) % n == 0
        assert len(set(calls)) <= (2 if name == 'mixed_modes' else 1)
    finally:
        w.close()
        jw.close()


def _probes(tmp_path, n_probes, n_chunks, **reader_kw):
    port, jaxr, arrs = [], [], []
    for i in range(n_probes):
        arr = to_int16(make_signal('colored', ns=n_chunks * 2000,
                                   nc=16)) + i
        path = write_arr(tmp_path / ('p%d.bin' % i), arr)
        cbin, ch = tmp_path / ('p%d.cbin' % i), tmp_path / ('p%d.ch' % i)
        mt.compress(path, cbin, ch, sample_rate=2000.0, n_channels=16,
                    dtype='int16', algorithm='ans', quiet=True,
                    device='none', ans_seg_log2=12,
                    check_after_compress=False)
        port.append(mt.decompress(cbin, ch, device='cpu', quiet=True,
                                  **reader_kw))
        jaxr.append(ref.decompress(cbin, ch, quiet=True))
        arrs.append(arr)
    return port, jaxr, arrs


@pytest.fixture
def batches(monkeypatch):
    """(chunks, shards) of each ``pack`` the port runs."""
    calls = []
    real = tp.DeviceBatchDecoder.pack

    def spy(self, parsed_list, n_samples, mesh=None):
        fn, staged = real(self, parsed_list, n_samples, mesh=mesh)
        calls.append((len(parsed_list),
                      len(staged) if isinstance(staged, list) else None))
        return fn, staged

    monkeypatch.setattr(tp.DeviceBatchDecoder, 'pack', spy)
    return calls


@pytest.mark.parametrize('n', WIDTHS)
def test_decompress_multi_mesh_matches_sources_and_jax(tmp_path, n,
                                                       batches):
    """Four probes of two chunks, one merged batch of 8 sharded n ways."""
    port, jaxr, arrs = _probes(tmp_path, 4, 2)
    mesh, jmesh = _meshes(n)
    try:
        outs = mt.decompress_multi(port, mesh=mesh)
        assert batches == [(8, n)]
        want = jp.decompress_multi(jaxr, mesh=jmesh)
        for got, w, arr in zip(outs, want, arrs):
            assert got.tobytes() == np.asarray(w).tobytes() == arr.tobytes()
    finally:
        for r in port + jaxr:
            r.close()


@pytest.mark.parametrize('n', WIDTHS)
def test_decompress_multi_mesh_cut_by_batch_chunks(tmp_path, n, batches):
    """``batch_chunks=4`` over four probes allows one chunk a probe a
    batch; a mesh of 8 needs two (4 probes x 2 = 8 chunks), so the cut
    keeps every batch a multiple of the width."""
    port, jaxr, arrs = _probes(tmp_path, 4, 4, batch_chunks=4)
    try:
        outs = mt.decompress_multi(port, mesh=chunk_mesh(['cpu'] * n))
        per_batch = 8 if n == 8 else 4
        assert batches == [(per_batch, n)] * (16 // per_batch)
        for got, arr in zip(outs, arrs):
            assert got.tobytes() == arr.tobytes()
    finally:
        for r in port + jaxr:
            r.close()


def test_decompress_multi_mesh_that_does_not_divide_raises(tmp_path):
    """Three probes of one chunk over two devices: the merged batch (3
    chunks) does not divide the mesh, in either package."""
    port, jaxr, _arrs = _probes(tmp_path, 3, 1)
    mesh, jmesh = _meshes(2)
    try:
        with pytest.raises(ValueError,
                           match='chunk batch must divide the mesh'):
            mt.decompress_multi(port, mesh=mesh)
        with pytest.raises(AssertionError,
                           match='chunk batch must divide the mesh'):
            jp.decompress_multi(jaxr, mesh=jmesh)
    finally:
        for r in port + jaxr:
            r.close()


def test_chunk_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match='not both'):
        chunk_mesh(['cpu'], n_devices=1)
    with pytest.raises(ValueError, match='not both'):
        jax_chunk_mesh(jax.devices('cpu')[:1], n_devices=1)
    with pytest.raises(ValueError, match='Requested a 9-device mesh'):
        jax_chunk_mesh(n_devices=9)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(ValueError, match='Requested a 2-device mesh but '
                                         'only 0 devices'):
        chunk_mesh(n_devices=2)
    with pytest.raises(ValueError, match='at least one device'):
        chunk_mesh()
    with pytest.raises(ValueError, match='at least one device'):
        chunk_mesh([])
    with pytest.raises(ValueError, match='unknown device'):
        chunk_mesh(['tpu'])
    # Two visible cards (the count patched; nothing is launched): one
    # shard a card, so a card may not repeat.
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert list(chunk_mesh()) == [torch.device('cuda', 0),
                                  torch.device('cuda', 1)]
    assert list(chunk_mesh(n_devices=1)) == [torch.device('cuda', 0)]
    with pytest.raises(ValueError, match='Requested a 3-device mesh'):
        chunk_mesh(n_devices=3)
    with pytest.raises(ValueError, match='appears twice'):
        chunk_mesh(['cuda:1', torch.device('cuda', 1)])


@pytest.mark.parametrize('mesh', [object(), 2, ['cpu', 'cpu']])
def test_entry_points_refuse_what_is_not_a_mesh(tmp_path, mesh):
    arr, T, port, jaxr, parsed = _open(tmp_path, 'generic16')
    try:
        dec = tp.DeviceBatchDecoder(port, 'cpu')
        with pytest.raises(TypeError, match='chunk_mesh'):
            dec.pack(parsed, T, mesh=mesh)
        with pytest.raises(TypeError, match='chunk_mesh'):
            dec.decode_batch(parsed, T, mesh=mesh)
        w = mt.Writer(algorithm='ans', quiet=True, device='cpu')
        w.open(write_arr(tmp_path / 'w.bin', arr), sample_rate=2000.0,
               n_channels=16, dtype='int16')
        try:
            with pytest.raises(TypeError, match='chunk_mesh'):
                tp.DeviceBatchEncoder(w).encode_batch(
                    np.stack([w.get_chunk(0)]), mesh=mesh)
        finally:
            w.close()
    finally:
        port.close()
        jaxr.close()
