"""PyTorch port: ``transcode`` / ``mtsrecompress`` (format conversion
without the raw file).

The JAX package's ``tests/test_transcode.py`` run against the port's own
``transcode.py``, then the two packages against each other: a file
written by one package is transcoded by the other, and both transcodes
of one source are the same bytes (``.cbin`` and ``.ch``).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
import mtscomp_tpu.config as ref_config  # noqa: E402
import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch import compress, decompress, transcode  # noqa: E402
from conftest import make_signal, to_int16, write_arr  # noqa: E402


@pytest.fixture
def tmp_path_(tmp_path, monkeypatch):
    """A directory that holds both packages' user config files; the
    port's names the host codec as its default device (no GPU here:
    tests that want the kernels' twins pass ``device='cpu'``)."""
    monkeypatch.setattr(ref_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp_torch')
    mt_config.CONFIG_PATH.write_text(json.dumps({'device': 'none'}))
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    return tmp_path


SR = 2000.0
NC = 17


def _compressed(tmp_path_, algorithm, ns=3 * 2000 + 456, **kwargs):
    arr = to_int16(make_signal('colored', ns=ns, nc=NC))
    raw = write_arr(tmp_path_ / 'raw.bin', arr)
    compress(raw, tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm=algorithm, quiet=True, **kwargs)
    return arr


def test_zlib_to_ans(tmp_path_):
    arr = _compressed(tmp_path_, 'zlib')
    ratio = transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                      tmp_path_ / 'out.cbin', algorithm='ans', quiet=True)
    assert 0 < ratio < 1
    meta = json.loads((tmp_path_ / 'out.ch').read_text())
    src = json.loads((tmp_path_ / 'in.ch').read_text())
    assert meta['algorithm'] == 'ans'
    assert meta['chunk_bounds'] == src['chunk_bounds']
    assert meta['sha1_uncompressed'] == src['sha1_uncompressed']
    r = decompress(tmp_path_ / 'out.cbin', tmp_path_ / 'out.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
        # Random access on the transcoded file.
        assert np.array_equal(r[1234:4321], arr[1234:4321])
    finally:
        r.close()
    # ans output is smaller than the zlib input on this signal.
    assert (tmp_path_ / 'out.cbin').stat().st_size \
        < (tmp_path_ / 'in.cbin').stat().st_size


def test_ans_to_zlib_matches_legacy_writer(tmp_path_):
    """Legacy export: ans -> zlib equals compressing the raw file with
    the v1 writer (itself byte-identical to the reference)."""
    arr = _compressed(tmp_path_, 'ans')
    transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
              tmp_path_ / 'out.cbin', algorithm='zlib', quiet=True)
    compress(tmp_path_ / 'raw.bin', tmp_path_ / 'legacy.cbin',
             tmp_path_ / 'legacy.ch', sample_rate=SR, n_channels=NC,
             dtype='int16', algorithm='zlib', quiet=True)
    assert (tmp_path_ / 'out.cbin').read_bytes() == \
        (tmp_path_ / 'legacy.cbin').read_bytes()
    meta = json.loads((tmp_path_ / 'out.ch').read_text())
    legacy = json.loads((tmp_path_ / 'legacy.ch').read_text())
    assert meta['sha1_compressed'] == legacy['sha1_compressed']
    assert meta['chunk_offsets'] == legacy['chunk_offsets']
    assert 'ans_seg_log2' not in meta


def test_transcode_reencode_with_segment_tables(tmp_path_):
    """ans -> ans with clustered tables shrinks heterogeneous data."""
    rng = np.random.default_rng(2)
    stds = np.logspace(0.0, 1.6, NC)
    arr = np.clip(np.cumsum(rng.normal(0, 1, (6000, NC)) * stds, axis=0),
                  -30000, 30000).astype(np.int16)
    raw = write_arr(tmp_path_ / 'raw.bin', arr)
    compress(raw, tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', ans_seg_log2=12, quiet=True,
             ans_table_mode='plane')   # start from plane tables
    transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
              tmp_path_ / 'out.cbin', algorithm='ans',
              ans_table_mode='segment', ans_seg_log2=12, quiet=True)
    assert (tmp_path_ / 'out.cbin').stat().st_size \
        < (tmp_path_ / 'in.cbin').stat().st_size
    meta = json.loads((tmp_path_ / 'out.ch').read_text())
    assert meta.get('ans_table_mode') == 'segment'
    r = decompress(tmp_path_ / 'out.cbin', tmp_path_ / 'out.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_transcode_detects_corrupt_source(tmp_path_):
    _compressed(tmp_path_, 'zlib')
    data = bytearray((tmp_path_ / 'in.cbin').read_bytes())
    # Flip a byte mid-stream: either the chunk fails to inflate (IOError
    # from the decoder) or it inflates to wrong bytes, which the
    # sha1_uncompressed re-derivation must catch.
    data[len(data) // 2] ^= 0x01
    (tmp_path_ / 'in.cbin').write_bytes(bytes(data))
    with pytest.raises(IOError):
        transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                  tmp_path_ / 'out.cbin', algorithm='ans', quiet=True)
    assert not (tmp_path_ / 'out.cbin').exists()
    assert not (tmp_path_ / 'out.ch').exists()


def test_transcode_guards_paths(tmp_path_):
    _compressed(tmp_path_, 'zlib')
    with pytest.raises(ValueError, match='explicit output'):
        transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch', quiet=True)
    with pytest.raises(ValueError, match='overwrite its input'):
        transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                  tmp_path_ / 'in.cbin', quiet=True)
    (tmp_path_ / 'out.cbin').write_bytes(b'x')
    with pytest.raises(ValueError, match='already exists'):
        transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                  tmp_path_ / 'out.cbin', quiet=True)
    # overwrite=True proceeds.
    transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
              tmp_path_ / 'out.cbin', overwrite=True, quiet=True)


def test_transcode_order_argument_guards(tmp_path_):
    """'auto' gets the crafted contract error (not a raw int() crash),
    and a corrupt SOURCE sidecar order is named in the message (it used
    to read 'got None' — the unset override, not the bad value)."""
    import json
    _compressed(tmp_path_, 'ans')
    with pytest.raises(ValueError, match="inherit.*or 1 or 2"):
        transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                  tmp_path_ / 'out.cbin', time_diff_order='auto',
                  quiet=True)
    meta = json.loads((tmp_path_ / 'in.ch').read_text())
    meta['time_diff_order'] = 3
    (tmp_path_ / 'in.ch').write_text(json.dumps(meta))
    with pytest.raises(ValueError, match='got 3'):
        transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                  tmp_path_ / 'out.cbin', quiet=True)
    assert not (tmp_path_ / 'out.cbin').exists()


def test_cli_mtsrecompress(tmp_path_):
    from mtscomp_tpu_torch.cli import mtsrecompress
    arr = _compressed(tmp_path_, 'zlib')
    mtsrecompress([str(tmp_path_ / 'in.cbin'), str(tmp_path_ / 'in.ch'),
                   '-o', str(tmp_path_ / 'out.cbin'), '-a', 'ans'])
    r = decompress(tmp_path_ / 'out.cbin', tmp_path_ / 'out.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_transcode_chopped_source_keeps_provenance(tmp_path_):
    from mtscomp_tpu_torch import Reader
    arr = _compressed(tmp_path_, 'zlib', ns=4 * 2000)
    r = Reader(quiet=True)
    r.open(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch')
    try:
        r.chop(2, tmp_path_ / 'chopped.cbin')
    finally:
        r.close()
    transcode(tmp_path_ / 'chopped.cbin', tmp_path_ / 'chopped.ch',
              tmp_path_ / 'out.cbin', algorithm='ans', quiet=True)
    meta = json.loads((tmp_path_ / 'out.ch').read_text())
    assert meta['chopped'] is True
    # A chopped source has null hashes; transcoding restores real ones.
    assert meta['sha1_uncompressed'] is not None
    r = decompress(tmp_path_ / 'out.cbin', tmp_path_ / 'out.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr[:2 * 2000])
    finally:
        r.close()


def test_transcode_multitable_to_zlib_legacy_identity(tmp_path_):
    """A bit4 (segment-table) file exports to the exact legacy bytes."""
    rng = np.random.default_rng(6)
    stds = np.logspace(0.0, 1.6, NC)
    arr = np.clip(np.cumsum(rng.normal(0, 1, (3 * 2000 + 99, NC)) * stds,
                            axis=0), -30000, 30000).astype(np.int16)
    raw = write_arr(tmp_path_ / 'raw.bin', arr)
    compress(raw, tmp_path_ / 'mt.cbin', tmp_path_ / 'mt.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', ans_table_mode='segment', ans_seg_log2=12,
             quiet=True)
    transcode(tmp_path_ / 'mt.cbin', tmp_path_ / 'mt.ch',
              tmp_path_ / 'legacy.cbin', algorithm='zlib', quiet=True)
    compress(raw, tmp_path_ / 'direct.cbin', tmp_path_ / 'direct.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='zlib', quiet=True)
    assert (tmp_path_ / 'legacy.cbin').read_bytes() == \
        (tmp_path_ / 'direct.cbin').read_bytes()


def test_transcode_storm(tmp_path_):
    """Random configs through every transcode direction stay exact."""
    rng = np.random.default_rng(33)
    for trial in range(6):
        nc = int(rng.integers(3, 40))
        ns = int(rng.integers(500, 6000))
        kind = trial % 3
        if kind == 0:
            arr = rng.integers(-30000, 30000, (ns, nc)).astype(np.int16)
        elif kind == 1:
            arr = np.full((ns, nc), int(rng.integers(-5, 6)),
                          dtype=np.int16)
        else:
            stds = np.exp(rng.uniform(0, 3.5, nc))
            arr = np.clip(np.cumsum(rng.normal(0, 1, (ns, nc)) * stds,
                                    axis=0), -30000, 30000).astype(np.int16)
        raw = write_arr(tmp_path_ / 'raw.bin', arr)
        src_algo = ('zlib', 'ans')[trial % 2]
        dst_algo = ('ans', 'zlib')[trial % 2]
        compress(raw, tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                 sample_rate=1000.0, n_channels=nc, dtype='int16',
                 algorithm=src_algo, quiet=True,
                 chunk_duration=float(rng.choice([0.3, 1.0, 2.5])))
        transcode(tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                  tmp_path_ / 'out.cbin', algorithm=dst_algo,
                  overwrite=True, quiet=True,
                  ans_table_mode=str(rng.choice(['plane', 'segment'])))
        r = decompress(tmp_path_ / 'out.cbin', tmp_path_ / 'out.ch',
                       quiet=True)
        try:
            assert np.array_equal(r[:], arr), trial
        finally:
            r.close()


def test_transcode_float_domains_both_directions(tmp_path_):
    """Float transcodes switch coding domains correctly.

    ans(float_bitcast) -> zlib re-encodes in the reference's FLOAT
    domain: the output must be byte-identical to compressing the raw
    floats with the v1 writer directly (same contract as the int16
    legacy-export test — a reference consumer cannot tell the file
    was ever v2). zlib(float) -> ans codes the SOURCE'S decode in
    bitcast (integer-view) domain: the ans file must reproduce the
    zlib file's decoded floats bit-for-bit (NOT the raw file — legacy
    float decode drifts within CHECK_ATOL, reference parity)."""
    rng = np.random.RandomState(7)
    arr = rng.normal(0, 1, (3 * 2000 + 456, NC)).astype(np.float32)
    raw = write_arr(tmp_path_ / 'raw.bin', arr)
    compress(raw, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
             sample_rate=SR, n_channels=NC, dtype='float32',
             algorithm='ans', quiet=True, check_after_compress=False)
    transcode(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
              tmp_path_ / 'az.cbin', algorithm='zlib', quiet=True)
    compress(raw, tmp_path_ / 'z.cbin', tmp_path_ / 'z.ch',
             sample_rate=SR, n_channels=NC, dtype='float32',
             algorithm='zlib', quiet=True, check_after_compress=False)
    assert (tmp_path_ / 'az.cbin').read_bytes() == \
        (tmp_path_ / 'z.cbin').read_bytes()
    meta = json.loads((tmp_path_ / 'az.ch').read_text())
    assert 'float_bitcast' not in meta

    # zlib float -> ans: bit-exact against the source's decode.
    r = decompress(tmp_path_ / 'z.cbin', tmp_path_ / 'z.ch', quiet=True)
    try:
        src_dec = np.asarray(r[:])
    finally:
        r.close()
    transcode(tmp_path_ / 'z.cbin', tmp_path_ / 'z.ch',
              tmp_path_ / 'za.cbin', algorithm='ans', quiet=True)
    meta = json.loads((tmp_path_ / 'za.ch').read_text())
    assert meta['float_bitcast'] is True
    r = decompress(tmp_path_ / 'za.cbin', tmp_path_ / 'za.ch', quiet=True)
    try:
        out = np.asarray(r[:])
    finally:
        r.close()
    assert out.dtype == np.float32
    assert np.array_equal(out.view(np.int32), src_dec.view(np.int32))


# --- the two packages against each other ----------------------------------

@pytest.mark.parametrize('src_alg,dst_alg,kwargs', [
    ('zlib', 'ans', {}), ('ans', 'zlib', {}),
    ('ans', 'ans', {'ans_table_mode': 'segment'}),
    ('ans', 'ans', {'time_diff_order': 2}),
    ('zlib', 'ans', {'do_spatial_diff': True}),
    ('zlib', 'zlib', {'do_time_diff': False})])
@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_both_packages_transcode_to_the_same_bytes(tmp_path_, writer,
                                                   src_alg, dst_alg, kwargs):
    """A file written by either package, transcoded by the port and by
    the JAX package: the same ``.cbin`` and ``.ch``, the same ratio, the
    same ``verify_file`` report, and the source's samples."""
    arr = to_int16(make_signal('colored', ns=3 * 2000 + 456, nc=NC))
    raw = write_arr(tmp_path_ / 'raw.bin', arr)
    (compress if writer == 'port' else ref.compress)(
        raw, tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch', sample_rate=SR,
        n_channels=NC, dtype='int16', algorithm=src_alg, quiet=True,
        device='none')
    got = transcode(tmp_path_ / 'in.cbin', out=tmp_path_ / 'p.cbin',
                    algorithm=dst_alg, quiet=True, **kwargs)
    want = ref.transcode(tmp_path_ / 'in.cbin', out=tmp_path_ / 'j.cbin',
                         algorithm=dst_alg, quiet=True, **kwargs)
    assert got == want
    assert (tmp_path_ / 'p.cbin').read_bytes() == \
        (tmp_path_ / 'j.cbin').read_bytes()
    assert json.loads((tmp_path_ / 'p.ch').read_text()) == \
        json.loads((tmp_path_ / 'j.ch').read_text())
    assert mt.verify_file(tmp_path_ / 'p.cbin', quiet=True) == \
        ref.verify_file(tmp_path_ / 'j.cbin', quiet=True)
    # The port reads its own transcode on the twins (ans) or the host.
    r = decompress(tmp_path_ / 'p.cbin', device='cpu', quiet=True)
    try:
        assert np.array_equal(r.to_array(), arr)
        assert np.array_equal(r[1234:4321], arr[1234:4321])
    finally:
        r.close()


@pytest.mark.parametrize('dtype', ['float32', 'float16', 'uint8', 'int32'])
def test_transcode_dtypes_match_the_reference(tmp_path_, dtype):
    rng = np.random.default_rng(6)
    walk = np.cumsum(rng.normal(0, 3, size=(4500, 7)), axis=0)
    arr = ((walk % 256) if dtype == 'uint8' else walk).astype(dtype)
    raw = write_arr(tmp_path_ / 'raw.bin', arr)
    # Float sources come bitcast (ans): the legacy float domain does not
    # decode byte-exactly.
    ref.compress(raw, tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
                 sample_rate=SR, n_channels=7, dtype=dtype,
                 algorithm='ans' if arr.dtype.kind == 'f' else 'zlib',
                 quiet=True, device='none')
    kw = dict(quiet=True, ans_table_mode='segment')
    transcode(tmp_path_ / 'in.cbin', out=tmp_path_ / 'p.cbin', **kw)
    ref.transcode(tmp_path_ / 'in.cbin', out=tmp_path_ / 'j.cbin', **kw)
    assert (tmp_path_ / 'p.cbin').read_bytes() == \
        (tmp_path_ / 'j.cbin').read_bytes()
    assert (tmp_path_ / 'p.ch').read_text() == \
        (tmp_path_ / 'j.ch').read_text()


TRANSCODES_ON_A_DEVICE = {
    # name: (source algorithm, source options, dtype, target algorithm,
    #        target options, source decodes there, target encodes there)
    'zlib_to_ans': ('zlib', {}, 'int16', 'ans', {}, False, True),
    'ans_to_zlib': ('ans', {}, 'int16', 'zlib', {}, True, False),
    'ans_to_ans_segment': ('ans', {}, 'int16', 'ans',
                           {'ans_table_mode': 'segment'}, True, True),
    'ans_order2_to_ans': ('ans', {'time_diff_order': 2}, 'int16', 'ans', {},
                          True, True),
    'ans_to_ans_spatial': ('ans', {}, 'int16', 'ans',
                           {'do_spatial_diff': True}, True, True),
    'c_order': ('ans', {'chunk_order': 'C'}, 'int16', 'ans',
                {'ans_table_mode': 'plane'}, True, True),
    'float16': ('ans', {}, 'float16', 'ans', {}, True, True),
    # 4-byte codes decode and encode on a device.
    'float32': ('ans', {}, 'float32', 'ans', {}, True, True),
    'uint8': ('zlib', {}, 'uint8', 'ans', {}, False, True),
    # 8-byte codes too (the JAX package leaves them to its host codec).
    'int64': ('ans', {}, 'int64', 'ans', {}, True, True),
    'uint64': ('zlib', {}, 'uint64', 'ans', {}, False, True),
}


@pytest.fixture
def device_calls(monkeypatch):
    """Chunks per ``decode_tensor`` and per ``encode_batch`` call of the
    port's device pipeline, in call order."""
    from mtscomp_tpu_torch.parallel import pipeline
    calls = {'decode': [], 'encode': []}
    decode = pipeline.DeviceBatchDecoder.decode_tensor
    encode = pipeline.DeviceBatchEncoder.encode_batch

    def decode_spy(self, parsed_list, n_samples):
        calls['decode'].append(len(parsed_list))
        return decode(self, parsed_list, n_samples)

    def encode_spy(self, chunks):
        calls['encode'].append(len(chunks))
        return encode(self, chunks)

    monkeypatch.setattr(pipeline.DeviceBatchDecoder, 'decode_tensor',
                        decode_spy)
    monkeypatch.setattr(pipeline.DeviceBatchEncoder, 'encode_batch',
                        encode_spy)
    return calls


@pytest.mark.parametrize('case', sorted(TRANSCODES_ON_A_DEVICE))
def test_transcode_on_a_device_writes_the_host_route_s_bytes(
        tmp_path_, device_calls, case):
    """``device='cpu'``: an ans source decodes through the batched device
    decode and an ans target encodes through ``DeviceBatchEncoder`` (the
    kernels' plain twins here; the shorter last chunk is a batch of its
    own), and the output is the host route's, byte for byte."""
    (src_alg, src_kw, dtype, algorithm, kw, decodes,
     encodes) = TRANSCODES_ON_A_DEVICE[case]
    arr = make_signal('colored', ns=3 * 2000 + 456, nc=NC)
    arr = (arr / 64.0).astype(dtype) if np.dtype(dtype).kind == 'f' \
        else to_int16(arr).astype(dtype)
    raw = write_arr(tmp_path_ / 'raw.bin', arr)
    compress(raw, tmp_path_ / 'in.cbin', tmp_path_ / 'in.ch',
             sample_rate=SR, n_channels=NC, dtype=dtype, algorithm=src_alg,
             quiet=True, **src_kw)
    mt.reset_launch_counts()
    want = transcode(tmp_path_ / 'in.cbin', out=tmp_path_ / 'h.cbin',
                     algorithm=algorithm, quiet=True, device='none', **kw)
    assert not any(mt.launch_counts().values())
    assert device_calls == {'decode': [], 'encode': []}
    got = transcode(tmp_path_ / 'in.cbin', out=tmp_path_ / 'd.cbin',
                    algorithm=algorithm, quiet=True, device='cpu', **kw)
    counts = mt.launch_counts()
    assert got == want
    assert (tmp_path_ / 'd.cbin').read_bytes() == \
        (tmp_path_ / 'h.cbin').read_bytes()
    assert (tmp_path_ / 'd.ch').read_text() == (tmp_path_ / 'h.ch').read_text()
    # Three whole chunks are one batch, the shorter last chunk another.
    assert device_calls['decode'] == ([3, 1] if decodes else [])
    assert counts['host_fallback_chunks'] == 0
    assert device_calls['encode'] == ([3, 1] if encodes else [])
    assert counts['host_encoded_chunks'] == 0
    r = decompress(tmp_path_ / 'd.cbin', device='cpu', quiet=True)
    try:
        assert r.to_array().tobytes() == arr.tobytes()
    finally:
        r.close()


def test_transcode_takes_the_configured_device(tmp_path_):
    """Under the port's default configuration (``device='cuda'``) an ans
    source or target needs the GPU, as ``Reader`` and ``Writer`` do; a
    named device does not."""
    _compressed(tmp_path_, 'zlib')
    mt_config.CONFIG_PATH.unlink()
    assert mt_config.read_config().device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        transcode(tmp_path_ / 'in.cbin', out=tmp_path_ / 'o.cbin',
                  quiet=True)
    assert not (tmp_path_ / 'o.cbin').exists()
    transcode(tmp_path_ / 'in.cbin', out=tmp_path_ / 'o.cbin', quiet=True,
              device='cpu')
    assert mt.verify_file(tmp_path_ / 'o.cbin', quiet=True,
                          device='cpu')['ok']
    transcode(tmp_path_ / 'o.cbin', out=tmp_path_ / 'z.cbin', quiet=True,
              algorithm='zlib', device='none')
    assert (tmp_path_ / 'z.cbin').read_bytes() == \
        (tmp_path_ / 'in.cbin').read_bytes()
