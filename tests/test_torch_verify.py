"""PyTorch port: ``verify_file`` / ``mtsverify``, in-place audits without
the raw file.

The JAX package's ``tests/test_verify.py`` run against the port's own
``verify.py`` and ``cli.py``, then the two packages against each other:
a pair written by either package gets the identical report (the same
``ok``, ``issues`` and ``checks``, string for string) from both, intact
and damaged. This machine has no GPU, so the port's configured default
device is the host codec here; ``device='cpu'`` sends the deep pass of an
ans file through the batched decode on the kernels' plain twins, with
the same report.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
import mtscomp_tpu.config as ref_config  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch import compress, decompress, verify_file  # noqa: E402
from mtscomp_tpu_torch.cli import mtsverify  # noqa: E402
from mtscomp_tpu_torch.verify import CHECKS, _structure_issues  # noqa: E402

from conftest import SAMPLE_RATE, to_int16, write_arr  # noqa: E402


@pytest.fixture
def tmp_path_(tmp_path, monkeypatch):
    """A directory that holds both packages' user config files; the
    port's names the host codec as its default device."""
    monkeypatch.setattr(ref_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp_torch')
    mt_config.CONFIG_PATH.write_text(json.dumps({'device': 'none'}))
    return tmp_path

def _make(tmp, algorithm='ans', dtype='int16', name='data', **kw):
    rng = np.random.default_rng(3)
    arr = np.cumsum(rng.normal(0, 4, size=(5000, 9)), axis=0)
    arr = arr.astype(dtype) if np.dtype(dtype).kind == 'f' else to_int16(arr)
    path = write_arr(tmp / (name + '.bin'), arr)
    out, ch = tmp / (name + '.cbin'), tmp / (name + '.ch')
    compress(path, out, ch, sample_rate=SAMPLE_RATE, n_channels=9,
             dtype=arr.dtype, algorithm=algorithm, quiet=True, **kw)
    return out, ch, arr


@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
def test_intact_file_verifies(tmp_path_, algorithm):
    out, ch, _ = _make(tmp_path_, algorithm)
    report = verify_file(out, ch, quiet=True)
    assert report['ok'] and not report['issues']
    assert report['checks']['sha1_compressed'] == 'ok'
    assert report['checks']['chunks_decode'] == 'ok'
    assert report['checks']['sha1_uncompressed'] == 'ok'


def test_bitcast_float_verifies_exactly(tmp_path_):
    out, ch, _ = _make(tmp_path_, dtype='float32')
    report = verify_file(out, ch, quiet=True)
    assert report['ok']
    assert report['checks']['sha1_uncompressed'] == 'ok'


def test_legacy_float_skips_raw_hash(tmp_path_):
    out, ch, _ = _make(tmp_path_, algorithm='zlib', dtype='float64')
    report = verify_file(out, ch, quiet=True)
    assert report['ok']
    assert report['checks']['sha1_uncompressed'].startswith('skipped')
    assert report['checks']['sha1_compressed'] == 'ok'


def test_payload_corruption_detected(tmp_path_):
    out, ch, _ = _make(tmp_path_)
    data = bytearray(out.read_bytes())
    data[len(data) // 2] ^= 0x20
    out.write_bytes(bytes(data))
    report = verify_file(out, ch, quiet=True)
    assert not report['ok']
    assert report['checks']['sha1_compressed'] == 'MISMATCH'
    # The deep pass surfaces it too (CRC32 / stream audit / raw hash).
    deep_failed = (report['checks']['chunks_decode'] != 'ok'
                   or report['checks']['sha1_uncompressed'] == 'MISMATCH')
    assert deep_failed


def test_truncated_payload_detected(tmp_path_):
    out, ch, _ = _make(tmp_path_)
    data = out.read_bytes()
    out.write_bytes(data[:-10])
    report = verify_file(out, ch, deep=False, quiet=True)
    assert not report['ok']
    assert report['checks']['payload_size'] == 'MISMATCH'


def test_tampered_sidecar_detected(tmp_path_):
    out, ch, _ = _make(tmp_path_)
    cm = json.loads(ch.read_text())
    cm['chunk_offsets'][2] = cm['chunk_offsets'][1]  # zero-byte chunk
    ch.write_text(json.dumps(cm))
    report = verify_file(out, ch, deep=False, quiet=True)
    assert not report['ok']
    assert 'not strictly increasing' in report['checks']['structure']


def test_unparseable_sidecar(tmp_path_):
    out, ch, _ = _make(tmp_path_)
    ch.write_text('not json at all')
    report = verify_file(out, ch, quiet=True)
    assert not report['ok']
    assert 'sidecar' in report['checks']


def test_chopped_file_verifies(tmp_path_):
    # chop() nulls both SHA1s: hashes skip, decode still audits.
    out, ch, _ = _make(tmp_path_, chunk_duration=0.5)
    r = decompress(out, ch)
    r.chop(2, out=tmp_path_ / 'c.cbin')
    r.close()
    report = verify_file(tmp_path_ / 'c.cbin', quiet=True)
    assert report['ok']
    assert report['checks']['sha1_compressed'].startswith('skipped')
    assert report['checks']['chunks_decode'] == 'ok'


def test_fast_mode_skips_decode(tmp_path_):
    out, ch, _ = _make(tmp_path_)
    report = verify_file(out, ch, deep=False, quiet=True)
    assert report['ok']
    assert report['checks']['chunks_decode'] == 'skipped (--fast)'


def test_cli_exit_codes(tmp_path_, capsys):
    out, ch, _ = _make(tmp_path_)
    mtsverify([str(out), str(ch)])          # exit 0 = no SystemExit
    stdout = capsys.readouterr().out
    assert 'verdict' in stdout and 'OK' in stdout
    data = bytearray(out.read_bytes())
    data[100] ^= 0xFF
    out.write_bytes(bytes(data))
    with pytest.raises(SystemExit) as e:
        mtsverify([str(out), str(ch), '--fast'])
    assert e.value.code == 1
    assert 'FAILED' in capsys.readouterr().out


# --- the two packages against each other ----------------------------------

def _damage(kind, out, ch):
    if kind == 'flipped_byte':
        data = bytearray(out.read_bytes())
        data[len(data) // 2] ^= 0x20
        out.write_bytes(bytes(data))
    elif kind == 'truncated':
        out.write_bytes(out.read_bytes()[:-10])
    elif kind == 'zero_byte_chunk':
        cm = json.loads(ch.read_text())
        cm['chunk_offsets'][2] = cm['chunk_offsets'][1]
        ch.write_text(json.dumps(cm))
    elif kind == 'bad_sidecar':
        ch.write_text('not json at all')
    elif kind == 'wrong_raw_hash':
        cm = json.loads(ch.read_text())
        cm['sha1_uncompressed'] = '0' * 40
        ch.write_text(json.dumps(cm))
    else:
        assert kind == 'intact'


@pytest.mark.parametrize('deep', [True, False])
@pytest.mark.parametrize('damage', ['intact', 'flipped_byte', 'truncated',
                                    'zero_byte_chunk', 'bad_sidecar',
                                    'wrong_raw_hash'])
@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('algorithm,dtype', [('ans', 'int16'),
                                             ('zlib', 'int16'),
                                             ('ans', 'float32'),
                                             ('zlib', 'float64')])
def test_both_packages_give_the_same_report(tmp_path_, algorithm, dtype,
                                            writer, damage, deep):
    rng = np.random.default_rng(5)
    arr = np.cumsum(rng.normal(0, 4, size=(5000, 9)), axis=0)
    arr = arr.astype(dtype) if np.dtype(dtype).kind == 'f' else to_int16(arr)
    path = write_arr(tmp_path_ / 'x.bin', arr)
    out, ch = tmp_path_ / 'x.cbin', tmp_path_ / 'x.ch'
    (compress if writer == 'port' else ref.compress)(
        path, out, ch, sample_rate=SAMPLE_RATE, n_channels=9,
        dtype=arr.dtype, algorithm=algorithm, quiet=True, device='none')
    _damage(damage, out, ch)
    got = verify_file(out, ch, deep=deep, quiet=True)
    want = ref.verify_file(out, ch, deep=deep, quiet=True)
    assert got == want
    # The raw-stream hash is only re-derived by the deep pass, and only
    # where the decode is byte-exact (not for legacy float files).
    unseen = damage == 'wrong_raw_hash' and (
        not deep or (algorithm == 'zlib' and dtype == 'float64'))
    assert got['ok'] == (damage == 'intact' or unseen)
    assert list(got['checks']) == [c for c in CHECKS if c in got['checks']]


def test_checks_and_structure_issues_are_the_reference_s():
    from mtscomp_tpu import verify as ref_verify
    assert CHECKS == ref_verify.CHECKS
    cm = dict(chunk_bounds=[0, 10, 10], chunk_offsets=[0, 5], dtype='nope',
              n_channels=0)
    assert _structure_issues(cm, 7) == ref_verify._structure_issues(cm, 7)
    assert len(_structure_issues(cm, 7)) == 5
    assert _structure_issues({}, 0) == ref_verify._structure_issues({}, 0)


@pytest.fixture
def decode_calls(monkeypatch):
    """Chunks per ``decode_tensor`` call of the port, in call order."""
    from mtscomp_tpu_torch.parallel import pipeline
    calls = []
    real = pipeline.DeviceBatchDecoder.decode_tensor

    def spy(self, parsed_list, n_samples):
        calls.append(len(parsed_list))
        return real(self, parsed_list, n_samples)

    monkeypatch.setattr(pipeline.DeviceBatchDecoder, 'decode_tensor', spy)
    return calls


@pytest.mark.parametrize('damage', ['intact', 'flipped_byte',
                                    'wrong_raw_hash'])
@pytest.mark.parametrize('dtype,kw', [
    ('int16', {}), ('int16', {'chunk_duration': 0.1}), ('float16', {}),
    ('float32', {}), ('float64', {})])
def test_deep_pass_decodes_on_the_device_it_is_given(tmp_path_, decode_calls,
                                                     dtype, kw, damage):
    """``device='cpu'``: an ans file's chunks go through the batched
    device decode (``batch_chunks`` chunks a call, 8 by default), 8-byte
    dtypes (float64, coded as int64) included; ``device='none'`` and the
    configured default (here the host codec) decode nothing there. The
    report is the same."""
    import mtscomp_tpu_torch as mt
    out, ch, _ = _make(tmp_path_, dtype=dtype, **kw)
    _damage(damage, out, ch)
    want = verify_file(out, ch, quiet=True, device='none')
    assert verify_file(out, ch, quiet=True) == want
    assert decode_calls == []
    assert want['ok'] == (damage == 'intact')
    mt.reset_launch_counts()
    assert verify_file(out, ch, quiet=True, device='cpu') == want
    n_chunks = len(json.loads(ch.read_text())['chunk_bounds']) - 1
    if damage == 'flipped_byte':
        return                      # the damaged chunk's CRC ends the pass
    assert sum(decode_calls) == n_chunks and max(decode_calls) <= 8
    assert mt.launch_counts()['host_fallback_chunks'] == 0


def test_batch_chunks_bounds_the_deep_pass(tmp_path_, decode_calls):
    out, ch, _ = _make(tmp_path_, chunk_duration=0.1)
    mt_config.CONFIG_PATH.write_text(json.dumps(
        {'device': 'cpu', 'batch_chunks': 3}))
    assert verify_file(out, ch, quiet=True)['ok']
    assert len(decode_calls) > 1 and max(decode_calls) == 3


def test_verify_takes_the_configured_device(tmp_path_, capsys):
    """Under the port's default configuration (``device='cuda'``) the
    deep pass of an ans file needs the GPU, as every ``Reader`` does;
    the structure and hash pass, zlib files and a named device do not."""
    mt_config.CONFIG_PATH.unlink()
    assert mt_config.read_config().device == 'cuda'
    out, ch, _ = _make(tmp_path_, device='none')
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        verify_file(out, ch, quiet=True)
    assert verify_file(out, ch, quiet=True, deep=False)['ok']
    assert verify_file(out, ch, quiet=True, device='cpu')['ok']
    mtsverify([str(out), '--fast'])
    mtsverify([str(out), '--device', 'cpu'])
    mtsverify([str(out), '--device', 'none'])
    assert capsys.readouterr().out.count('verdict            OK') == 3
    with pytest.raises(SystemExit):
        mtsverify([str(out), '--device', 'tpu'])
    zout, zch, _ = _make(tmp_path_, 'zlib', name='z')
    assert verify_file(zout, zch, quiet=True)['ok']
