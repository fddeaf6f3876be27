"""PyTorch port: the command line (``cli.py``): the seven commands, their
arg -> config mapping, ``python -m mtscomp_tpu_torch.cli``, and ``chop``.

The JAX package's ``tests/test_cli.py`` and ``tests/test_chop.py`` run
against the port's own ``cli.py``, then the two packages against each
other: each command gives the bytes the JAX package's gives, and
``python -m mtscomp_tpu_torch.cli <command>`` runs in a fresh process
that ends with neither ``jax`` nor ``mtscomp_tpu`` loaded.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
import mtscomp_tpu.config as ref_config  # noqa: E402
import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
import re  # noqa: E402

from mtscomp_tpu_torch import (cli, compress, decompress,  # noqa: E402
                               load_raw_data)
from mtscomp_tpu_torch.config import read_config  # noqa: E402
from conftest import SAMPLE_RATE, make_signal, to_int16, write_arr  # noqa: E402
from test_check import sha1  # noqa: E402


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


@pytest.fixture
def data(tmp_path_):
    arr = to_int16(make_signal('colored', ns=3000, nc=5))
    path = write_arr(tmp_path_ / 'data.bin', arr)
    return tmp_path_, path, arr


def test_args_to_config():
    parser = cli.mtscomp_parser()
    pargs, config = cli._args_to_config(
        parser, ['f.bin', '-d', 'int16 ', '-s', '20000', '-n', '385',
                 '-p', '2'], compress=True)
    assert config.dtype == 'int16'
    assert config.sample_rate == 20000.0
    assert config.n_channels == 385
    assert config.n_threads == 2
    # -nc not passed => check_after_compress stays at its default True
    assert config.check_after_compress is True


def test_args_no_check():
    parser = cli.mtscomp_parser()
    pargs, config = cli._args_to_config(
        parser, ['f.bin', '-d', 'int16', '-s', '1', '-n', '3', '-nc'],
        compress=True)
    assert config.check_after_compress is False


def test_cli_roundtrip(data, capsys):
    tmp, path, arr = data
    out = tmp / 'data.cbin'
    outmeta = tmp / 'data.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-d', 'int16',
                 '-s', str(SAMPLE_RATE), '-n', '5'])
    assert out.exists() and outmeta.exists()

    # mtsdesc prints recoverable metadata.
    cli.mtsdesc([str(out), str(outmeta)])
    desc = capsys.readouterr().out
    assert re.search(r'dtype\s+int16', desc)
    assert re.search(r'n_channels\s+5', desc)

    # --json emits one machine-readable object with the same fields.
    cli.mtsdesc([str(out), str(outmeta), '--json'])
    import json as _json
    info = _json.loads(capsys.readouterr().out)
    assert info['dtype'] == 'int16'
    assert info['n_channels'] == 5
    assert info['algorithm'] == 'zlib'
    assert info['n_samples'] == arr.shape[0]

    dec = tmp / 'dec.bin'
    cli.mtsdecomp([str(out), str(outmeta), '-o', str(dec)])
    loaded = load_raw_data(dec, n_channels=5, dtype='int16')
    assert np.array_equal(loaded, arr)
    # Decompressing again without -f fails; with -f succeeds.
    with pytest.raises(ValueError):
        cli.mtsdecomp([str(out), str(outmeta), '-o', str(dec)])
    cli.mtsdecomp([str(out), str(outmeta), '-o', str(dec), '-f'])


def test_cli_ans_roundtrip(data):
    tmp, path, arr = data
    out, outmeta = tmp / 'a.cbin', tmp / 'a.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-d', 'int16',
                 '-s', str(SAMPLE_RATE), '-n', '5', '-a', 'ans'])
    cmeta = json.loads(outmeta.read_text())
    assert cmeta['algorithm'] == 'ans'
    dec = tmp / 'dec.bin'
    cli.mtsdecomp([str(out), str(outmeta), '-o', str(dec)])
    assert np.array_equal(load_raw_data(dec, n_channels=5, dtype='int16'),
                          arr)


def test_cli_missing_args(data):
    tmp, path, arr = data
    with pytest.raises((ValueError, SystemExit)):
        cli.mtscomp([str(path)])  # no dtype/rate/channels


def test_cli_set_default(data):
    tmp, path, arr = data
    out, outmeta = tmp / 'd.cbin', tmp / 'd.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-d', 'int16',
                 '-s', str(SAMPLE_RATE), '-n', '5', '--set-default'])
    # The config file now holds these defaults.
    config = read_config()
    assert config.n_channels == 5
    assert config.dtype == 'int16'
    # A later compress can rely on the persisted defaults.
    out2, outmeta2 = tmp / 'e.cbin', tmp / 'e.ch'
    cli.mtscomp([str(path), str(out2), str(outmeta2)])
    assert out2.exists()


def test_cli_npy(tmp_path_):
    arr = np.random.randint(-500, 500, size=(4, 250, 7)).astype(np.int16)
    path = tmp_path_ / 'data.npy'
    np.save(path, arr)
    out, outmeta = tmp_path_ / 'data.cnpy', tmp_path_ / 'data.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-s', '1000'])
    cmeta = json.loads(outmeta.read_text())
    assert tuple(cmeta['shape']) == arr.shape


def test_cli_chop(data):
    tmp, path, arr = data
    out, outmeta = tmp / 'data.cbin', tmp / 'data.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-d', 'int16',
                 '-s', '1000', '-n', '5'])
    chopped = tmp / 'chopped.cbin'
    cli.mtschop([str(out), '-n', '2', '-o', str(chopped)])
    assert chopped.exists()
    cmeta = json.loads((tmp / 'chopped.ch').read_text())
    assert cmeta['chopped'] is True
    assert len(cmeta['chunk_bounds']) == 3


def test_cli_range_and_merge(tmp_path_):
    """mtscomp --range + mtsmerge: parts merge byte-identically to a
    full compress."""
    from mtscomp_tpu_torch import decompress
    from mtscomp_tpu_torch.cli import mtscomp, mtsmerge
    arr = to_int16(make_signal('colored', ns=4 * 1000, nc=7))
    path = write_arr(tmp_path_ / 'r.bin', arr)
    base = ['-d', 'int16', '-s', '1000', '-n', '7']
    mtscomp([str(path), str(tmp_path_ / 'full.cbin'),
             str(tmp_path_ / 'full.ch')] + base)
    mtscomp([str(path), str(tmp_path_ / 'p0.cbin'), str(tmp_path_ / 'p0.ch'),
             '--range', '0:2'] + base)
    mtscomp([str(path), str(tmp_path_ / 'p1.cbin'), str(tmp_path_ / 'p1.ch'),
             '--range', '2:4'] + base)
    mtsmerge([str(tmp_path_ / 'p0.cbin'), str(tmp_path_ / 'p1.cbin'),
              '-o', str(tmp_path_ / 'm.cbin')])
    assert (tmp_path_ / 'm.cbin').read_bytes() == \
        (tmp_path_ / 'full.cbin').read_bytes()
    r = decompress(tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_cli_decomp_samples_window(data, tmp_path):
    """mtsdecomp --samples A:B exports just a window (random access)."""
    tmp, path, arr = data
    out, outmeta = tmp / 'w.cbin', tmp / 'w.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-d', 'int16',
                 '-s', str(SAMPLE_RATE), '-n', '5', '-a', 'ans'])
    dst = tmp_path / 'win.bin'
    cli.mtsdecomp([str(out), str(outmeta), '-o', str(dst),
                   '--samples', '100:300'])
    got = np.fromfile(dst, dtype=arr.dtype).reshape(-1, 5)
    assert np.array_equal(got, arr[100:300])
    # Existing output without -f is refused; -f overwrites.
    with pytest.raises(ValueError):
        cli.mtsdecomp([str(out), str(outmeta), '-o', str(dst),
                       '--samples', '0:10'])
    cli.mtsdecomp([str(out), str(outmeta), '-o', str(dst),
                   '--samples=-200:', '-f'])
    got = np.fromfile(dst, dtype=arr.dtype).reshape(-1, 5)
    assert np.array_equal(got, arr[-200:])
    # Malformed range surfaces a descriptive error.
    with pytest.raises(ValueError, match='A:B'):
        cli.mtsdecomp([str(out), str(outmeta), '-o', str(dst),
                       '--samples', 'abc', '-f'])


def test_cli_compress_from_stdin(data, tmp_path, monkeypatch):
    """mtscomp - streams raw samples from stdin, byte-identical to
    compressing the finished file."""
    import io

    class _Stdin:
        def __init__(self, payload):
            self.buffer = io.BytesIO(payload)

    tmp, path, arr = data
    cli.mtscomp([str(path), str(tmp / 'file.cbin'), str(tmp / 'file.ch'),
                 '-d', 'int16', '-s', str(SAMPLE_RATE), '-n', '5',
                 '-a', 'ans'])
    monkeypatch.setattr(cli.sys, 'stdin', _Stdin(arr.tobytes()))
    cli.mtscomp(['-', str(tmp_path / 'pipe.cbin'), str(tmp_path / 'pipe.ch'),
                 '-d', 'int16', '-s', str(SAMPLE_RATE), '-n', '5',
                 '-a', 'ans'])
    assert (tmp_path / 'pipe.cbin').read_bytes() == \
        (tmp / 'file.cbin').read_bytes()

    # Trailing bytes that do not form a full row must error and leave
    # no output behind.
    monkeypatch.setattr(cli.sys, 'stdin', _Stdin(arr.tobytes() + b'\x01'))
    with pytest.raises(ValueError, match='trailing'):
        cli.mtscomp(['-', str(tmp_path / 'bad.cbin'),
                     str(tmp_path / 'bad.ch'), '-d', 'int16',
                     '-s', str(SAMPLE_RATE), '-n', '5', '-a', 'ans'])
    assert not (tmp_path / 'bad.cbin').exists()

    # stdin requires explicit outputs and the required params.
    with pytest.raises(ValueError, match='out'):
        cli.mtscomp(['-', '-d', 'int16', '-s', '1000', '-n', '5'])


def test_cli_decomp_to_stdout(data, monkeypatch, capsysbinary):
    """mtsdecomp -o - streams raw decoded bytes to stdout; with
    --samples only the window is written."""
    tmp, path, arr = data
    out, outmeta = tmp / 'so.cbin', tmp / 'so.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-d', 'int16',
                 '-s', str(SAMPLE_RATE), '-n', '5', '-a', 'ans'])
    cli.mtsdecomp([str(out), str(outmeta), '-o', '-'])
    got = np.frombuffer(capsysbinary.readouterr().out,
                        dtype=arr.dtype).reshape(-1, 5)
    assert np.array_equal(got, arr)
    cli.mtsdecomp([str(out), str(outmeta), '-o', '-',
                   '--samples', '50:250'])
    got = np.frombuffer(capsysbinary.readouterr().out,
                        dtype=arr.dtype).reshape(-1, 5)
    assert np.array_equal(got, arr[50:250])


def test_cli_decomp_stdout_hash_check(data, capsysbinary):
    """The full-stream stdout path hash-verifies the streamed bytes
    against sha1_uncompressed (a decodable-but-wrong corruption must
    not stream silently)."""
    tmp, path, arr = data
    out, outmeta = tmp / 'hc.cbin', tmp / 'hc.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-d', 'int16',
                 '-s', str(SAMPLE_RATE), '-n', '5'])   # zlib: no CRC
    meta = json.loads(outmeta.read_text())
    # Tamper with the sidecar hash to emulate wrong decoded content.
    meta['sha1_uncompressed'] = '0' * 40
    outmeta.write_text(json.dumps(meta))
    with pytest.raises(IOError, match='sha1_uncompressed'):
        cli.mtsdecomp([str(out), str(outmeta), '-o', '-'])
    capsysbinary.readouterr()
    # -nc skips the incremental check.
    cli.mtsdecomp([str(out), str(outmeta), '-o', '-', '-nc'])
    got = np.frombuffer(capsysbinary.readouterr().out,
                        dtype=arr.dtype).reshape(-1, 5)
    assert np.array_equal(got, arr)


def test_cli_decomp_channels(data, capsysbinary):
    """mtsdecomp --channels exports only the selected columns, in the
    requested order, to a file or stdout, with or without --samples."""
    tmp, path, arr = data
    out, outmeta = tmp / 'ch.cbin', tmp / 'ch.ch'
    cli.mtscomp([str(path), str(out), str(outmeta), '-d', 'int16',
                 '-s', str(SAMPLE_RATE), '-n', '5', '-a', 'ans'])

    # File export: ranges + indices + duplicates + negatives, order kept.
    dec = tmp / 'cols.bin'
    cli.mtsdecomp([str(out), str(outmeta), '-o', str(dec),
                   '--channels', '3,0:2,-1,3'])
    cols = [3, 0, 1, 4, 3]
    got = np.fromfile(dec, dtype=arr.dtype).reshape(-1, len(cols))
    assert np.array_equal(got, arr[:, cols])

    # Combined with --samples; overwrite guard applies.
    with pytest.raises(ValueError, match='exists'):
        cli.mtsdecomp([str(out), str(outmeta), '-o', str(dec),
                       '--channels', '2', '--samples', '100:300'])
    cli.mtsdecomp([str(out), str(outmeta), '-o', str(dec), '-f',
                   '--channels', '2', '--samples', '100:300'])
    got = np.fromfile(dec, dtype=arr.dtype).reshape(-1, 1)
    assert np.array_equal(got, arr[100:300, [2]])

    # stdout form streams the same bytes.
    cli.mtsdecomp([str(out), str(outmeta), '-o', '-',
                   '--channels', '1:3', '--samples', '50:250'])
    got = np.frombuffer(capsysbinary.readouterr().out,
                        dtype=arr.dtype).reshape(-1, 2)
    assert np.array_equal(got, arr[50:250, 1:3])

    # Also exercised on the legacy zlib container (full-chunk fallback).
    zout, zmeta = tmp / 'chz.cbin', tmp / 'chz.ch'
    cli.mtscomp([str(path), str(zout), str(zmeta), '-d', 'int16',
                 '-s', str(SAMPLE_RATE), '-n', '5'])
    dec2 = tmp / 'colsz.bin'
    cli.mtsdecomp([str(zout), str(zmeta), '-o', str(dec2),
                   '--channels', '4,0'])
    got = np.fromfile(dec2, dtype=arr.dtype).reshape(-1, 2)
    assert np.array_equal(got, arr[:, [4, 0]])

    # Bad specs are rejected with a clear error.
    for spec in ('', 'a', '1;2', '9'):
        with pytest.raises((ValueError, IndexError)):
            cli.mtsdecomp([str(out), str(outmeta), '-o', str(dec), '-f',
                           '--channels', spec])


# --- chop (tests/test_chop.py) --------------------------------------------

def test_chop_equivalence(tmp_path_, algorithm):
    arr = to_int16(make_signal('colored', ns=5000, nc=7))
    path = write_arr(tmp_path_ / 'data.bin', arr)
    out, outmeta = tmp_path_ / 'data.cbin', tmp_path_ / 'data.ch'
    compress(path, out, outmeta, sample_rate=1000.0, n_channels=7,
             dtype=arr.dtype, algorithm=algorithm, quiet=True)

    r = decompress(out, outmeta)
    n_keep = 3
    chopped = tmp_path_ / 'chopped.cbin'
    r.chop(n_keep, chopped)
    bounds = r.chunk_bounds
    r.close()

    # Compressing the truncated raw file must give identical bytes.
    trunc = arr[:bounds[n_keep]]
    tpath = write_arr(tmp_path_ / 'trunc.bin', trunc)
    tout, toutmeta = tmp_path_ / 'trunc.cbin', tmp_path_ / 'trunc.ch'
    compress(tpath, tout, toutmeta, sample_rate=1000.0, n_channels=7,
             dtype=arr.dtype, algorithm=algorithm, quiet=True)
    assert sha1(chopped) == sha1(tout)

    # Chopped sidecar: truncated tables, nulled hashes, chopped flag.
    cmeta = json.loads((tmp_path_ / 'chopped.ch').read_text())
    assert cmeta['chopped'] is True
    assert cmeta['sha1_compressed'] is None
    assert cmeta['sha1_uncompressed'] is None
    assert len(cmeta['chunk_bounds']) == n_keep + 1

    # And it decompresses to the truncated data.
    rc = decompress(chopped, tmp_path_ / 'chopped.ch')
    assert np.array_equal(rc[:], trunc)
    rc.close()


def test_chop_validates_arguments(tmp_path_):
    """User-input validation survives python -O (exceptions, not asserts)."""
    arr = to_int16(make_signal('randn', ns=5000, nc=7))
    path = write_arr(tmp_path_ / 'data.bin', arr)
    out, outmeta = tmp_path_ / 'data.cbin', tmp_path_ / 'data.ch'
    compress(path, out, outmeta, sample_rate=1000.0, n_channels=7,
             dtype=arr.dtype, quiet=True)
    r = decompress(out, outmeta)
    try:
        import pytest
        with pytest.raises(ValueError, match='positive'):
            r.chop(0, tmp_path_ / 'c.cbin')
        with pytest.raises(ValueError, match='positive'):
            r.chop(-1, tmp_path_ / 'c.cbin')
        with pytest.raises(ValueError, match='output path'):
            r.chop(2, None)
        with pytest.raises(ValueError, match='cbin'):
            r.chop(2, tmp_path_ / 'c.bin')
    finally:
        r.close()


def test_chop_validation_survives_python_O(tmp_path_):
    """The same validation errors fire under ``python -O`` (no asserts)."""
    import subprocess, sys, os
    arr = to_int16(make_signal('randn', ns=5000, nc=7))
    path = write_arr(tmp_path_ / 'data.bin', arr)
    out, outmeta = tmp_path_ / 'data.cbin', tmp_path_ / 'data.ch'
    compress(path, out, outmeta, sample_rate=1000.0, n_channels=7,
             dtype=arr.dtype, quiet=True)
    code = (
        "from mtscomp_tpu_torch import decompress\n"
        "r = decompress(%r, %r, quiet=True)\n"
        "for args in [(0, 'c.cbin'), (2, None), (2, 'c.bin')]:\n"
        "    try:\n"
        "        r.chop(*args)\n"
        "    except ValueError:\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit('chop(%%r) did not raise' %% (args,))\n"
        "r.close()\n" % (str(out), str(outmeta)))
    env = dict(os.environ)
    env['PYTHONPATH'] = env.get('PYTHONPATH', '') + os.pathsep + \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-O', '-c', code],
                          capture_output=True, text=True, env=env,
                          cwd=str(tmp_path_))
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_chop_preserves_decode_semantic_keys(tmp_path_):
    """A chopped file must inherit every DECODE_IDENTITY key — an
    order-2 or float-bitcast source whose chop dropped the v2 sidecar
    extension would decode wrong with no error (the keys are
    sidecar-only, invisible to the chunk payloads)."""
    rng = np.random.RandomState(5)
    t = np.arange(9000) / 3000.0
    lfp = (np.sin(2 * np.pi * 3. * t)[:, None] * 12000
           + rng.normal(0, 6., (9000, 11))).astype(np.int16)
    path = write_arr(tmp_path_ / 'o2.bin', lfp)
    compress(path, tmp_path_ / 'o2.cbin', tmp_path_ / 'o2.ch',
             sample_rate=3000.0, n_channels=11, dtype='int16',
             algorithm='ans', time_diff_order=2, quiet=True)
    r = decompress(tmp_path_ / 'o2.cbin', tmp_path_ / 'o2.ch', quiet=True)
    assert r.time_diff_order == 2
    r.chop(2, tmp_path_ / 'o2c.cbin')
    r.close()
    rc = decompress(tmp_path_ / 'o2c.cbin', tmp_path_ / 'o2c.ch',
                    quiet=True)
    try:
        assert rc.cmeta['time_diff_order'] == 2
        assert np.array_equal(rc[:], lfp[:rc.shape[0]])
    finally:
        rc.close()

    arr = rng.normal(0, 1, (9000, 11)).astype(np.float32)
    path = write_arr(tmp_path_ / 'fb.bin', arr)
    compress(path, tmp_path_ / 'fb.cbin', tmp_path_ / 'fb.ch',
             sample_rate=3000.0, n_channels=11, dtype='float32',
             algorithm='ans', quiet=True, check_after_compress=False)
    r = decompress(tmp_path_ / 'fb.cbin', tmp_path_ / 'fb.ch', quiet=True)
    r.chop(2, tmp_path_ / 'fbc.cbin')
    r.close()
    rc = decompress(tmp_path_ / 'fbc.cbin', tmp_path_ / 'fbc.ch',
                    quiet=True)
    try:
        assert rc.cmeta['float_bitcast'] is True
        out = np.asarray(rc[:])
        assert np.array_equal(out.view(np.int32),
                              arr[:rc.shape[0]].view(np.int32))
    finally:
        rc.close()


# --- the port's device names, its one entry point, and the JAX CLI --------

@pytest.mark.parametrize('name', ['auto', 'cuda', 'cuda:0', 'cuda:3', 'cpu',
                                  'none'])
def test_device_option_takes_the_port_s_names(name):
    for parser in (cli.mtscomp_parser(), cli.mtsdecomp_parser()):
        assert parser.parse_args(['f', '--device', name]).device == name
    assert cli.mtscomp_parser().parse_args(['f']).device is None


@pytest.mark.parametrize('name', ['tpu', 'gpu', 'cuda:', 'cuda:x', 'CPU', ''])
def test_device_option_refuses_other_names(name, capsys):
    with pytest.raises(SystemExit) as e:
        cli.mtsdecomp_parser().parse_args(['f', '--device', name])
    assert e.value.code == 2
    assert 'invalid device' in capsys.readouterr().err


def test_help_texts_speak_of_the_gpu(capsys):
    for parser in (cli.mtscomp_parser(), cli.mtsdecomp_parser()):
        text = parser.format_help()
        assert 'GPU' in text and not re.search(r'\btpu\b', text, re.I)


def _ref_cli():
    from mtscomp_tpu import cli as ref_cli
    return ref_cli


@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
def test_every_command_gives_the_jax_cli_s_bytes(data, algorithm, capsys):
    """mtscomp, mtsdesc, mtsdecomp (whole, a sample window, channels),
    mtsverify, mtsrecompress and mtschop of both packages on the same
    raw file: the same files and the same printed text."""
    tmp, path, arr = data
    ref_cli = _ref_cli()
    common = ['-d', 'int16', '-s', str(SAMPLE_RATE), '-n', '5', '-a',
              algorithm, '--device', 'none']
    cli.mtscomp([str(path), str(tmp / 'p.cbin'), str(tmp / 'p.ch')] + common)
    ref_cli.mtscomp([str(path), str(tmp / 'j.cbin'), str(tmp / 'j.ch')]
                    + common)
    assert (tmp / 'p.cbin').read_bytes() == (tmp / 'j.cbin').read_bytes()
    assert (tmp / 'p.ch').read_text() == (tmp / 'j.ch').read_text()
    capsys.readouterr()

    def both(command, args_p, args_j):
        getattr(cli, command)(args_p)
        out_p = capsys.readouterr().out
        getattr(ref_cli, command)(args_j)
        assert out_p == capsys.readouterr().out
        return out_p

    assert 'n_chunks' in both('mtsdesc', [str(tmp / 'p.cbin')],
                              [str(tmp / 'p.cbin')])
    both('mtsdesc', [str(tmp / 'j.cbin'), '--json'],
         [str(tmp / 'j.cbin'), '--json'])
    assert 'verdict' in both('mtsverify', [str(tmp / 'j.cbin')],
                             [str(tmp / 'p.cbin')])
    for k, extra in enumerate(([], ['--samples', '700:2100'],
                               ['--channels', '3,0:2'],
                               ['--samples', ':1500', '--channels', '4'])):
        # Each package decodes the OTHER's file.
        both('mtsdecomp', [str(tmp / 'j.cbin'), '-o',
                           str(tmp / ('p%d.bin' % k)), '--device', 'cpu',
                           '-nc'] + extra,
             [str(tmp / 'p.cbin'), '-o', str(tmp / ('j%d.bin' % k)),
              '--device', 'cpu', '-nc'] + extra)
        assert (tmp / ('p%d.bin' % k)).read_bytes() == \
            (tmp / ('j%d.bin' % k)).read_bytes()
    assert (tmp / 'p0.bin').read_bytes() == arr.tobytes()
    assert (tmp / 'p1.bin').read_bytes() == arr[700:2100].tobytes()
    assert (tmp / 'p2.bin').read_bytes() == arr[:, [3, 0, 1]].tobytes()
    other = 'zlib' if algorithm == 'ans' else 'ans'
    both('mtsrecompress', [str(tmp / 'j.cbin'), '-o', str(tmp / 'pr.cbin'),
                           '-a', other],
         [str(tmp / 'p.cbin'), '-o', str(tmp / 'jr.cbin'), '-a', other])
    assert (tmp / 'pr.cbin').read_bytes() == (tmp / 'jr.cbin').read_bytes()
    assert (tmp / 'pr.ch').read_text() == (tmp / 'jr.ch').read_text()
    both('mtschop', [str(tmp / 'j.cbin'), '-n', '2', '-o',
                     str(tmp / 'pc.cbin')],
         [str(tmp / 'p.cbin'), '-n', '2', '-o', str(tmp / 'jc.cbin')])
    assert (tmp / 'pc.cbin').read_bytes() == (tmp / 'jc.cbin').read_bytes()
    assert (tmp / 'pc.ch').read_text() == (tmp / 'jc.ch').read_text()


def test_mtscomp_on_the_twins_writes_the_host_route_s_bytes(data):
    tmp, path, arr = data
    common = ['-d', 'int16', '-s', str(SAMPLE_RATE), '-n', '5', '-a', 'ans']
    cli.mtscomp([str(path), str(tmp / 'c.cbin'), str(tmp / 'c.ch'),
                 '--device', 'cpu'] + common)
    cli.mtscomp([str(path), str(tmp / 'n.cbin'), str(tmp / 'n.ch'),
                 '--device', 'none'] + common)
    assert (tmp / 'c.cbin').read_bytes() == (tmp / 'n.cbin').read_bytes()
    assert (tmp / 'c.ch').read_text() == (tmp / 'n.ch').read_text()


def test_parts_and_merge_across_packages(data):
    """``mtscomp --parts --rank`` parts of the JAX CLI merge under the
    port's ``mtsmerge`` into the port's whole-file bytes."""
    tmp, path, arr = data
    ref_cli = _ref_cli()
    common = ['-d', 'int16', '-s', str(SAMPLE_RATE), '-n', '5', '-a', 'ans',
              '--device', 'none', '-nc']
    cli.mtscomp([str(path), str(tmp / 'w.cbin'), str(tmp / 'w.ch')] + common)
    for rank in (0, 1):
        ref_cli.mtscomp([str(path), str(tmp / 'm.cbin'), '--parts', '2',
                         '--rank', str(rank)] + common)
    parts = sorted(str(p) for p in tmp.glob('*part_*.cbin'))
    assert len(parts) == 2
    cli.mtsmerge(parts + ['-o', str(tmp / 'm.cbin')])
    assert (tmp / 'm.cbin').read_bytes() == (tmp / 'w.cbin').read_bytes()
    assert json.loads((tmp / 'm.ch').read_text()) == \
        json.loads((tmp / 'w.ch').read_text())


def test_desc_and_chop_need_no_device(data, capsys):
    """Nothing is decoded: both run on an ans file under the default
    configuration (``device='cuda'``) on a host with no GPU."""
    tmp, path, arr = data
    cli.mtscomp([str(path), '-d', 'int16', '-s', str(SAMPLE_RATE), '-n', '5',
                 '-a', 'ans', '--device', 'none'])
    mt_config.CONFIG_PATH.unlink()
    assert read_config().device == 'cuda'
    cli.mtsdesc([str(tmp / 'data.cbin')])
    assert 'ans' in capsys.readouterr().out
    cli.mtschop([str(tmp / 'data.cbin'), '-n', '1', '-o',
                 str(tmp / 'one.cbin')])
    assert mt.verify_file(tmp / 'one.cbin', quiet=True, device='none')['ok']


def test_main_dispatches_and_refuses_unknown_commands(data, capsys):
    tmp, path, arr = data
    assert sorted(cli.COMMANDS) == ['mtschop', 'mtscomp', 'mtsdecomp',
                                    'mtsdesc', 'mtsmerge', 'mtsrecompress',
                                    'mtsverify']
    cli.main(['mtscomp', str(path), '-d', 'int16', '-s', str(SAMPLE_RATE),
              '-n', '5'])
    cli.main(['mtsdesc', str(tmp / 'data.cbin')])
    assert 'zlib' in capsys.readouterr().out
    for argv in ([], ['mtsbench'], ['--help']):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
        assert 'usage: python -m mtscomp_tpu_torch.cli' in \
            capsys.readouterr().err


def _run_module(tmp, argv, check_modules=False):
    """``python -m mtscomp_tpu_torch.cli <argv>`` in a fresh process with
    its own HOME. With ``check_modules`` the module runs through
    ``runpy`` (what ``-m`` does) so that the child can report what it
    loaded once the command is done."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=repo, HOME=str(tmp))
    env.pop('MTSCOMP_PALLAS_INTERPRET', None)
    if check_modules:
        code = ("import runpy, sys\n"
                "sys.argv = ['cli'] + sys.argv[1:]\n"
                "try:\n"
                "    runpy.run_module('mtscomp_tpu_torch.cli', "
                "run_name='__main__', alter_sys=True)\n"
                "finally:\n"
                "    bad = sorted(m for m in sys.modules if m.split('.')[0] "
                "in ('jax', 'jaxlib', 'mtscomp_tpu'))\n"
                "    print('LOADED', bad)\n")
        cmd = [sys.executable, '-c', code] + argv
    else:
        cmd = [sys.executable, '-m', 'mtscomp_tpu_torch.cli'] + argv
    return subprocess.run(cmd, cwd=str(tmp), env=env, capture_output=True,
                          text=True, timeout=600)


def test_python_m_runs_the_commands_without_jax(data):
    tmp, path, arr = data
    common = ['-d', 'int16', '-s', str(SAMPLE_RATE), '-n', '5', '-a', 'ans']
    steps = [
        ['mtscomp', str(path), '--device', 'cpu'] + common,
        ['mtsdesc', str(tmp / 'data.cbin'), '--json'],
        ['mtsverify', str(tmp / 'data.cbin'), '--device', 'cpu'],
        ['mtsdecomp', str(tmp / 'data.cbin'), '-o', str(tmp / 'o.bin'),
         '--device', 'cpu'],
        ['mtsdecomp', str(tmp / 'data.cbin'), '-o', str(tmp / 'w.bin'),
         '--device', 'cpu', '--samples', '100:2900'],
        ['mtsrecompress', str(tmp / 'data.cbin'), '-o', str(tmp / 'z.cbin'),
         '-a', 'zlib', '--device', 'cpu'],
        ['mtsrecompress', str(tmp / 'z.cbin'), '-o', str(tmp / 'a.cbin'),
         '-a', 'ans', '--device', 'cpu'],
        ['mtschop', str(tmp / 'data.cbin'), '-n', '1', '-o',
         str(tmp / 'c.cbin')],
        ['mtscomp', str(path), str(tmp / 'm.cbin'), str(tmp / 'm.ch'),
         '--parts', '2', '--workers', '2', '-nc'] + common,
    ]
    for argv in steps:
        proc = _run_module(tmp, argv, check_modules=True)
        assert proc.returncode == 0, (argv, proc.stderr[-2000:])
        assert proc.stdout.strip().splitlines()[-1] == 'LOADED []', argv
    assert (tmp / 'o.bin').read_bytes() == arr.tobytes()
    assert (tmp / 'w.bin').read_bytes() == arr[100:2900].tobytes()
    assert (tmp / 'm.cbin').read_bytes() == (tmp / 'data.cbin').read_bytes()
    assert (tmp / 'a.cbin').read_bytes() == (tmp / 'data.cbin').read_bytes()
    # The real ``-m`` form: exit codes 0, 1 (verification failed), 2.
    proc = _run_module(tmp, ['mtsverify', str(tmp / 'z.cbin')])
    assert proc.returncode == 0 and 'OK' in proc.stdout
    blob = bytearray((tmp / 'z.cbin').read_bytes())
    blob[40] ^= 0xFF
    (tmp / 'z.cbin').write_bytes(bytes(blob))
    proc = _run_module(tmp, ['mtsverify', str(tmp / 'z.cbin'), '--fast'])
    assert proc.returncode == 1 and 'FAILED' in proc.stdout
    proc = _run_module(tmp, ['nothing'])
    assert proc.returncode == 2 and 'usage' in proc.stderr
    # An error keeps its traceback hidden and its exit code non-zero.
    proc = _run_module(tmp, ['mtsdecomp', str(tmp / 'missing.cbin'),
                             '--device', 'none'])
    assert proc.returncode == 1 and 'Traceback' not in proc.stderr
