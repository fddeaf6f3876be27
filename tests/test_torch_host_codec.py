"""PyTorch port: its own copy of the host layer against the reference.

The port keeps its own copies of the JAX package's host modules (the
container format, the normative coder, the host codecs, the native C++
runtime, ``Writer`` and ``Reader``). Here the port's ``compress`` on the
host route (``device='none'``) writes the same ``.cbin`` and ``.ch``
bytes as ``mtscomp_tpu.compress`` for zlib and ans files, over the
default segment tables, plane tables, order 2, spatial diff, C order
and float32; each package's Reader decodes the other's files; the
frozen ans files decode through the port's host codec; and the copied
coder functions equal the reference's on seeded inputs.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import mtscomp_tpu  # noqa: E402
from mtscomp_tpu.codec import ans as ref_ans  # noqa: E402
from mtscomp_tpu.models import rans as ref_rans  # noqa: E402

import mtscomp_tpu_torch as mt  # noqa: E402
from mtscomp_tpu_torch import config as mt_config  # noqa: E402
from mtscomp_tpu_torch import native as mt_native  # noqa: E402
from mtscomp_tpu_torch.codec import ans as mt_ans  # noqa: E402
from mtscomp_tpu_torch.models import rans as mt_rans  # noqa: E402

from conftest import write_arr  # noqa: E402
from test_torch_pipeline import GOLDEN  # noqa: E402


@pytest.fixture(autouse=True)
def _port_config(tmp_path, monkeypatch):
    """The port's user config file, redirected like the reference's."""
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')


def _signal(dtype, seed=0, n=2500, C=24):
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(0, 6, size=(n, C)), axis=0)
    if dtype == 'float32':
        return (walk * 0.25).astype(np.float32)
    return walk.astype(np.int64).astype(dtype)


ORDER1 = {'time_diff_order': 1, 'do_spatial_diff': False}
LAYOUTS = {
    'segment': ('int16', ORDER1),
    'plane': ('int16', dict(ORDER1, ans_table_mode='plane')),
    'order2': ('int16', {'time_diff_order': 2, 'do_spatial_diff': False}),
    'spatial': ('int16', {'time_diff_order': 1, 'do_spatial_diff': True}),
    'c_order': ('int16', dict(ORDER1, chunk_order='C')),
    'float32': ('float32', ORDER1),
    'auto': ('int16', {}),
}
# zlib files (format v1) take the reference's transforms only; their
# float round trip is only close, not exact, so floats are ans-only.
CASES = ([('zlib', lay) for lay in ('auto', 'c_order', 'segment',
                                     'spatial')]
         + [('ans', lay) for lay in sorted(LAYOUTS)])


def _both(tmp_path, algorithm, layout):
    """Compress one file with each package's host route: the source and
    the two (cbin, ch) pairs."""
    dtype, opts = LAYOUTS[layout]
    arr = _signal(dtype)
    raw = write_arr(tmp_path / 's.bin', arr)
    pairs = {}
    for tag, pkg in (('ref', mtscomp_tpu), ('port', mt)):
        cbin, ch = tmp_path / (tag + '.cbin'), tmp_path / (tag + '.ch')
        pkg.compress(raw, cbin, ch, sample_rate=1000.0,
                     n_channels=arr.shape[1], dtype=dtype,
                     algorithm=algorithm, quiet=True, device='none',
                     ans_seg_log2=12, **opts)
        pairs[tag] = (cbin, ch)
    return arr, pairs


@pytest.mark.parametrize('algorithm,layout', CASES)
def test_host_compress_bytes_equal_the_reference(tmp_path_, algorithm,
                                                 layout):
    _arr, pairs = _both(tmp_path_, algorithm, layout)
    for k in (0, 1):
        assert pairs['port'][k].read_bytes() == pairs['ref'][k].read_bytes()


@pytest.mark.parametrize('algorithm,layout', CASES)
def test_each_reader_decodes_the_others_files(tmp_path_, algorithm,
                                              layout):
    arr, pairs = _both(tmp_path_, algorithm, layout)
    readers = (lambda c, h: mtscomp_tpu.decompress(c, h, quiet=True),
               lambda c, h: mt.decompress(c, h, quiet=True, device='none'),
               lambda c, h: mt.decompress(c, h, quiet=True, device='cpu'))
    for tag in ('ref', 'port'):
        for open_ in readers:
            r = open_(*pairs[tag])
            try:
                assert np.array_equal(r[:], arr)
                assert np.array_equal(r.to_array(), arr)
                assert np.array_equal(r[7:1900:3, 2:9], arr[7:1900:3, 2:9])
            finally:
                r.close()


def test_port_check_catches_a_corrupt_file(tmp_path_):
    arr, pairs = _both(tmp_path_, 'ans', 'segment')
    cbin, ch = pairs['port']
    mt.check(arr, cbin, ch)
    data = bytearray(cbin.read_bytes())
    data[len(data) // 2] ^= 0xFF
    cbin.write_bytes(bytes(data))
    with pytest.raises((AssertionError, IOError)):
        mt.check(arr, cbin, ch)


@pytest.mark.parametrize('stem', ['ts_int16_129ch', 'int16_19ch',
                                  'mt_int16_48ch', 'o2_int16_17ch',
                                  'adapt_int16_13ch', 'f32_11ch',
                                  'uint8_7ch'])
def test_golden_files_through_the_port_host_codec(stem):
    rp = mt.decompress(GOLDEN / ('ans_%s.cbin' % stem),
                       GOLDEN / ('ans_%s.ch' % stem), device='none',
                       quiet=True)
    try:
        want = np.fromfile(GOLDEN / ('np_%s.bin' % stem),
                           rp.dtype).reshape(-1, rp.n_channels)
        assert np.array_equal(rp.to_array(), want)
        assert np.array_equal(rp[:], want)
    finally:
        rp.close()


def test_native_library_is_the_ports_own():
    """The port builds its C++ runtime into its own ignored build dir and
    never loads the JAX package's library."""
    assert mt_native.available()
    path = mt_native.library_path()
    assert path.exists() and path.parent.name == '_build'
    assert path.parent.parent.name == 'mtscomp_tpu_torch'
    assert mt_native._lib is not None
    assert 'mtscomp_tpu_torch' in str(mt_native._lib._name)


def _counts(rng, K, n_sym):
    c = np.zeros((K, 256), np.int64)
    for i in range(K):
        sym = rng.choice(256, size=n_sym, replace=False)
        c[i, sym] = rng.geometric(0.001, size=n_sym)
    return c


@pytest.mark.parametrize('n_sym', [2, 17, 256])
def test_coder_copy_matches_the_reference(n_sym):
    rng = np.random.default_rng(n_sym)
    counts = _counts(rng, 6, n_sym)
    fq = mt_rans.quantize_freqs_batch(counts)
    assert np.array_equal(fq, ref_rans.quantize_freqs_batch(counts))
    assert np.array_equal(mt_ans._quantize_rows(counts),
                          ref_ans._quantize_rows(counts))
    for a, b in zip(mt_rans.encoder_tables(fq), ref_rans.encoder_tables(fq)):
        assert np.array_equal(a, b)
    rows = [rng.choice(256, size=int(n), p=counts[i] / counts[i].sum()
                       ).astype(np.uint8)
            for i, n in enumerate((300, 0, 1, 128, 129, 1000))]
    st, w = mt_rans.rans_encode_group(rows, fq)
    st_r, w_r = ref_rans.rans_encode_group(rows, fq)
    assert np.array_equal(st, st_r) and np.array_equal(w, w_r)
    back, used = mt_rans.rans_decode_group(st, w, fq, [r.size for r in rows])
    assert used == w.size
    assert all(np.array_equal(a, b) for a, b in zip(back, rows))


def test_decide_plane_and_clustering_match_the_reference():
    rng = np.random.default_rng(3)
    seg_hists = np.stack([np.bincount(np.minimum(rng.geometric(
        0.02 * (1 + s % 5), 4096), 255), minlength=256) for s in range(24)])
    counts = seg_hists.sum(axis=0)
    for mode in ('plane', 'segment'):
        got = mt_ans.decide_plane(counts, 0, 24 * 4096, 24 * 4096, 4096,
                                  mode, lambda: seg_hists)
        want = ref_ans.decide_plane(counts, 0, 24 * 4096, 24 * 4096, 4096,
                                    mode, lambda: seg_hists)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert (a is None and b is None) or np.array_equal(a, b)


def test_peek_desc_checks_the_tail_split_range():
    """The reference's ``peek_desc`` returns an out-of-range bit6 count
    unchecked; the port's raises the full parse's IOError."""
    hdr = bytearray(ref_ans._HEADER.pack(
        ref_ans.MAGIC, ref_ans.CONTAINER_VERSION, 2,
        ref_ans.FLAG_TAILSPLIT | 7, 12, 100, 4, 8, 32, 0, 10, 8))
    assert mt_ans.peek_desc(bytes(hdr)) == ref_ans.peek_desc(bytes(hdr)) \
        == (None, 8)
    for bad in (0, 1, 257, 65535):
        hdr[18:20] = bad.to_bytes(2, 'little')
        assert ref_ans.peek_desc(bytes(hdr))[1] == bad
        with pytest.raises(IOError, match='tail_split'):
            mt_ans.peek_desc(bytes(hdr))


def test_tail_split_decision_has_no_environment_knob(monkeypatch):
    """The TPU A/B knob ``MTSCOMP_ENC_TAILSPLIT`` moves the reference's
    bit6 decision, not the port's."""
    args = (True, [mt_ans.MODE_RANS, mt_ans.MODE_CONST], 32 * 1024 + 512,
            1024)
    assert mt_ans.tail_split_for(*args) == ref_ans.tail_split_for(*args) == 4
    monkeypatch.setenv('MTSCOMP_ENC_TAILSPLIT', '0')
    assert ref_ans.tail_split_for(*args) == 1
    assert mt_ans.tail_split_for(*args) == 4
