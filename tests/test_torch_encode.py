"""PyTorch port: the device encode (``DeviceBatchEncoder`` and the
Writer's route through it).

On every branch of the slice's path at 129 channels (one coded plane
with the bit6 tail split, both planes coded, order 2, spatial diff, C
order with plane tables, uint16, uint8, int8, a RAW plane, segment and
plane tables), the port's ``encode_batch`` on the CPU twins returns the
same container bytes as the JAX package's ``encode_batch`` (Pallas in
interpret mode) and as the host codec's ``encode``. ``compress`` with
``device='cpu'`` writes the JAX package's file byte for byte, and the
port decodes it; batches the route leaves to the host codec (a dtype
``supported()`` declines, runt sub-batches, C order under segment
tables) are counted in ``host_encoded_chunks``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu  # noqa: E402
from mtscomp_tpu.parallel import pipeline as jpl  # noqa: E402

import mtscomp_tpu_torch as mt  # noqa: E402
from mtscomp_tpu_torch import config as mt_config  # noqa: E402
from mtscomp_tpu_torch.codec.ans import (MODE_CONST, MODE_RANS,  # noqa: E402
                                         MODE_RAW)
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

from conftest import write_arr  # noqa: E402

# 129 channels of 499 diffs (512 padded) in 2048-symbol segments: 4
# channels a segment, 33 segments a plane, the ragged 129th channel
# a bit6 tail (the 385-channel geometry's shape at a third the width).
T, C, N_CHUNKS = 500, 129, 2
S11 = {'ans_seg_log2': 11}
ORDER1 = {'time_diff_order': 1, 'do_spatial_diff': False}


@pytest.fixture(autouse=True)
def _port_config(tmp_path, monkeypatch):
    """The port's user config file, redirected like the reference's; the
    JAX side runs its Pallas kernels in interpret mode."""
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')


def _walk(seed, step=5.0, n=(N_CHUNKS + 1) * T, spikes=0.0):
    """Random walk (diff std ``step``) with ``spikes`` per sample and
    channel: a -60, -90, +150 step over 3 samples, whose +150 diff
    leaves the high byte plane non-constant."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, step, size=(n, C))
    t, c = np.nonzero(rng.random((n - 3, C)) < spikes)
    for k, v in enumerate((-60.0, -90.0, 150.0)):
        np.add.at(d, (t + k, c), v)
    return np.cumsum(d, axis=0).astype(np.int64)


def _as(walk, dtype):
    bits = np.dtype(dtype).itemsize * 8
    return (walk % (1 << bits)).astype('uint%d' % bits).view(dtype)


SPIKES = 1 / 1500
# name: (source, compress options, expected (plane modes, bit6)).
GEOMS = {
    'walk': (lambda: _as(_walk(0), 'int16'), dict(S11, **ORDER1),
             ((MODE_RANS, MODE_CONST), True)),
    'walk_plane_tables': (lambda: _as(_walk(1), 'int16'),
                          dict(S11, ans_table_mode='plane', **ORDER1),
                          ((MODE_RANS, MODE_CONST), True)),
    'spiky': (lambda: _as(_walk(3, spikes=SPIKES), 'int16'),
              dict(S11, **ORDER1), ((MODE_RANS, MODE_RANS), False)),
    'order2': (lambda: _as(_walk(4, spikes=SPIKES), 'int16'),
               dict(S11, time_diff_order=2, do_spatial_diff=False),
               ((MODE_RANS, MODE_RANS), False)),
    'spatial': (lambda: _as(_walk(5, spikes=SPIKES), 'int16'),
                dict(S11, time_diff_order=1, do_spatial_diff=True),
                ((MODE_RANS, MODE_RANS), False)),
    'c_order_plane_tables': (lambda: _as(_walk(6, spikes=SPIKES), 'int16'),
                             dict(S11, chunk_order='C',
                                  ans_table_mode='plane', **ORDER1),
                             ((MODE_RANS, MODE_RANS), False)),
    'uint16': (lambda: _as(_walk(7, spikes=SPIKES), 'uint16'),
               dict(S11, **ORDER1), ((MODE_RANS, MODE_RANS), False)),
    'uint8': (lambda: _as(_walk(8), 'uint8'), dict(S11, **ORDER1),
              ((MODE_RANS,), True)),
    'int8': (lambda: _as(_walk(9, spikes=SPIKES), 'int8'),
             dict(S11, **ORDER1), ((MODE_RANS,), True)),
    'raw_low_plane': (lambda: _as(_walk(10, step=3000.0), 'int16'),
                      dict(S11, **ORDER1), ((MODE_RAW, MODE_RANS), True)),
}


def _writers(tmp_path, arr, **opts):
    """The port's and the JAX package's Writers opened on one file."""
    raw = write_arr(tmp_path / 'e.bin', arr)
    out = []
    for cls in (mt.Writer, mtscomp_tpu.Writer):
        w = cls(algorithm='ans', quiet=True, device='cpu', **opts)
        w.open(raw, sample_rate=float(T), n_channels=arr.shape[1],
               dtype=arr.dtype)
        out.append(w)
    return out


def _chunks(w, n=N_CHUNKS):
    return np.stack([np.asarray(w.get_chunk(i)) for i in range(n)])


def _host(w, chunks):
    return [w.codec.encode(w._transform_chunk(c), order=w.chunk_order)
            for c in chunks]


@pytest.mark.parametrize('name', sorted(GEOMS))
def test_encode_batch_matches_jax_and_host(tmp_path_, name):
    make, opts, (modes, bit6) = GEOMS[name]
    pw, jw = _writers(tmp_path_, make(), **opts)
    try:
        chunks = _chunks(pw)
        mt.reset_launch_counts()
        got = tp.DeviceBatchEncoder(pw, device='cpu').encode_batch(chunks)
        assert mt.launch_counts()['host_encoded_chunks'] == 0
        want = jpl.DeviceBatchEncoder(jw).encode_batch(chunks)
        assert got == want == _host(pw, chunks)
        parsed = [pw.codec.parse(p) for p in got]
        assert {tuple(p['modes']) for p in parsed} == {modes}
        assert (parsed[0]['tail_split'] > 1) == bit6
    finally:
        pw.close()
        jw.close()


@pytest.mark.parametrize('name', sorted(GEOMS))
def test_compress_matches_jax_and_decodes(tmp_path_, name):
    """The port's compress on the device route (the twins), with a
    shorter last chunk, writes the JAX package's file byte for byte,
    with every chunk encoded on the route; the port decodes it."""
    make, opts, _expect = GEOMS[name]
    arr = make()[:N_CHUNKS * T + 300]
    raw = write_arr(tmp_path_ / 'c.bin', arr)
    kw = dict(sample_rate=float(T), n_channels=C, dtype=arr.dtype,
              algorithm='ans', quiet=True, **opts)
    mt.reset_launch_counts()
    mt.compress(raw, tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                **kw)
    assert mt.launch_counts()['host_encoded_chunks'] == 0
    mtscomp_tpu.compress(raw, tmp_path_ / 'j.cbin', tmp_path_ / 'j.ch',
                         device='none', **kw)
    for ext in ('.cbin', '.ch'):
        assert ((tmp_path_ / ('p' + ext)).read_bytes()
                == (tmp_path_ / ('j' + ext)).read_bytes())
    r = mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                      quiet=True)
    try:
        assert np.array_equal(r.to_array(), arr)
    finally:
        r.close()


def test_staged_tensor_input_and_layer_profile(tmp_path_):
    """A batch already on the device (the coding dtype's bits) encodes
    to the same bytes; the layer profile covers the route."""
    make, opts, _ = GEOMS['spiky']
    pw, jw = _writers(tmp_path_, make(), **opts)
    try:
        chunks = _chunks(pw)
        enc = tp.DeviceBatchEncoder(pw, device='cpu')
        enc.profile = {}
        staged = enc.encode_batch(torch.from_numpy(chunks))
        assert staged == enc.encode_batch(chunks) == _host(pw, chunks)
        assert set(enc.profile) == {'upload', 'transform', 'host_decisions',
                                    'gather_stage', 'k6', 'align_fetch',
                                    'assembly'}
        symbols, pk, rcp, counts, cap = enc.last_kernel_args
        assert tuple(symbols.shape) == (N_CHUNKS * 3, 32, 16 * 128)
        assert cap == int(counts.sum(dim=1).max())
    finally:
        pw.close()
        jw.close()


def test_mixed_modes_split_with_runts_on_the_host(tmp_path_):
    """A batch whose plane modes differ between chunks: the four quiet
    chunks (high byte CONST) encode as one device sub-batch, the one
    busy chunk (both planes rANS) is a runt for the host codec."""
    quiet = _walk(11, step=2.0, n=4 * T)
    busy = _walk(12, spikes=SPIKES, n=T) + quiet[-1]
    arr = _as(np.concatenate([quiet, busy]), 'int16')
    pw, jw = _writers(tmp_path_, arr, **dict(S11, **ORDER1))
    try:
        chunks = _chunks(pw, 5)
        mt.reset_launch_counts()
        got = tp.DeviceBatchEncoder(pw, device='cpu').encode_batch(chunks)
        assert mt.launch_counts()['host_encoded_chunks'] == 1
        assert got == jpl.DeviceBatchEncoder(jw).encode_batch(chunks) \
            == _host(pw, chunks)
        modes = [tuple(pw.codec.parse(p)['modes']) for p in got]
        assert modes == [(MODE_RANS, MODE_CONST)] * 4 + [(MODE_RANS,) * 2]
    finally:
        pw.close()
        jw.close()


@pytest.mark.parametrize('adapt', [2, 3])
def test_adaptive_windows_keep_device_runs(tmp_path_, adapt):
    """transform_adapt: each window encodes with its own transform and
    the bit5 stamp; runs of a batch shorter than MIN_DEVICE_SUBBATCH go
    to the host codec. The file equals the JAX package's."""
    walk = _walk(13, n=8 * T)
    # A slow oscillation: its second diff is far smaller than its first,
    # so the windows' probes move from order 1 to order 2.
    lfp = np.round(2000 * np.sin(np.arange(4 * T)[:, None] / 40.0
                                 + np.arange(C))).astype(np.int64)
    walk[4 * T:] = walk[4 * T - 1] + lfp
    arr = _as(walk, 'int16')
    raw = write_arr(tmp_path_ / 'a.bin', arr)
    kw = dict(sample_rate=float(T), n_channels=C, dtype='int16',
              algorithm='ans', quiet=True, transform_adapt=adapt,
              n_threads=8, **S11)
    mt.reset_launch_counts()
    mt.compress(raw, tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                **kw)
    n_host = mt.launch_counts()['host_encoded_chunks']
    mtscomp_tpu.compress(raw, tmp_path_ / 'j.cbin', tmp_path_ / 'j.ch',
                         device='none', **kw)
    assert ((tmp_path_ / 'p.cbin').read_bytes()
            == (tmp_path_ / 'j.cbin').read_bytes())
    r = mt.decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                      quiet=True)
    try:
        parsed = [r.codec.parse(tp._read_payload(r, i))
                  for i in range(r.n_chunks)]
        assert np.array_equal(r.to_array(), arr)
    finally:
        r.close()
    transforms = [p['transform'] for p in parsed]
    assert len(set(transforms)) >= 2            # the probe changed its mind
    # One batch of 8 chunks: runs of equal transforms shorter than
    # MIN_DEVICE_SUBBATCH go to the host codec, and so do the runt
    # mode-uniform sub-batches of the longer runs.
    runs = [[0]]
    for i in range(1, len(parsed)):
        if transforms[i] == transforms[i - 1]:
            runs[-1].append(i)
        else:
            runs.append([i])
    want = 0
    for run in runs:
        if len(run) < tp.MIN_DEVICE_SUBBATCH:
            want += len(run)
            continue
        modes = [tuple(parsed[i]['modes']) for i in run]
        want += sum(n for n in map(modes.count, set(modes))
                    if n < tp.MIN_DEVICE_SUBBATCH)
    assert n_host == want


def test_adaptive_windows_of_four_stay_on_the_device(tmp_path_):
    walk = _walk(14, n=8 * T)
    walk[4 * T:] = walk[4 * T - 1] + np.round(
        2000 * np.sin(np.arange(4 * T)[:, None] / 40.0)).astype(np.int64)
    arr = _as(walk, 'int16')
    raw = write_arr(tmp_path_ / 'a.bin', arr)
    kw = dict(sample_rate=float(T), n_channels=C, dtype='int16',
              algorithm='ans', quiet=True, transform_adapt=4, n_threads=8,
              **S11)
    mt.reset_launch_counts()
    mt.compress(raw, tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                **kw)
    assert mt.launch_counts()['host_encoded_chunks'] == 0
    mtscomp_tpu.compress(raw, tmp_path_ / 'j.cbin', tmp_path_ / 'j.ch',
                         device='none', **kw)
    assert ((tmp_path_ / 'p.cbin').read_bytes()
            == (tmp_path_ / 'j.cbin').read_bytes())


@pytest.mark.parametrize('case', ['int32', 'c_order_segment_tables'])
def test_declined_batches_go_to_the_host_codec(tmp_path_, case):
    """int32 (``supported()`` declines) and C order under segment tables
    (``encode_batch`` declines, as in the JAX package): every chunk on
    the host codec, counted, and the same bytes."""
    if case == 'int32':
        arr, opts = (_walk(15, spikes=SPIKES) * 1001).astype(np.int32), ORDER1
    else:
        arr = _as(_walk(16, spikes=SPIKES), 'int16')
        opts = dict(ORDER1, chunk_order='C')
    pw, jw = _writers(tmp_path_, arr, **dict(S11, **opts))
    try:
        enc = tp.DeviceBatchEncoder(pw, device='cpu')
        if case == 'int32':
            assert not enc.supported(T)
            assert not jpl.DeviceBatchEncoder(jw).supported(T)
        else:
            assert enc.encode_batch(_chunks(pw)) is None
            assert jpl.DeviceBatchEncoder(jw).encode_batch(
                _chunks(jw)) is None
    finally:
        pw.close()
        jw.close()
    raw = tmp_path_ / 'e.bin'
    kw = dict(sample_rate=float(T), n_channels=C, dtype=arr.dtype,
              algorithm='ans', quiet=True, **S11, **opts)
    mt.reset_launch_counts()
    mt.compress(raw, tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', device='cpu',
                **kw)
    assert mt.launch_counts()['host_encoded_chunks'] == N_CHUNKS + 1
    mtscomp_tpu.compress(raw, tmp_path_ / 'j.cbin', tmp_path_ / 'j.ch',
                         device='none', **kw)
    assert ((tmp_path_ / 'p.cbin').read_bytes()
            == (tmp_path_ / 'j.cbin').read_bytes())


def test_host_route_counts_nothing(tmp_path_):
    """``device='none'`` is the host codec by request: no chunk counts as
    left to it by the device route."""
    make, opts, _ = GEOMS['walk']
    arr = make()
    raw = write_arr(tmp_path_ / 'h.bin', arr)
    mt.reset_launch_counts()
    mt.compress(raw, tmp_path_ / 'h.cbin', tmp_path_ / 'h.ch',
                sample_rate=float(T), n_channels=C, dtype='int16',
                algorithm='ans', quiet=True, device='none', **opts)
    assert not any(mt.launch_counts().values())
