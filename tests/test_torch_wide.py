"""PyTorch port: 8-byte dtypes (int64, uint64, float64) on the device
route.

The JAX package decodes and encodes them on its host codec (JAX without
x64 holds no int64 tensor, so neither its XLA ops nor its Pallas kernels
take them). The port runs them through the same routes as narrower
items: K1, then the int64 forms of K4 and K5, and an encode of 8 byte
planes through K6. Here, on the CPU, the kernels' plain twins run, held
against what is exact at any width: the JAX package's host layer (numpy:
``mtscomp_tpu.ops.delta``, ``mtscomp_tpu.models.rans``, ``compress`` and
``decompress`` with ``device='none'``), the port's own host codec and
numpy's wrapping arithmetic. Tolerance 0 throughout, NaN and infinities
compared as bits; every chunk takes the device route
(``host_encoded_chunks`` and ``host_fallback_chunks`` stay 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import mtscomp_tpu  # noqa: E402
from mtscomp_tpu.models import rans as jax_rans  # noqa: E402
from mtscomp_tpu.ops import delta as jax_delta  # noqa: E402

import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch.ops import device_delta as dd  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402
from mtscomp_tpu_torch.parallel.mesh import chunk_mesh  # noqa: E402

from conftest import write_arr  # noqa: E402

DTYPES = ('int64', 'uint64', 'float64')
I64 = np.iinfo(np.int64)
#: Values at and around the ends of the 64-bit range, as int64 bits (the
#: uint64 values 2**63 and above are the negative ones).
EXTREMES = np.array([I64.min, I64.min + 1, -2, -1, 0, 1, 2, I64.max - 1,
                     I64.max, 1 << 62, -(1 << 62), (1 << 32) + 5],
                    dtype=np.int64)

#: Layouts: name -> (samples a chunk, compress options).
ORDER1 = {'time_diff_order': 1, 'do_spatial_diff': False}
LAYOUTS = {
    'f_order1': (33, ORDER1),
    'c_order': (33, dict(ORDER1, chunk_order='C')),
    'order2': (33, {'time_diff_order': 2, 'do_spatial_diff': False}),
    'spatial': (33, {'time_diff_order': 1, 'do_spatial_diff': True}),
    'segment_tables': (33, dict(ORDER1, ans_table_mode='segment',
                                ans_seg_log2=8)),
    'unaligned': (33, dict(ORDER1, ans_channel_segments=False)),
    'chunk_1': (1, ORDER1),
    'chunk_1_c_order': (1, dict(ORDER1, chunk_order='C')),
    'chunk_1_order2': (1, {'time_diff_order': 2, 'do_spatial_diff': False}),
    'chunk_1_spatial': (1, {'time_diff_order': 1, 'do_spatial_diff': True}),
    'chunk_2': (2, ORDER1),
}
C = 7


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')


def _source(dtype, n, seed=0, plant=True):
    """A walk around 3 * 2**40 (uint64: around 2**63) with the range's
    ends planted, so that every byte plane matters and the diffs wrap;
    float64 is the walk x 1.5 with NaN and both infinities. Without
    ``plant``, the walk alone (its chunks code the same plane modes)."""
    rng = np.random.default_rng(seed)
    walk = (np.cumsum(rng.integers(-2000, 2000, size=(n, C)), axis=0)
            + (np.int64(3) << 40))
    if dtype == 'float64':
        arr = walk * 1.5
        if plant:
            arr.reshape(-1)[[1, 2 * C, 3 * C + 1]] = [np.nan, np.inf,
                                                       -np.inf]
        return arr
    if plant:
        flat = walk.reshape(-1)
        idx = rng.choice(flat.size, size=min(flat.size, EXTREMES.size),
                         replace=False)
        flat[idx] = EXTREMES[:idx.size]
    if dtype == 'uint64':
        return walk.view(np.uint64) + (np.uint64(1) << np.uint64(63))
    return walk


def _bits(arr):
    return np.ascontiguousarray(arr).view(np.int64)


def _compress(tmp_path, name, arr, T, opts, device, package=mt):
    path = write_arr(tmp_path / 'src.bin', arr)
    cbin, ch = tmp_path / (name + '.cbin'), tmp_path / (name + '.ch')
    package.compress(path, cbin, ch, sample_rate=float(T), n_channels=C,
                     dtype=str(arr.dtype), algorithm='ans', quiet=True,
                     check_after_compress=False, device=device, **opts)
    return cbin, ch


@pytest.fixture
def packs(monkeypatch):
    """Chunks of each batch the port staged for its device decode."""
    calls = []
    real = tp.DeviceBatchDecoder.pack

    def spy(self, parsed_list, n_samples, mesh=None):
        calls.append(len(parsed_list))
        return real(self, parsed_list, n_samples, mesh=mesh)

    monkeypatch.setattr(tp.DeviceBatchDecoder, 'pack', spy)
    return calls


# --- the twins at the ends of the range ----------------------------------

def _planted(shape, seed):
    """(B, T, C) int64 over the whole range with every extreme in it."""
    v = np.random.default_rng(seed).integers(
        I64.min, I64.max, size=shape, endpoint=True, dtype=np.int64)
    v.reshape(-1)[:EXTREMES.size] = EXTREMES
    return v


def test_wrap_to_keeps_int64_as_it_is():
    """At 64 bits int64 is the element's own width: ``wrap_to`` returns
    the values unchanged (no mask of ``2**64 - 1``, no float, no Python
    int in between)."""
    v = torch.from_numpy(np.concatenate([EXTREMES, _planted((40,), 1)]))
    got = dd.wrap_to(v, torch.int64)
    assert got.dtype == torch.int64 and torch.equal(got, v)


@pytest.mark.parametrize('dtype', ['int64', 'uint64'])
def test_zigzag_at_the_extremes(dtype):
    """``zigzag_encode`` of int64 bits equals the JAX package's host
    zigzag (numpy, the codec's normative one) at and around the ends of
    the range, ``s + s`` wrapping; ``zigzag_decode`` inverts it."""
    bits = np.concatenate([EXTREMES, _planted((64,), 2).reshape(-1)])
    values = bits.view(dtype)
    want = jax_rans.zigzag_encode(values)
    got = dd.zigzag_encode(torch.from_numpy(bits))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().view(np.uint64), want)
    assert np.array_equal(dd.zigzag_decode(got).numpy(), bits)
    assert np.array_equal(
        jax_rans.zigzag_decode(want, np.dtype(dtype)).view(np.int64), bits)
    # The ends: 0 -> 0, -1 -> 1, 1 -> 2, min -> 2**64 - 1, max -> 2**64 - 2.
    ends = dd.zigzag_encode(torch.tensor([0, -1, 1, I64.min, I64.max]))
    assert ends.numpy().view(np.uint64).tolist() == [
        0, 1, 2, 2**64 - 1, 2**64 - 2]


@pytest.mark.parametrize('dtype', ['int64', 'uint64'])
def test_diffs_wrap_like_the_host_delta(dtype):
    """``diff_time`` and ``diff_space`` of (B, T, C) int64 bits are the
    JAX package's in-dtype ``diff_along_axis`` (time: axis 0, channels:
    axis 1) chunk by chunk, wrapping at the extremes."""
    bits = _planted((3, 9, C), 3)
    x = torch.from_numpy(bits)
    for op, axis in ((dd.diff_time, 0), (dd.diff_space, 1)):
        got = op(x).numpy()
        for b in range(bits.shape[0]):
            want = jax_delta.diff_along_axis(bits[b].view(dtype), axis=axis)
            assert np.array_equal(got[b], want.view(np.int64)), (op, b)


@pytest.mark.parametrize('dtype', ['int64', 'uint64'])
def test_scan_twins_wrap_like_the_host_cumsum(dtype):
    """The int64 twins of K5 (``cumsum_time_ref``; ``cumsum_time`` on a
    CPU tensor), of K4 (``cumsum_time_transposed``, inclusive and
    head-seeded) and ``cumsum_space`` equal the JAX package's in-dtype
    ``cumsum_along_axis``, and each inverts its diff."""
    bits = _planted((2, 70, C), 4)     # 70 steps: past K4's, K5's segments
    x = torch.from_numpy(bits)
    want_t = np.stack([jax_delta.cumsum_along_axis(b.view(dtype), axis=0)
                       for b in bits]).view(np.int64)
    want_s = np.stack([jax_delta.cumsum_along_axis(b.view(dtype), axis=1)
                       for b in bits]).view(np.int64)
    for fn in (dd.cumsum_time_ref, dd.cumsum_time):
        got = fn(x)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want_t)
    assert np.array_equal(dd.cumsum_space(x).numpy(), want_s)
    elems = x.transpose(1, 2).contiguous()
    assert np.array_equal(dd.cumsum_time_transposed(elems).numpy(), want_t)
    # Head-seeded: the first sample plus the exclusive scan of the rest.
    seeded = dd.cumsum_time_transposed(elems[:, :, 1:], x[:, 0], n_samples=70)
    assert np.array_equal(seeded.numpy(), want_t)
    assert np.array_equal(dd.cumsum_time(dd.diff_time(x)).numpy(), bits)
    assert np.array_equal(dd.cumsum_space(dd.diff_space(x)).numpy(), bits)


def test_generic_elems_combine_eight_planes():
    """The generic route's plane combine takes 8 byte planes, LSB first,
    into int64 bits; the inverse zigzag runs at 64 bits."""
    bits = np.concatenate([EXTREMES, _planted((36,), 5)]).reshape(1, -1)
    planes = np.ascontiguousarray(bits.view(np.uint8).reshape(1, -1, 8)
                                  .transpose(0, 2, 1))
    lay = tp.Layout(B=1, T=bits.shape[1] + 1, C=1, itemsize=8,
                    modes=(0,) * 8, n_seg=0, seg=0, G=0, S=0, order='C',
                    do_time_diff=True, diff_order=1, do_spatial_diff=False,
                    zigzag=False, has_head=True, aligned=False,
                    tail_split=1, fixups=0)
    raw = torch.from_numpy(planes)
    const = torch.zeros((1, 1), dtype=torch.uint8)
    got = tp.generic_elems(None, const, raw, lay)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), bits)
    zz = tp.generic_elems(None, const, raw,
                          dataclasses.replace(lay, zigzag=True))
    assert np.array_equal(
        zz.numpy(), jax_rans.zigzag_decode(bits.view(np.uint64), np.int64))


# --- the device route end to end ------------------------------------------

@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('dtype', DTYPES)
def test_device_encode_writes_the_jax_host_codecs_bytes(tmp_path, dtype,
                                                        layout):
    """``compress(device='cpu')`` (the transform, 8 byte planes and K6's
    twin) writes the JAX package's host-codec file and the port's host
    route's, every chunk on the device route."""
    T, opts = LAYOUTS[layout]
    arr = _source(dtype, 4 * T + max(T // 2, 1))
    mt.reset_launch_counts()
    dev = _compress(tmp_path, 'dev', arr, T, opts, 'cpu')
    assert mt.launch_counts()['host_encoded_chunks'] == 0
    host = _compress(tmp_path, 'host', arr, T, opts, 'none')
    ref = _compress(tmp_path, 'ref', arr, T, opts, 'none',
                    package=mtscomp_tpu)
    for i in range(2):
        assert dev[i].read_bytes() == host[i].read_bytes() \
            == ref[i].read_bytes()


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('dtype', DTYPES)
def test_device_decode_returns_the_source(tmp_path, dtype, layout, packs):
    """The JAX package's file decoded on the device route: ``to_array``,
    ``to_tensor`` (uint64 as a ``torch.uint64`` view of the int64 bits)
    and windows equal the source and the JAX package's host decode, with
    every chunk staged for the device decode and none on the host
    codec."""
    T, opts = LAYOUTS[layout]
    n = 4 * T + max(T // 2, 1)
    arr = _source(dtype, n)
    cbin, ch = _compress(tmp_path, 'ref', arr, T, opts, 'none',
                         package=mtscomp_tpu)
    ref = mtscomp_tpu.decompress(cbin, ch, quiet=True, device='none')
    r = mt.decompress(cbin, ch, quiet=True, device='cpu')
    try:
        mt.reset_launch_counts()
        got = r.to_array()
        assert got.dtype == arr.dtype and _bits(got).tobytes() \
            == _bits(arr).tobytes() == _bits(ref[:]).tobytes()
        assert sum(packs) == r.n_chunks
        t = r.to_tensor()
        assert t.dtype == getattr(torch, dtype)
        assert t.view(torch.int64).numpy().tobytes() == _bits(arr).tobytes()
        for a, b in ((0, 1), (T - 1, T + 1), (1, n - 1), (n - 1, n)):
            win = r[a:b]
            assert win.dtype == arr.dtype
            assert _bits(win).tobytes() == _bits(arr[a:b]).tobytes() \
                == _bits(ref[a:b]).tobytes()
        assert _bits(r[::3]).tobytes() == _bits(arr[::3]).tobytes()
        assert mt.launch_counts()['host_fallback_chunks'] == 0
    finally:
        r.close()
        ref.close()


@pytest.mark.parametrize('mesh', [None, 2])
@pytest.mark.parametrize('dtype', DTYPES)
def test_decompress_multi_of_wide_probes(tmp_path, dtype, mesh, packs):
    """Two probes of 8-byte items through ``decompress_multi``, merged in
    one batch (and sharded over ``chunk_mesh(['cpu'] * 2)``): each the
    source and the JAX package's host decode."""
    T = 33
    arrs = [_source(dtype, 4 * T, seed=s, plant=False) for s in (6, 7)]
    readers, refs = [], []
    try:
        for k, arr in enumerate(arrs):
            sub = tmp_path / str(k)
            sub.mkdir()
            cbin, ch = _compress(sub, 'p', arr, T, ORDER1, 'none')
            readers.append(mt.decompress(cbin, ch, quiet=True, device='cpu'))
            refs.append(mtscomp_tpu.decompress(cbin, ch, quiet=True,
                                               device='none'))
        mt.reset_launch_counts()
        outs = mt.decompress_multi(
            readers, mesh=None if mesh is None else chunk_mesh(['cpu'] * 2))
        assert packs == [8]
        for got, arr, ref in zip(outs, arrs, refs):
            assert got.dtype == arr.dtype
            assert _bits(got).tobytes() == _bits(arr).tobytes() \
                == _bits(ref[:]).tobytes()
        assert mt.launch_counts()['host_fallback_chunks'] == 0
    finally:
        for r in readers + refs:
            r.close()


@pytest.mark.parametrize('dtype', DTYPES)
def test_encode_batch_on_a_mesh(tmp_path, dtype):
    """``encode_batch(mesh=chunk_mesh(['cpu'] * 2))`` of 8-byte chunks:
    the host codec's containers, K6's groups split across the mesh."""
    T = 33
    arr = _source(dtype, 4 * T, seed=8)
    path = write_arr(tmp_path / 'w.bin', arr)
    w = mt.Writer(algorithm='ans', quiet=True, device='cpu', **ORDER1)
    try:
        w.open(path, sample_rate=float(T), n_channels=C, dtype=dtype)
        chunks = np.stack([np.asarray(w.get_chunk(i)) for i in range(4)])
        enc = tp.DeviceBatchEncoder(w, device='cpu')
        assert enc.supported(T) and enc.supported(1)
        got = enc.encode_batch(chunks, mesh=chunk_mesh(['cpu'] * 2))
        for b in range(4):
            assert got[b] == w.codec.encode(w._transform_chunk(chunks[b]),
                                            order=w.chunk_order)
    finally:
        w.close()


def test_foreign_byte_order_still_declined(tmp_path):
    """A non-native byte order is what ``supported()`` still declines,
    on both sides: big-endian int64 decodes and encodes on the host
    codec, counted, with the source's values."""
    arr = _source('int64', 100).astype('>i8')
    mt.reset_launch_counts()
    cbin, ch = _compress(tmp_path, 'be', arr, 33, ORDER1, 'cpu')
    assert mt.launch_counts()['host_encoded_chunks'] == 4
    host = _compress(tmp_path, 'host', arr, 33, ORDER1, 'none')
    assert cbin.read_bytes() == host[0].read_bytes()
    r = mt.decompress(cbin, ch, quiet=True, device='cpu')
    try:
        assert np.array_equal(r.to_array(), arr)
        assert mt.launch_counts()['host_fallback_chunks'] == 4
    finally:
        r.close()
