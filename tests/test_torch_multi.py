"""PyTorch port: ``decompress_multi`` (several probes, one device batch).

The twin of the JAX package's multi-probe tests (``tests/test_device.py``,
``tests/test_transform_adapt.py``), without ``mesh`` (which
``tests/test_torch_mesh.py`` holds): on the same files,
the port (``device='cpu'``: the kernels' plain twins) and the JAX package
(Pallas in interpret mode) give the same arrays, equal to the sources
(tolerance 0); probes that must not merge fall back per reader; the
ValueErrors are the reference's. A spy on ``decode_tensor`` shows which
calls merged.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
from mtscomp_tpu.parallel.pipeline import (  # noqa: E402
    decompress_multi as ref_decompress_multi)
import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

from conftest import make_signal, to_int16, write_arr  # noqa: E402
from test_transform_adapt import NC, SR, drifting_signal  # noqa: E402


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')


@pytest.fixture
def decode_calls(monkeypatch):
    """Chunks per ``decode_tensor`` call of the port, in call order."""
    calls = []
    real = tp.DeviceBatchDecoder.decode_tensor

    def spy(self, parsed_list, n_samples):
        calls.append(len(parsed_list))
        return real(self, parsed_list, n_samples)

    monkeypatch.setattr(tp.DeviceBatchDecoder, 'decode_tensor', spy)
    return calls


def _colored(probe, nc=12, n_chunks=2):
    return to_int16(make_signal('colored', ns=n_chunks * 2000, nc=nc)) + probe


def _smooth(probe):
    t = np.arange(2 * 2000) / 2000.0
    return (np.sin(2 * np.pi * 4.0 * t)[:, None] * 11000.
            + np.random.RandomState(0).normal(0, 15., (2 * 2000, 12))
            ).astype(np.int16) + probe


# name: (per-probe (source, compress options), merged chunks per
# decode_tensor call of the port, None where the probes fall back, or
# 'either' where the payloads' geometry decides: the segment length and
# table mode are not decode identity, ``supported()`` settles it).
CASES = {
    'four_probes': ([(_colored(p, 16), dict(ans_seg_log2=12))
                     for p in range(4)], [8]),
    'mismatched_diff_flags': ([(_colored(0), dict(ans_seg_log2=12)),
                               (_colored(0), dict(ans_seg_log2=12,
                                                  do_time_diff=False))],
                              None),
    'mixed_orders': ([(_smooth(0), dict(ans_seg_log2=12, time_diff_order=1)),
                      (_smooth(1), dict(ans_seg_log2=12, time_diff_order=2))],
                     None),
    'mixed_seg_and_tables': ([(_colored(0), dict(ans_seg_log2=12,
                                                 ans_table_mode='segment')),
                              (_colored(1), dict(ans_seg_log2=10,
                                                 ans_table_mode='plane')),
                              (_colored(2), dict(ans_seg_log2=12,
                                                 ans_table_mode='plane'))],
                             'either'),
    'mixed_algorithms': ([(_colored(0, 9), dict(algorithm='zlib')),
                          (_colored(1, 9), {}), (_colored(2, 9), {})], None),
    'all_zlib': ([(_colored(0, 9), dict(algorithm='zlib'))] * 2, None),
    'one_probe': ([(_colored(3, 9), {})], [2]),
    'adaptive_mixed_windows': ([
        (drifting_signal(n_chunks=6, seed=10 + i), dict(
            transform_adapt=3, sample_rate=SR)) for i in range(2)], None),
    'float32_probes': ([((_colored(p).astype(np.float32) / 8), {})
                        for p in range(2)], [4]),
    'uint8_probes': ([((_colored(p) % 256).astype(np.uint8), {})
                      for p in range(3)], [6]),
}


def _open_all(tmp_path, probes):
    """Compress each probe with the port's host codec; readers of both
    packages on their device routes."""
    port, jaxr, arrs = [], [], []
    for i, (arr, opts) in enumerate(probes):
        opts = dict(dict(algorithm='ans', sample_rate=2000.0), **opts)
        path = write_arr(tmp_path / ('p%d.bin' % i), arr)
        cbin, ch = tmp_path / ('p%d.cbin' % i), tmp_path / ('p%d.ch' % i)
        mt.compress(path, cbin, ch, n_channels=arr.shape[1], dtype=arr.dtype,
                    quiet=True, device='none', check_after_compress=False,
                    **opts)
        port.append(mt.decompress(cbin, ch, device='cpu', quiet=True))
        jaxr.append(ref.decompress(cbin, ch, device='cpu', quiet=True))
        arrs.append(arr)
    return port, jaxr, arrs


def _close(*lists):
    for readers in lists:
        for r in readers:
            r.close()


@pytest.mark.parametrize('name', sorted(CASES))
def test_decompress_multi_matches_jax_and_sources(tmp_path, name,
                                                  decode_calls):
    probes, merged = CASES[name]
    port, jaxr, arrs = _open_all(tmp_path, probes)
    try:
        outs = mt.decompress_multi(port)
        calls = list(decode_calls)
        want = ref_decompress_multi(jaxr)
        assert len(outs) == len(want) == len(arrs)
        for got, w, arr in zip(outs, want, arrs):
            assert got.dtype == w.dtype == arr.dtype
            assert got.shape == w.shape == arr.shape
            assert got.tobytes() == w.tobytes() == arr.tobytes()
        if merged == 'either':
            assert sum(calls) == sum(r.n_chunks for r in port)
        elif merged is not None:
            assert calls == merged            # one batch over all probes
        else:
            # Per-reader fallback: no call holds more than one probe's
            # chunks (zlib probes make none).
            assert all(n <= port[0].n_chunks for n in calls)
    finally:
        _close(port, jaxr)


def test_adaptive_probes_merge_inside_one_window(tmp_path, decode_calls):
    """Adaptive probes whose range lies in one window (one transform)
    still merge into a single batch."""
    probes = [(drifting_signal(n_chunks=8, seed=20 + i),
               dict(transform_adapt=4, sample_rate=SR)) for i in range(2)]
    port, jaxr, arrs = _open_all(tmp_path, probes)
    try:
        assert port[0].n_channels == NC
        outs = mt.decompress_multi(port, first_chunk=0, last_chunk=3)
        want = ref_decompress_multi(jaxr, first_chunk=0, last_chunk=3)
        for got, w, arr in zip(outs, want, arrs):
            assert np.array_equal(got, arr[:4 * 2000])
            assert np.array_equal(got, w)
        assert decode_calls == [8]
    finally:
        _close(port, jaxr)


def test_short_probe_and_bad_ranges_raise(tmp_path):
    probes = [(_colored(i, 9, n), {}) for i, n in enumerate([5, 2])]
    port, jaxr, arrs = _open_all(tmp_path, probes)
    try:
        for multi, readers in ((mt.decompress_multi, port),
                               (ref_decompress_multi, jaxr)):
            with pytest.raises(ValueError, match='common chunk range'):
                multi(readers)
            with pytest.raises(ValueError, match='invalid chunk range'):
                multi(readers, first_chunk=-1, last_chunk=1)
            with pytest.raises(ValueError, match='invalid chunk range'):
                multi(readers, first_chunk=1, last_chunk=0)
            outs = multi(readers, last_chunk=1)
            for out, arr in zip(outs, arrs):
                assert out.shape[0] == 2 * 2000
                assert np.array_equal(out, arr[:out.shape[0]])
        mid = mt.decompress_multi(port, first_chunk=1, last_chunk=1)
        for out, arr in zip(mid, arrs):
            assert np.array_equal(out, arr[2000:4000])
    finally:
        _close(port, jaxr)


@pytest.mark.parametrize('mesh', [object(), 0, 'mesh'])
def test_mesh_is_not_ported(tmp_path, mesh):
    """``mesh`` takes a mesh of ``parallel/mesh.py`` or None (the
    ``mesh=`` path is ported: ``tests/test_torch_mesh.py``); any other
    value raises TypeError, keyword or positional, before any decode."""
    port, jaxr, _arrs = _open_all(tmp_path, [(_colored(0), {})])
    try:
        with pytest.raises(TypeError, match='chunk_mesh'):
            mt.decompress_multi(port, mesh=mesh)
        with pytest.raises(TypeError):
            tp.decompress_multi(port, mesh, 0, None)     # positional too
    finally:
        _close(port, jaxr)


@pytest.mark.parametrize('device', ['none', 'cpu'])
def test_probes_follow_their_readers_device(tmp_path, device, decode_calls):
    """Readers opened with ``device='none'`` decode on the host codec,
    probe by probe; on a device they merge."""
    probes = [(_colored(p), dict(ans_seg_log2=12)) for p in range(2)]
    port, jaxr, arrs = _open_all(tmp_path, probes)
    _close(port)
    port = [mt.decompress(tmp_path / ('p%d.cbin' % i), device=device,
                          quiet=True) for i in range(2)]
    try:
        for out, arr in zip(mt.decompress_multi(port), arrs):
            assert np.array_equal(out, arr) and out.flags.writeable
        assert decode_calls == ([] if device == 'none' else [4])
    finally:
        _close(port, jaxr)
