"""PyTorch port: K4's plane form, the generic route's choice of it, and
the time scans' edge shapes.

The plane form (``cumsum_time_transposed_planes``) reads the two byte
planes of 2-byte elements in place of the torch plane combine. Its plain
twin is held, exactly, against that combine + the element form's twin on
the staged tensors of real containers (two coded planes, rANS + CONST,
RAW + rANS; zigzag on and off; head-seeded and inclusive), and the route
that takes it against the JAX package's decode of the same container
(Pallas in interpret mode). ``pack`` must pick the plane form for
exactly the layouts whose rANS planes are strided views of K1's rows.
Every form of K4 and K5 (int16, int32 and int64) runs the edge shapes
the card runs (``chip_smoke.SCAN_EDGE_CASES``) through its twin against
numpy's cumsum in the element's width. Tolerance 0 throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from mtscomp_tpu.parallel.pipeline import (  # noqa: E402
    DeviceBatchDecoder as JaxDecoder)

from mtscomp_tpu_torch.codec.ans import (  # noqa: E402
    MODE_CONST, MODE_RANS, MODE_RAW)
from mtscomp_tpu_torch.ops import device_delta as dd  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

from chip_smoke import (  # noqa: E402
    SCAN_EDGE_CASES, edge_n_samples, scan_edge_arrays, scan_edge_calls,
    staged_planes)
from test_torch_generic import GEOMS, _file, _parsed  # noqa: E402

#: The geometries of ``test_torch_generic`` whose batches K4's plane form
#: decodes: 2-byte, F order, time diff, no spatial diff, channel-aligned
#: whole-segment rows without bit6 sub-rows.
PLANE_FORM = {'spiky_int16', 'spiky_uint16', 'order2_generic', 'raw_plane',
              'foreign_1fixup', 'foreign_2fixups'}

#: Geometries by the planes they stage: two coded planes (first- and
#: second-order diff, another writer's tables), rANS under a CONST high
#: plane (bit6 sub-rows: reassembled copies), RAW low plane under rANS.
STAGED = {'spiky_int16': (MODE_RANS, MODE_RANS),
          'order2_generic': (MODE_RANS, MODE_RANS),
          'foreign_2fixups': (MODE_RANS, MODE_RANS),
          'bit6_spatial': (MODE_RANS, MODE_CONST),
          'raw_plane': (MODE_RAW, MODE_RANS)}


def _staged(tmp_path, monkeypatch, name):
    """(source, layout, tensors, K1 twin's rows) of geometry ``name``."""
    arr, r, T = _file(tmp_path, monkeypatch, name)
    try:
        parsed = _parsed(r, T)
        fn, args = tp.DeviceBatchDecoder(r, 'cpu').pack(parsed, T)
    finally:
        r.close()
    lay = fn.keywords['lay']
    syms = None
    if lay.planes(MODE_RANS):
        assert lay.fixups == 0 or name.startswith('foreign')
        syms, _used = tp._k1(*args[:5], lay.S, lay.fixups)
    return arr, lay, args, syms


@pytest.mark.parametrize('seeded', [True, False], ids=['seeded', 'inclusive'])
@pytest.mark.parametrize('zigzag', [True, False], ids=['zigzag', 'plain'])
@pytest.mark.parametrize('name', sorted(STAGED))
def test_plane_twin_equals_combine_and_element_twin(tmp_path_, monkeypatch,
                                                    name, zigzag, seeded):
    _arr, lay, args, syms = _staged(tmp_path_, monkeypatch, name)
    assert lay.modes == STAGED[name] and lay.itemsize == 2
    const_vals, raw_vals, heads = args[5:8]
    lo, hi = staged_planes(syms, const_vals, raw_vals, lay)
    head = heads if seeded else None
    n = lay.T if seeded else lay.Tc
    got = dd.cumsum_time_transposed_planes(lo, hi, head, n_samples=n,
                                           zigzag=zigzag)
    elems = tp.generic_elems(syms, const_vals, raw_vals,
                             dataclasses.replace(lay, zigzag=zigzag))
    want = dd.cumsum_time_transposed_ref(
        elems.view(lay.B, lay.C, lay.Tc), head, n_samples=n)
    assert got.dtype == torch.int16 and tuple(got.shape) == (lay.B, n, lay.C)
    assert torch.equal(got, want)
    assert torch.equal(got, dd.cumsum_time_transposed_planes_ref(
        lo, hi, head, n_samples=n, zigzag=zigzag))


@pytest.mark.parametrize('name', sorted(GEOMS))
def test_pack_routes_plane_form(tmp_path_, monkeypatch, name):
    """The plane form decodes exactly the layouts it is named for; every
    other one keeps the plane combine and the element forms."""
    arr, r, T = _file(tmp_path_, monkeypatch, name)
    try:
        parsed = _parsed(r, T)
        fn, args = tp.DeviceBatchDecoder(r, 'cpu').pack(parsed, T)
        p0 = parsed[0]
        transform = (r.chunk_order == 'F' and r.cmeta.do_time_diff
                     and not r.cmeta.do_spatial_diff)
        rule = (fn.func is tp._decode_generic and p0['itemsize'] == 2
                and transform and bool(p0['aligned'])
                and p0.get('tail_split', 1) == 1
                and MODE_RANS in p0['modes']
                and p0['seg'] % 128 == 0 and p0['seg'] <= p0['n_stream'])
        assert rule == (name in PLANE_FORM)
        if fn.func is tp._decode_generic:
            assert fn.keywords['lay'].plane_form == rule
        calls = []
        for entry in ('cumsum_time_transposed_planes',
                      'cumsum_time_transposed', 'generic_elems'):
            def spy(*a, _f=getattr(tp, entry), _n=entry, **kw):
                calls.append(_n)
                return _f(*a, **kw)
            monkeypatch.setattr(tp, entry, spy)
        out, _used = fn(*args)
        if rule:
            assert calls == ['cumsum_time_transposed_planes']
        else:
            assert 'cumsum_time_transposed_planes' not in calls
        code = np.dtype(getattr(r, 'code_dtype', r.dtype))
        src = arr[:len(parsed) * T].view(code)
        assert np.array_equal(out.numpy().view(code).reshape(src.shape), src)
    finally:
        r.close()


@pytest.mark.parametrize('name', sorted(PLANE_FORM))
def test_plane_route_matches_jax_decode(tmp_path_, monkeypatch, name):
    arr, r, T = _file(tmp_path_, monkeypatch, name)
    try:
        parsed = _parsed(r, T)
        got = tp.DeviceBatchDecoder(r, 'cpu').decode_batch(parsed, T)
        want = JaxDecoder(r).decode_batch(parsed, T)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    finally:
        r.close()


@pytest.mark.parametrize('name', sorted(PLANE_FORM))
def test_plane_views_equal_reassembled_planes(tmp_path_, monkeypatch, name):
    """The strided views of K1's rows hold what ``_rans_planes`` copies
    out of them, pads skipped, and share K1's storage."""
    _arr, lay, args, syms = _staged(tmp_path_, monkeypatch, name)
    assert lay.plane_form
    planes = tp.generic_planes(syms, args[5], args[6], lay)
    copies = tp._rans_planes(syms, lay)
    for j, p in enumerate(lay.planes(MODE_RANS)):
        view = planes[p]
        assert tuple(view.shape) == (lay.B, lay.C, lay.Tc)
        assert view.stride() == (syms[0].numel() * lay.G, lay.tp, 1)
        assert view.untyped_storage().data_ptr() \
            == syms.untyped_storage().data_ptr()
        assert torch.equal(view.reshape(lay.B, -1), copies[:, j])
    for j, p in enumerate(lay.planes(MODE_RAW)):
        assert torch.equal(planes[p].reshape(lay.B, -1), args[6][:, j])
    for j, p in enumerate(lay.planes(MODE_CONST)):
        assert torch.equal(planes[p], args[5][:, j])


def _np_scan(elems, head, n, dtype):
    """numpy's K4: (B, C, T') -> (B, n, C), cumsum in the element's width."""
    s = np.cumsum(elems, axis=2, dtype=dtype)
    if head is not None:
        s = np.concatenate([np.zeros_like(s[:, :, :1]), s], axis=2)
        s = (s + head[:, :, None]).astype(dtype)
    return np.ascontiguousarray(s[:, :, :n].transpose(0, 2, 1))


def _np_planes(lo, hi, zigzag):
    z = lo.astype(np.uint16) | (hi.astype(np.uint16) << 8)
    if zigzag:
        z = (z >> 1) ^ (-(z & 1).astype(np.int32)).astype(np.uint16)
    return z.view(np.int16)


@pytest.mark.parametrize('form', ['k5', 'k4', 'planes'])
@pytest.mark.parametrize('case', list(SCAN_EDGE_CASES))
def test_scan_edge_shapes_match_numpy(case, form):
    """The card's edge shapes through the twins (the entry points on CPU
    tensors), against numpy."""
    B, C, T, variant = SCAN_EDGE_CASES[case]
    a = scan_edge_arrays(case)
    n_run = 0
    for label, entry, _twin, args, kwargs in scan_edge_calls(case, 'cpu'):
        bits = next((b for b in (16, 32, 64) if 'i%d' % b in label), None)
        if label.startswith('K5') and form == 'k5':
            x = a['elems%d' % bits].transpose(0, 2, 1)
            want = np.cumsum(x, axis=1, dtype=np.dtype('int%d' % bits))
        elif label.startswith('K4 i') and form == 'k4':
            seeded = args[1] is not None
            want = _np_scan(a['elems%d' % bits],
                            a['head%d' % bits] if seeded else None,
                            edge_n_samples(T, variant, seeded),
                            np.dtype('int%d' % bits))
        elif label.startswith('K4 planes') and form == 'planes':
            lo = a['lo_const'][:, None, None].repeat(C, 1).repeat(T, 2) \
                if 'const lo' in label else a['lo']
            hi = a['hi_const'][:, None, None].repeat(C, 1).repeat(T, 2) \
                if 'const hi' in label else a['hi']
            seeded = args[2] is not None
            want = _np_scan(_np_planes(lo, hi, kwargs['zigzag']),
                            a['head16'] if seeded else None,
                            edge_n_samples(T, variant, seeded), np.int16)
        else:
            continue
        got = entry(*args, **kwargs)
        assert got.is_contiguous() and tuple(got.shape) == want.shape, label
        assert np.array_equal(got.numpy(), want), label
        n_run += 1
    assert n_run == {'k5': 3, 'k4': 6, 'planes': 12}[form]
    assert not any(dd.launches.values())       # the twins never count


@pytest.mark.parametrize('C,itemsize', [(1, 2), (7, 4), (385, 2), (385, 4),
                                        (1025, 2), (32768, 2), (32769, 2),
                                        (40000, 4), (7, 8), (385, 8),
                                        (8192, 8), (8193, 8), (40000, 8)])
def test_scan_geometries(C, itemsize):
    """K5's tile fits its shared-memory budget and covers the channels in
    even tiles; K4's tile is a multiple of 32 of at most 256 channels."""
    n_steps, c_tile = dd.cumsum_time_geometry(C, itemsize)
    assert 1 <= n_steps <= dd.K5_SEG_STEPS
    assert n_steps * min(c_tile, C) * itemsize <= dd.K5_TILE_BYTES
    assert (c_tile >= C) == (C * itemsize <= dd.K5_TILE_BYTES)
    n_ct = -(-C // c_tile)
    assert (n_ct - 1) * c_tile < C <= n_ct * c_tile
    k4_steps, k4_tile = dd.scan_transposed_geometry(C, itemsize)
    assert k4_steps * itemsize == 128
    assert k4_tile % 32 == 0 and 32 <= k4_tile <= dd.K4_MAX_C_TILE
    assert -(-C // k4_tile) == -(-C // dd.K4_MAX_C_TILE)


@pytest.mark.parametrize('case', ['dtype', 'const_dtype', 'shapes',
                                  'const_shape', 'no_rows', 'time_stride',
                                  'head_dtype', 'head_shape', 'head_device',
                                  'n_samples_incl', 'n_samples_excl'])
def test_plane_form_rejects_bad_inputs(case):
    rng = np.random.default_rng(11)
    lo = torch.from_numpy(rng.integers(0, 256, (2, 16, 64)).astype(np.uint8))
    hi = torch.from_numpy(rng.integers(0, 256, (2, 16, 64)).astype(np.uint8))
    c = torch.from_numpy(rng.integers(0, 256, (2,)).astype(np.uint8))
    h = torch.from_numpy(rng.integers(-9, 9, (2, 16)).astype(np.int16))
    f = dd.cumsum_time_transposed_planes
    with pytest.raises(ValueError):
        if case == 'dtype':
            f(lo.to(torch.int16), hi, h)
        elif case == 'const_dtype':
            f(lo, c.to(torch.int32), h)
        elif case == 'shapes':
            f(lo, hi[:, :, :63], h)
        elif case == 'const_shape':
            f(lo, c[:1], h)
        elif case == 'no_rows':
            f(c, c, h)
        elif case == 'time_stride':
            f(lo, hi.transpose(1, 2).contiguous().transpose(1, 2), h)
        elif case == 'head_dtype':
            f(lo, hi, h.to(torch.int32))
        elif case == 'head_shape':
            f(lo, hi, h[:, :8])
        elif case == 'head_device':
            f(lo, hi, h.to('meta'))
        elif case == 'n_samples_incl':
            f(lo, hi, None, n_samples=65)
        else:
            f(lo, hi, h, n_samples=66)
