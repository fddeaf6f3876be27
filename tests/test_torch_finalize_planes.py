"""PyTorch port, K2 + K3 on the card's route: the finalize as K4's plane
form with a CONST high plane and a tail block.

On the card the finalize runs K4's kernels behind a load stage that reads
the low plane's ``T - 1`` coded steps from one or two channel blocks
under one high byte a chunk. Its arithmetic is the plane form's, so here,
on the CPU, at tolerance 0 (byte equality):

- the plane form's twin over the blocks the kernel is given
  (``_finalize_blocks``: the views, the tail block joined on), with the
  high plane CONST, equals the finalize's twin ``_finalize_ref`` and an
  independent numpy computation, on the edge shapes ``chip_smoke.py`` runs
  on the card (``FINALIZE_EDGE_CASES``) and on staged fuse8 containers
  with and without a ragged tail;
- ``_decode_fuse8`` on the CPU equals the JAX package's decode of the
  same container (Pallas in interpret mode).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from mtscomp_tpu.parallel.pipeline import (  # noqa: E402
    DeviceBatchDecoder as JaxDecoder)

from mtscomp_tpu_torch.ops import device_delta as dd  # noqa: E402
from mtscomp_tpu_torch.ops import rans_decode as rd  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

from chip_smoke import (  # noqa: E402
    FINALIZE_EDGE_CASES, finalize_edge_call)
from test_torch_generic import GEOMS as GENERIC_GEOMS  # noqa: E402
from test_torch_generic import _file as _generic_file  # noqa: E402
from test_torch_pipeline import GEOMS, _file, _parsed  # noqa: E402


def _split(args):
    """A finalize call's ``(planes, tail or None, head (B, C), hi)``."""
    if len(args) == 3:
        planes, head, hi = args
        return planes, None, head, hi
    planes, tail, head, tail_head, hi = args
    return planes, tail, torch.cat([head, tail_head], dim=1), hi


def _plane_route(planes, tail, head, hi, T):
    """What the card computes: the plane form's twin over the kernel's
    channel blocks, the high plane one constant a chunk."""
    bulk, tail_block = dd._finalize_blocks(planes, tail, head.shape[1], T)
    lo = bulk if tail_block is None else torch.cat([bulk, tail_block], dim=1)
    return dd.cumsum_time_transposed_planes_ref(
        lo, hi.to(torch.uint8), head, n_samples=T, zigzag=True)


def _np_finalize(planes, tail, head, hi, T):
    lo = planes.numpy() if tail is None else np.concatenate(
        [planes.numpy(), tail.numpy()], axis=1)
    B, C = head.shape
    z = lo[:, :C, :max(T - 1, 0)].astype(np.int64) \
        | (hi.numpy().astype(np.int64)[:, None, None] << 8)
    d = (z >> 1) ^ -(z & 1)
    excl = np.concatenate([np.zeros((B, C, 1), np.int64),
                           np.cumsum(d, axis=2)], axis=2)[:, :, :T]
    out = (excl + head.numpy().astype(np.int64)[:, :, None]).astype(np.int16)
    return np.ascontiguousarray(out.transpose(0, 2, 1))


@pytest.mark.parametrize('case', list(FINALIZE_EDGE_CASES))
def test_finalize_edge_shapes(case):
    B, CA, CB, T_coded, variant = FINALIZE_EDGE_CASES[case]
    kernel, twin, args, kwargs = finalize_edge_call(case, 'cpu')
    assert kernel is (dd.cumsum_time_transposed_u8_tail if CB
                      else dd.cumsum_time_transposed_u8)
    planes, tail, head, hi = _split(args)
    T = dd._n_samples(planes, kwargs['n_samples'])
    assert T == {'plain': T_coded,
                 'short_out': max(T_coded - 3, 0)}.get(variant, T_coded + 1)
    got = kernel(*args, **kwargs)
    assert got.dtype == torch.int16 and tuple(got.shape) == (B, T, CA + CB)
    assert got.is_contiguous()
    assert torch.equal(got, twin(*args, **kwargs))
    assert torch.equal(got, _plane_route(planes, tail, head, hi, T))
    assert np.array_equal(got.numpy(), _np_finalize(planes, tail, head, hi,
                                                    T))


@pytest.mark.parametrize('CA,CB,C', [(0, 5, 5), (6, 4, 6), (6, 0, 6)])
def test_an_empty_block_drops_out(CA, CB, C):
    """All channels in the tail block, or none: the kernel is given the one
    block that has rows."""
    rng = np.random.default_rng(CA + CB)
    planes = torch.from_numpy(rng.integers(0, 256, (2, CA, 70), np.uint8))
    tail = torch.from_numpy(rng.integers(0, 256, (2, max(CB, 1), 70),
                                         np.uint8))
    head = torch.from_numpy(rng.integers(-99, 99, (2, C)).astype(np.int16))
    hi = torch.tensor([0, 255], dtype=torch.int32)
    bulk, tail_block = dd._finalize_blocks(planes, tail, C, 71)
    assert tail_block is None and tuple(bulk.shape) == (2, C, 70)
    assert torch.equal(
        _plane_route(planes, tail, head, hi, 71),
        dd._finalize_ref(planes, tail, head, hi, 71))


def _staged_fuse8(reader, T):
    parsed = _parsed(reader)
    dec = tp.DeviceBatchDecoder(reader, 'cpu')
    assert dec.supported(parsed, T)
    fn, args = dec.pack(parsed, T)
    assert fn.func is tp._decode_fuse8
    return parsed, dec, fn, args


@pytest.mark.parametrize('name', GEOMS)
def test_staged_fuse8_container(tmp_path_, monkeypatch, name):
    """K1's rows of a staged fuse8 batch, with and without a ragged tail:
    the plane route equals the finalize's twin, and the whole
    ``_decode_fuse8`` the JAX package's decode and the source."""
    arr, r, T = _file(tmp_path_, name, monkeypatch)
    try:
        parsed, dec, fn, args = _staged_fuse8(r, T)
        kw = fn.keywords
        assert (kw['tail'] is not None) == (name == 'ragged129')
        syms, _used = rd.decode_groups(*args[:5], kw['S'])
        bulk, tail_block = tp.fuse8_planes(syms, B=kw['B'], G=kw['G'],
                                           k=kw['k'], tp=kw['tp'],
                                           tail=kw['tail'])
        heads, hi = args[7], args[5][:, 0]
        assert bulk.shape[2] == kw['tp'] >= T - 1
        want = dd._finalize_ref(bulk, tail_block, heads, hi, T)
        assert torch.equal(_plane_route(bulk, tail_block, heads, hi, T),
                           want)
        out, used = fn(*args)
        assert torch.equal(out, want)
        tp.check_words_used(parsed, used)
        jax_out = JaxDecoder(r).decode_batch(parsed, T)
        assert np.array_equal(out.numpy().view(arr.dtype), jax_out)
        assert np.array_equal(jax_out.reshape(arr.shape), arr)
    finally:
        r.close()


def test_staged_order2_fuse8_container(tmp_path_, monkeypatch):
    """Second-order files: the finalize inverts one diff, K5 the other."""
    arr, r, T = _generic_file(tmp_path_, monkeypatch, 'order2_fuse8')
    assert GENERIC_GEOMS['order2_fuse8'][4] == 'fuse8'
    try:
        parsed, dec, fn, args = _staged_fuse8(r, T)
        assert fn.keywords['diff_order'] == 2
        out, _used = fn(*args)
        jax_out = JaxDecoder(r).decode_batch(parsed, T)
        assert np.array_equal(out.numpy().view(arr.dtype), jax_out)
        assert np.array_equal(jax_out.reshape(arr.shape), arr)
    finally:
        r.close()


def test_cuda_route_refuses_other_devices():
    planes = torch.zeros((1, 4, 8), dtype=torch.uint8)
    head = torch.zeros((1, 4), dtype=torch.int16)
    hi = torch.zeros((1,), dtype=torch.uint8)
    with pytest.raises(ValueError, match='CUDA or CPU'):
        dd._launch(planes.to('meta'), None, head.to('meta'), hi.to('meta'), 8)
