"""PyTorch port: the device encode's transform stage.

The port's ``_build_transform_fn`` (time diff of order 1 or 2, spatial
diff, zigzag, F- or C-order flattening, byte planes and their
histograms, in plain torch) gives the same planes, histograms and head
rows as the JAX package's jitted function of the same name, for
int16, uint16, uint8 and int8 chunks; the plain ops it is made of equal
their JAX counterparts.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from mtscomp_tpu.ops import device_delta as jdd  # noqa: E402
from mtscomp_tpu.ops.device_hist import histogram256 as j_hist  # noqa: E402
from mtscomp_tpu.parallel import pipeline as jpl  # noqa: E402

from mtscomp_tpu_torch.ops import device_delta as dd  # noqa: E402
from mtscomp_tpu_torch.ops.device_hist import histogram256  # noqa: E402
from mtscomp_tpu_torch.parallel import pipeline as tp  # noqa: E402

DTYPES = ['int16', 'uint16', 'uint8', 'int8']
#: name: (order, do_time_diff, do_spatial_diff, diff_order)
TRANSFORMS = {'order1_F': ('F', True, False, 1),
              'order2_F': ('F', True, False, 2),
              'spatial_F': ('F', True, True, 1),
              'order1_C': ('C', True, False, 1),
              'no_diff_C': ('C', False, False, 1)}


def _chunks(dtype, B=3, T=70, C=13, seed=0):
    """Seeded random walks with wide steps, so that both byte planes
    vary and the wrapping arithmetic is exercised."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(0, 900, size=(B, T, C)), axis=1)
    bits = np.dtype(dtype).itemsize * 8
    return (walk.astype(np.int64) % (1 << bits)).astype(
        'uint%d' % bits).view(dtype)


def _bits(a):
    """A numpy array's bits as the port's tensor dtype."""
    return torch.from_numpy(a.view(tp._BITS[a.dtype.itemsize][1]).copy())


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_transform_matches_jax(dtype, name):
    order, time_diff, spatial, diff_order = TRANSFORMS[name]
    chunks = _chunks(dtype, seed=DTYPES.index(dtype))
    B, T, C = chunks.shape
    args = (B, T, C, dtype, order, time_diff, spatial, True, diff_order)
    j_planes, j_hists, j_head = jpl._build_transform_fn(*args)(
        jnp.asarray(chunks))
    planes, hists, head = tp._build_transform_fn(*args)(_bits(chunks))
    assert planes.dtype == torch.uint8
    assert np.array_equal(planes.numpy(), np.asarray(j_planes))
    assert np.array_equal(hists.numpy(), np.asarray(j_hists))
    assert np.array_equal(head.numpy().view(dtype), np.asarray(j_head))


def test_transform_without_head():
    chunks = _chunks('int16', seed=9)
    args = chunks.shape + ('int16', 'F', True, False, False, 1)
    j_planes, j_hists, j_head = jpl._build_transform_fn(*args)(
        jnp.asarray(chunks))
    planes, hists, head = tp._build_transform_fn(*args)(_bits(chunks))
    assert head is None and j_head is None
    assert np.array_equal(planes.numpy(), np.asarray(j_planes))
    assert np.array_equal(hists.numpy(), np.asarray(j_hists))


@pytest.mark.parametrize('dtype', DTYPES)
def test_diffs_and_zigzag_match_jax(dtype):
    x = _chunks(dtype, seed=20 + DTYPES.index(dtype))
    t = _bits(x)
    for ours, theirs in ((dd.diff_time, jdd.diff_time_jnp),
                         (dd.diff_space, jdd.diff_space_jnp)):
        assert np.array_equal(ours(t).numpy().view(dtype),
                              np.asarray(theirs(jnp.asarray(x))))
    z = np.asarray(jdd.zigzag_encode_jnp(jnp.asarray(x)))
    got = dd.zigzag_encode(t).numpy().view(z.dtype)
    assert np.array_equal(got, z)


@pytest.mark.parametrize('N,n', [(1, 1), (5, 129), (40, 3000), (2, 0)])
def test_histogram256_matches_jax(N, n, monkeypatch):
    rng = np.random.default_rng(N * 7 + n)
    v = np.minimum(rng.geometric(0.03, size=(N, n)), 255).astype(np.uint8)
    v[:, ::7] = 255
    # Small blocks: the row blocking is exercised too.
    monkeypatch.setattr('mtscomp_tpu_torch.ops.device_hist.BLOCK', 2000)
    got = histogram256(torch.from_numpy(v))
    assert got.dtype == torch.int64 and tuple(got.shape) == (N, 256)
    want = (np.asarray(j_hist(jnp.asarray(v))) if n
            else np.zeros((N, 256), np.int64))
    assert np.array_equal(got.numpy(), want)
    assert (got.sum(dim=1) == n).all()
