"""PyTorch port, K4 and K5 and the plain integer ops of the decode.

The port's plain twins (what ``cumsum_time_transposed`` and
``cumsum_time`` run for CPU tensors) are held, exactly, against the JAX
package's Pallas kernels in interpret mode, and the plain ops against
the JAX package's XLA ops, on seeded random integers whose time and
channel counts are not multiples of 128. The JAX kernels need 128
multiples, so their inputs are zero-padded and their outputs trimmed,
as the JAX pipeline does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from mtscomp_tpu.ops import device_delta as jdd  # noqa: E402

from mtscomp_tpu_torch.ops import device_delta as dd  # noqa: E402

DTYPES = {'int16': (np.int16, torch.int16), 'int32': (np.int32, torch.int32)}


def _ints(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True,
                        dtype=np.int64).astype(dtype)


def _pad(a, axis, to=128):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, -a.shape[axis] % to)
    return np.pad(a, widths)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('mode', ['inclusive', 'exclusive'])
@pytest.mark.parametrize('B,C,T', [(2, 129, 300), (1, 40, 257)])
def test_cumsum_time_transposed_twin_matches_pallas(dtype, mode, B, C, T):
    np_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(C * T)
    elems = _ints(rng, (B, C, T), np_dt)
    head = _ints(rng, (B, C), np_dt) if mode == 'exclusive' else None
    # Pallas: channels and time padded to 128; the exclusive form is the
    # pipeline's head column in front of the diffs, scanned inclusively.
    ct = elems if head is None else np.concatenate([head[:, :, None],
                                                    elems], axis=2)
    n_out = ct.shape[2]
    ref = np.asarray(jdd.cumsum_time_transposed(
        jnp.asarray(_pad(_pad(ct, 2), 1)), interpret=True))[:, :n_out, :C]
    got = dd.cumsum_time_transposed(
        torch.from_numpy(elems),
        None if head is None else torch.from_numpy(head), n_samples=n_out)
    assert got.dtype == DTYPES[dtype][1]
    assert tuple(got.shape) == (B, n_out, C)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_cumsum_time_transposed_head_seeded_equals_pallas_exclusive(dtype):
    """The kernel's own exclusive mode (head-seeded) against the JAX
    kernel's, padded as the JAX entry point asks."""
    np_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(5)
    B, C, T = 2, 130, 200
    elems, head = _ints(rng, (B, C, T), np_dt), _ints(rng, (B, C), np_dt)
    ref = np.asarray(jdd.cumsum_time_transposed(
        jnp.asarray(_pad(_pad(elems, 2), 1)), jnp.asarray(_pad(head, 1)),
        interpret=True))[:, :T, :C]
    got = dd.cumsum_time_transposed(torch.from_numpy(elems),
                                    torch.from_numpy(head))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('B,T,C', [(2, 300, 129), (1, 1000, 7)])
def test_cumsum_time_twin_matches_pallas(dtype, B, T, C):
    np_dt, t_dt = DTYPES[dtype]
    rng = np.random.default_rng(T + C)
    d = _ints(rng, (B, T, C), np_dt)
    ref = np.asarray(jdd.cumsum_time(jnp.asarray(d), use_pallas=True))
    got = dd.cumsum_time(torch.from_numpy(d))
    assert got.dtype == t_dt and np.array_equal(got.numpy(), ref)
    # Second pass (time_diff_order 2), as the pipeline chains them.
    ref2 = np.asarray(jdd.cumsum_time(jnp.asarray(ref), use_pallas=True))
    assert np.array_equal(dd.cumsum_time(got).numpy(), ref2)


@pytest.mark.parametrize('dtype', ['uint8', 'int8', 'int16', 'uint16',
                                   'int32', 'uint32'])
def test_zigzag_decode_matches_jax(dtype):
    np_dt = np.dtype(dtype)
    bits = {1: np.uint8, 2: np.int16, 4: np.int32}[np_dt.itemsize]
    info = np.iinfo('uint%d' % (8 * np_dt.itemsize))
    rng = np.random.default_rng(np_dt.itemsize)
    codes = rng.integers(0, info.max, size=4096, endpoint=True,
                         dtype=np.uint64).astype(info.dtype)
    codes[:4] = [0, 1, info.max - 1, info.max]
    ref = np.asarray(jdd.zigzag_decode_jnp(jnp.asarray(codes), np_dt))
    got = dd.zigzag_decode(torch.from_numpy(codes.view(bits)))
    assert np.array_equal(got.numpy().view(np_dt), ref)


@pytest.mark.parametrize('dtype', ['int16', 'int32', 'uint8'])
def test_cumsum_space_matches_jax(dtype):
    np_dt = np.dtype(dtype)
    rng = np.random.default_rng(3)
    d = _ints(rng, (2, 50, 129), np_dt)
    ref = np.asarray(jdd.cumsum_space_jnp(jnp.asarray(d)))
    assert np.array_equal(dd.cumsum_space(torch.from_numpy(d)).numpy(), ref)


def test_scan_entry_points_are_their_twins_on_cpu():
    rng = np.random.default_rng(8)
    e = torch.from_numpy(_ints(rng, (2, 33, 70), np.int16))
    h = torch.from_numpy(_ints(rng, (2, 33), np.int16))
    assert torch.equal(dd.cumsum_time_transposed(e, h, n_samples=71),
                       dd.cumsum_time_transposed_ref(e, h, n_samples=71))
    assert torch.equal(dd.cumsum_time(e), dd.cumsum_time_ref(e))
    # The twins never count as launches.
    assert not any(n for form, n in dd.launches.items()
                   if form.startswith(('scan_transposed', 'cumsum_time')))


@pytest.mark.parametrize('case', ['dtype', 'n_samples_incl', 'n_samples_excl',
                                  'head_dtype', 'head_shape', 'k5_dtype',
                                  'k5_rank'])
def test_scans_reject_bad_inputs(case):
    rng = np.random.default_rng(9)
    e = torch.from_numpy(_ints(rng, (2, 16, 64), np.int16))
    h = torch.from_numpy(_ints(rng, (2, 16), np.int16))
    with pytest.raises(ValueError):
        if case == 'dtype':
            dd.cumsum_time_transposed(e.to(torch.int64))
        elif case == 'n_samples_incl':
            dd.cumsum_time_transposed(e, n_samples=65)
        elif case == 'n_samples_excl':
            dd.cumsum_time_transposed(e, h, n_samples=66)
        elif case == 'head_dtype':
            dd.cumsum_time_transposed(e, h.to(torch.int32))
        elif case == 'head_shape':
            dd.cumsum_time_transposed(e, h[:, :8])
        elif case == 'k5_dtype':
            dd.cumsum_time(e.to(torch.uint8))
        else:
            dd.cumsum_time(e[0])
