"""PyTorch port, K2 + K3: the fused finalize of the fuse8 decode.

The port's plain twins (what ``cumsum_time_transposed_u8`` and its
``_tail`` form run for CPU tensors) are held, exactly, against the JAX
package's Pallas kernels in interpret mode on seeded random low-byte
planes, heads and high bytes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from mtscomp_tpu.ops import device_delta as jdd  # noqa: E402

from mtscomp_tpu_torch.ops import device_delta as dd  # noqa: E402


def _inputs(seed, B, C, T):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256, size=(B, C, T), dtype=np.uint8)
    head = rng.integers(-2 ** 15, 2 ** 15, size=(B, C), dtype=np.int16)
    hi = rng.integers(0, 256, size=B).astype(np.int32)
    hi[0] = 255                      # the extreme high bytes
    hi[-1] = 0
    return planes, head, hi


@pytest.mark.parametrize('seed,B,C,T', [(0, 2, 256, 256), (1, 1, 128, 384),
                                        (2, 3, 384, 128)])
def test_finalize_u8_twin_matches_pallas(seed, B, C, T):
    planes, head, hi = _inputs(seed, B, C, T)
    ref = np.asarray(jdd.cumsum_time_transposed_u8(
        jnp.asarray(planes), jnp.asarray(head), jnp.asarray(hi),
        interpret=True))
    got = dd.cumsum_time_transposed_u8(
        torch.from_numpy(planes), torch.from_numpy(head),
        torch.from_numpy(hi))
    assert got.dtype == torch.int16 and tuple(got.shape) == (B, T, C)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize('seed,B,CA,CB,T', [(0, 2, 128, 8, 256),
                                            (1, 3, 256, 16, 128),
                                            (2, 1, 128, 8, 384)])
def test_finalize_u8_tail_twin_matches_pallas(seed, B, CA, CB, T):
    planes, head, hi = _inputs(seed, B, CA + CB, T)
    ref = np.asarray(jdd.cumsum_time_transposed_u8_tail(
        jnp.asarray(planes[:, :CA]), jnp.asarray(planes[:, CA:]),
        jnp.asarray(head[:, :CA]), jnp.asarray(head[:, CA:]),
        jnp.asarray(hi), interpret=True))
    p, h = torch.from_numpy(planes), torch.from_numpy(head)
    got = dd.cumsum_time_transposed_u8_tail(
        p[:, :CA], p[:, CA:], h[:, :CA], h[:, CA:], torch.from_numpy(hi))
    assert tuple(got.shape) == (B, T, CA + CB)
    # The Pallas output pads the channels to a 128 multiple.
    assert np.array_equal(got.numpy(), ref[:, :, :CA + CB])


@pytest.mark.parametrize('tail', [False, True])
def test_finalize_u8_trims_like_the_pipeline(tail):
    """Heads narrower than the planes and ``n_samples`` below the plane
    length give the JAX result after the pipeline's ``[:, :T, :C]``
    trim (the port writes that shape directly)."""
    B, T, n = 2, 256, 251
    planes, head, hi = _inputs(5, B, 136, T)
    if tail:
        C, CA = 129, 128
        ref = jdd.cumsum_time_transposed_u8_tail(
            jnp.asarray(planes[:, :CA]), jnp.asarray(planes[:, CA:]),
            jnp.asarray(head[:, :CA]), jnp.asarray(head[:, CA:]),
            jnp.asarray(hi), interpret=True)
        p = torch.from_numpy(planes)
        got = dd.cumsum_time_transposed_u8_tail(
            p[:, :CA], p[:, CA:], torch.from_numpy(head[:, :CA]),
            torch.from_numpy(head[:, CA:C]), torch.from_numpy(hi),
            n_samples=n)
    else:
        C = 100
        ref = jdd.cumsum_time_transposed_u8(
            jnp.asarray(planes[:, :128]), jnp.asarray(head[:, :128]),
            jnp.asarray(hi), interpret=True)
        got = dd.cumsum_time_transposed_u8(
            torch.from_numpy(planes[:, :128]),
            torch.from_numpy(head[:, :C]), torch.from_numpy(hi),
            n_samples=n)
    assert np.array_equal(got.numpy(), np.asarray(ref)[:, :n, :C])


def test_finalize_u8_entry_points_are_their_twins_on_cpu():
    planes, head, hi = _inputs(7, 2, 40, 128)
    p, h, x = (torch.from_numpy(a) for a in (planes, head, hi))
    assert torch.equal(dd.cumsum_time_transposed_u8(p, h, x, n_samples=129),
                       dd.cumsum_time_transposed_u8_ref(p, h, x,
                                                        n_samples=129))
    assert torch.equal(
        dd.cumsum_time_transposed_u8_tail(p[:, :32], p[:, 32:], h[:, :32],
                                          h[:, 32:33], x),
        dd.cumsum_time_transposed_u8_tail_ref(p[:, :32], p[:, 32:],
                                              h[:, :32], h[:, 32:33], x))
    # The twins never count as launches.
    assert dd.launches['finalize_u8'] == dd.launches['finalize_u8_tail'] == 0


@pytest.mark.parametrize('case', ['n_samples', 'head_dtype', 'head_width',
                                  'tail_length', 'hi_shape'])
def test_finalize_u8_rejects_bad_inputs(case):
    planes, head, hi = _inputs(9, 2, 16, 64)
    p, h, x = (torch.from_numpy(a) for a in (planes, head, hi))
    with pytest.raises(ValueError):
        if case == 'n_samples':
            dd.cumsum_time_transposed_u8(p, h, x, n_samples=66)
        elif case == 'head_dtype':
            dd.cumsum_time_transposed_u8(p, h.to(torch.int32), x)
        elif case == 'head_width':
            dd.cumsum_time_transposed_u8(p, torch.zeros((2, 17),
                                                        dtype=torch.int16), x)
        elif case == 'tail_length':
            dd.cumsum_time_transposed_u8_tail(p[:, :8], p[:, 8:, :32],
                                              h[:, :8], h[:, 8:], x)
        else:
            dd.cumsum_time_transposed_u8(p, h, x[:1])
