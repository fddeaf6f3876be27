"""PyTorch port: the entry points (``mtscomp_tpu_torch/entry.py``),
the port's counterpart of ``__graft_entry__.py``, on the CPU twins.

The example groups equal the JAX entry's for the same seeds; the decode
step (K1 -> combine -> inverse zigzag -> K5) gives the jitted JAX step's
output exactly (int16, tolerance 0); the multi-device dry run passes over
``['cpu'] * n`` (the twins standing for cards) and raises on a flipped
stream word.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from mtscomp_tpu_torch import entry  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def jax_entry():
    spec = importlib.util.spec_from_file_location(
        'graft_entry', REPO / '__graft_entry__.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('seed', (0, 1))
def test_example_groups_equal_the_jax_entry(jax_entry, seed):
    got = entry._example_groups(seed=seed)
    want = jax_entry._example_groups(seed=seed)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
        else:
            assert a == b


def test_entry_equals_the_jitted_jax_step(jax_entry):
    fn, args = entry.entry(device='cpu')
    out = fn(*args)
    jfn, jargs = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert out.dtype == torch.int16 and want.dtype == np.int16
    assert out.shape == want.shape == (2, 128, 128)
    assert np.array_equal(out.numpy(), want)
    # Staged as the pipeline stages a group: word rows of 128 lanes, as
    # many as the longest stream fills (the JAX entry adds no rows).
    states, words, octet, dense, counts = args
    assert all(t.device.type == 'cpu' for t in args)
    rows = words.shape[1] // 128
    assert words.shape[1] % 128 == 0
    assert rows == -(-jargs[1].shape[1] // 128)
    assert np.array_equal(words.numpy()[:, :jargs[1].shape[1]].view(
        np.uint16), np.asarray(jargs[1]))
    assert not words.numpy()[:, jargs[1].shape[1]:].any()
    assert octet.shape == (2, 32, 128) and dense.shape == (2, 32, 256)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA GPU'):
        entry.entry()
    with pytest.raises(ValueError, match='only 0 devices'):
        entry.dryrun_multichip(1)


@pytest.mark.parametrize('n', (1, 2, 3, 4))
def test_dryrun_passes_on_the_twins(n):
    assert entry.dryrun_multichip(n, devices=['cpu'] * n) != 0


@pytest.mark.parametrize('n,grid', [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)),
                                    (4, (2, 2)), (8, (4, 2))])
def test_dryrun_factorises_as_the_jax_mesh(n, grid):
    mesh, dp, mp = entry._mesh_grid(n, ['cpu'] * n)
    assert (dp, mp) == grid and len(mesh) == n


def test_dryrun_refuses_a_mesh_of_another_width():
    with pytest.raises(ValueError, match='over 2 devices'):
        entry.dryrun_multichip(2, devices=['cpu'] * 3)


@pytest.mark.parametrize('shard', (0, 1))
def test_a_flipped_stream_word_makes_the_dryrun_raise(monkeypatch, shard):
    real = entry._stage
    calls = []

    def flip(states, words, freq_rows, counts, device):
        calls.append(None)
        if len(calls) - 1 == shard:
            words = words.copy()
            words[0, 3] ^= 0x0100
        return real(states, words, freq_rows, counts, device)

    monkeypatch.setattr(entry, '_stage', flip)
    with pytest.raises(RuntimeError, match='entropy decode wrong on device'):
        entry.dryrun_multichip(4, devices=['cpu'] * 4)
    assert len(calls) == 4
