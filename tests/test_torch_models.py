"""PyTorch port: ``mtscomp_tpu_torch.models`` exports what
``mtscomp_tpu.models`` exports, and the two table helpers the port had
left out (``slot_to_symbol_table``, ``coarse_table``) equal the JAX
package's on self-written and foreign tables.
"""

import numpy as np
import pytest

import mtscomp_tpu.models as jmodels
import mtscomp_tpu_torch.models as tmodels
from mtscomp_tpu_torch.storm import quantize_foreign

EXPORTS = sorted(n for n in dir(jmodels) if not n.startswith('_')
                 and n != 'rans')


@pytest.mark.parametrize('name', EXPORTS)
def test_the_port_exports_every_name(name):
    assert hasattr(tmodels, name)


def _tables():
    rng = np.random.default_rng(11)
    out = []
    for seed in range(4):
        counts = np.zeros(256, np.int64)
        present = np.random.default_rng(seed).choice(
            256, size=int(rng.integers(2, 256)), replace=False)
        counts[present] = rng.integers(1, 20000, size=present.size)
        out.append(('self_written_%d' % seed, tmodels.quantize_freqs(counts)))
        out.append(('foreign_%d' % seed, quantize_foreign(counts)))
    uniform = np.full(256, 16, np.uint16)
    two = np.zeros(256, np.uint16)
    two[[0, 255]] = 2048
    return out + [('uniform', uniform), ('two_symbols', two)]


TABLES = _tables()


@pytest.mark.parametrize('name,freqs', TABLES, ids=[n for n, _ in TABLES])
def test_table_helpers_equal_the_jax_package(name, freqs):
    assert freqs.sum() == tmodels.SCALE
    got = tmodels.slot_to_symbol_table(freqs)
    want = jmodels.slot_to_symbol_table(freqs)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == (tmodels.SCALE,) and np.array_equal(got, want)
    got = tmodels.coarse_table(freqs)
    want = jmodels.coarse_table(freqs)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (256,)
    # The coarse entry is the symbol at slot 16*b.
    cum = np.cumsum(np.asarray(freqs, np.int64))
    assert np.array_equal(got, np.searchsorted(cum, 16 * np.arange(256),
                                               side='right'))
