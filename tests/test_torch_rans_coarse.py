"""PyTorch port, K1's coarse/fixup form: tables from other writers.

Frequency tables whose boundaries sit off the 8-slot grid (a foreign
writer's unit-granularity min-8 quantizer) have no octet form; K1 then
resolves a slot through a 256-entry coarse table and one or two
compare-increments. The port's plain twin of that form is held, bit for
bit, against the JAX package's Pallas kernel in interpret mode
(``octet=False``) and against the normative coder, with one-fixup and
two-fixup tables.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from mtscomp_tpu.models import rans  # noqa: E402
from mtscomp_tpu.ops import pallas_rans  # noqa: E402

from mtscomp_tpu_torch.ops import rans_decode as rd  # noqa: E402
from mtscomp_tpu_torch.ops import tables  # noqa: E402

R, L = rans.GROUP_ROWS, rans.LANES


def foreign_table(rng, n_sym, min_freq):
    """A normalized table over ``n_sym`` random symbols with every
    frequency >= ``min_freq`` and boundaries at unit granularity."""
    f = np.zeros(256, np.int64)
    sym = rng.choice(256, size=n_sym, replace=False)
    f[sym] = min_freq
    f[sym] += rng.multinomial(rans.SCALE - min_freq * n_sym,
                              rng.dirichlet(np.full(n_sym, 0.3)))
    return f


def occ3_table():
    """The JAX kernel test's table with a 16-slot bucket spanning three
    symbols (dense ids 1..3 in bucket [16, 32))."""
    f = np.zeros(256, np.int64)
    f[0] = 12
    f[1:9] = 8
    f[9] = rans.SCALE - 12 - 8 * 8
    return f


def _groups(rng, n_groups, n_steps, make_table):
    """Normatively encoded groups with ragged row counts: the staged
    arrays and, per group, (rows, words used)."""
    states = np.full((n_groups, R, L), rans.RANS_L, np.uint32)
    words = np.zeros((n_groups, 8192), np.uint16)
    coarse = np.zeros((n_groups, R, 2, L), np.int32)
    dense = np.zeros((n_groups, R, 2, L), np.int32)
    counts = np.zeros((n_groups, R), np.int32)
    needs2, want = False, []
    for n in range(n_groups):
        n_rows = int(rng.integers(1, R + 1))
        rows, freq_rows = [], []
        for ri in range(n_rows):
            f = make_table(rng)
            c = int(rng.integers(1, n_steps * L + 1))
            rows.append(rng.choice(256, size=c, p=f / f.sum()).astype(
                np.uint8))
            freq_rows.append(f)
            cpk, dpk, n2, _o = tables.pack_device_tables(f)
            coarse[n, ri], dense[n, ri] = cpk, dpk
            needs2 = needs2 or n2
            counts[n, ri] = c
        st, w = rans.rans_encode_group(rows, np.stack(freq_rows))
        states[n, :n_rows] = st
        words[n, :w.size] = w
        want.append((rows, w.size))
    return (states, words, coarse, dense, counts), needs2, want


def _port_args(states, words, coarse, dense, counts):
    N = states.shape[0]
    return (torch.from_numpy(states.view(np.int32)),
            torch.from_numpy(words.view(np.int16)),
            torch.from_numpy(coarse.reshape(N, R, 256)),
            torch.from_numpy(dense.reshape(N, R, 256)),
            torch.from_numpy(counts))


TABLES = {
    # Every frequency >= 16: no bucket holds three symbols.
    'one_fixup': lambda rng: foreign_table(rng, int(rng.integers(2, 200)),
                                           16),
    'two_fixups': lambda rng: (occ3_table() if rng.random() < 0.5 else
                               foreign_table(rng, int(rng.integers(100, 250)),
                                             8)),
}


@pytest.mark.parametrize('kind', sorted(TABLES))
def test_decode_groups_coarse_twin_matches_pallas(kind):
    rng = np.random.default_rng(len(kind))
    S = 4
    staged, needs2, want = _groups(rng, 3, S, TABLES[kind])
    assert needs2 == (kind == 'two_fixups')
    one_fixup = not needs2
    syms, used = rd.decode_groups_coarse(*_port_args(*staged), S,
                                         one_fixup=one_fixup)
    states, words, coarse, dense, counts = staged
    WR = -(-words.shape[1] // L) + pallas_rans.WINDOW_ROWS
    wj = np.zeros((words.shape[0], WR * L), np.uint16)
    wj[:, :words.shape[1]] = words
    jsyms, jused = pallas_rans.decode_groups_pallas(
        jnp.asarray(states), jnp.asarray(wj.reshape(-1, WR, L)),
        jnp.asarray(coarse), jnp.asarray(dense),
        jnp.asarray(np.repeat(counts[:, :, None], L, axis=2)), n_steps=S,
        interpret=True, octet=False, one_fixup=one_fixup)
    jsyms = np.asarray(jsyms)[:, :, :S * L]
    live = np.arange(S * L)[None, None, :] < counts[:, :, None]
    assert np.array_equal(syms.numpy()[live], jsyms[live])
    assert np.array_equal(used.numpy(), np.asarray(jused))
    for n, (rows, n_words) in enumerate(want):
        assert used[n] == n_words
        for ri, row in enumerate(rows):
            assert np.array_equal(syms[n, ri, :row.size].numpy(), row)


@pytest.mark.parametrize('seed', range(3))
def test_decode_groups_coarse_twin_matches_normative(seed):
    """Two fixups are exact on any min-8 table; one fixup wherever no
    table needs the second (pack_device_tables' flag)."""
    rng = np.random.default_rng(100 + seed)
    S = 3
    staged, needs2, want = _groups(rng, 2, S, TABLES['two_fixups'])
    for one_fixup in ([False] if needs2 else [False, True]):
        syms, used = rd.decode_groups_coarse_ref(*_port_args(*staged), S,
                                                 one_fixup=one_fixup)
        for n, (rows, n_words) in enumerate(want):
            assert used[n] == n_words
            for ri, row in enumerate(rows):
                assert np.array_equal(syms[n, ri, :row.size].numpy(), row)


def test_coarse_and_octet_forms_agree_on_aligned_tables():
    """On this writer's 8-aligned tables both lookups decode alike."""
    rng = np.random.default_rng(4)
    S = 3

    def aligned(rng):
        hist = rng.integers(0, 50, size=256)
        hist[:2] += 1
        return rans.quantize_freqs(hist).astype(np.int64)

    staged, needs2, _want = _groups(rng, 2, S, aligned)
    states, words, coarse, dense, counts = staged
    octet = np.zeros((states.shape[0], R, L), np.int32)
    for n in range(states.shape[0]):
        for ri in range(R):
            if counts[n, ri]:
                # Recover the row's table from its dense entries.
                d = dense[n, ri].reshape(-1).view(np.uint32).astype(np.int64)
                f = np.zeros(256, np.int64)
                live = d[(d >> 12) & 4095 > 0]
                f[live >> 24] = (live >> 12) & 4095
                octet[n, ri] = tables.pack_device_tables(f)[3]
    args = _port_args(*staged)
    a = rd.decode_groups_coarse(*args, S, one_fixup=not needs2)
    b = rd.decode_groups(args[0], args[1], torch.from_numpy(octet), args[3],
                         args[4], S)
    live = torch.arange(S * L)[None, None, :] < args[4][:, :, None]
    assert torch.equal(a[0][live], b[0][live]) and torch.equal(a[1], b[1])
    assert not any(rd.launches.values())               # twins only


def test_decode_groups_coarse_rejects_octet_tables():
    N = 1
    good = (torch.zeros((N, R, L), dtype=torch.int32),
            torch.zeros((N, L), dtype=torch.int16),
            torch.zeros((N, R, 256), dtype=torch.int32),
            torch.zeros((N, R, 256), dtype=torch.int32),
            torch.zeros((N, R), dtype=torch.int32))
    syms, used = rd.decode_groups_coarse(*good, 1, one_fixup=True)
    assert syms.shape == (N, R, L) and used.tolist() == [0]
    with pytest.raises(ValueError, match='coarse_pk'):
        rd.decode_groups_coarse(good[0], good[1], good[2][:, :, :L],
                                *good[3:], 1, one_fixup=False)
