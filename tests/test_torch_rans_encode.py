"""PyTorch port, K6: the grouped rANS encode.

The port's plain twin (what ``encode_groups`` runs for CPU tensors) is
held, bit for bit, against the normative coder
(``models/rans.py::rans_encode_group``, the JAX package's) and against
the JAX package's Pallas kernel in interpret mode: the same decoder
start states, the same merged word stream, the same word count. The
groups have ragged row counts, rows with count 0, full 256-symbol
alphabets and tables at the minimum frequency; an empty group and a
too-small region are covered too.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from mtscomp_tpu.models import rans  # noqa: E402
from mtscomp_tpu.ops.pallas_rans_enc import (  # noqa: E402
    encode_groups_pallas, pack_enc_device_tables)

from mtscomp_tpu_torch.ops import rans_encode as renc  # noqa: E402

from mtscomp_tpu_torch.ops.rans_decode import decode_groups  # noqa: E402

from chip_smoke import (  # noqa: E402
    EDGE_CASES, REGION_ENDS, edge_groups, edge_k1_inputs, edge_k6_inputs)

R, L = rans.GROUP_ROWS, rans.LANES


def _min_freq_table(rng):
    """A table whose every present symbol but one sits at the minimum
    frequency (8): 200 rare symbols and one that takes the rest."""
    c = np.zeros(256, np.int64)
    c[rng.choice(256, size=201, replace=False)] = 1
    c[int(np.flatnonzero(c)[0])] = 10 ** 6
    f = rans.quantize_freqs(c)
    assert (f[f > 0] == rans.MIN_FREQ).sum() == 200
    return f


def _groups(kind, seed, N=3, S=6):
    """(symbols (N, 32, S*128) u8, freqs (N, 32, 256), counts (N, 32)):
    each live row's symbols drawn from its own table."""
    rng = np.random.default_rng(seed)
    syms = np.zeros((N, R, S * L), np.uint8)
    freqs = np.zeros((N, R, 256), np.int64)
    freqs[:, :, :2] = rans.SCALE // 2
    counts = rng.integers(0, S * L + 1, size=(N, R)).astype(np.int32)
    counts[:, rng.integers(0, R, size=4)] = 0          # rows with count 0
    counts[0, 0] = S * L                               # one full row
    if kind == 'empty':
        counts[:] = 0
    for n in range(N):
        for r in range(R):
            if kind == 'full_alphabet':
                f = rans.quantize_freqs(np.full(256, 16))
            elif kind == 'min_freq':
                f = _min_freq_table(rng)
            else:
                c = np.zeros(256, np.int64)
                k = int(rng.integers(2, 40))
                c[rng.choice(256, size=k, replace=False)] = rng.geometric(
                    0.05, size=k)
                f = rans.quantize_freqs(c)
            freqs[n, r] = f
            syms[n, r, :counts[n, r]] = rng.choice(
                256, size=counts[n, r], p=f / f.sum())
    return syms, freqs, counts


def _twin(syms, freqs, counts, cap=None):
    pk, rcp = renc.pack_encoder_tables(freqs)
    cap = renc.symbol_capacity(counts) if cap is None else cap
    return renc.encode_groups(torch.from_numpy(syms), torch.from_numpy(pk),
                              torch.from_numpy(rcp),
                              torch.from_numpy(counts), cap), cap


KINDS = ['ragged', 'full_alphabet', 'min_freq', 'empty']


@pytest.mark.parametrize('kind', KINDS)
def test_twin_matches_the_normative_encoder(kind):
    syms, freqs, counts = _groups(kind, KINDS.index(kind))
    (states, words, n_words), cap = _twin(syms, freqs, counts)
    assert states.dtype == torch.int32 and tuple(states.shape) == (3, R, L)
    assert words.dtype == torch.int16 and tuple(words.shape) == (3, cap)
    flat, nw = renc.left_align(words, n_words)
    off = np.concatenate([[0], np.cumsum(nw)])
    for n in range(syms.shape[0]):
        rows = [syms[n, r, :counts[n, r]] for r in range(R)]
        st, w = rans.rans_encode_group(rows, freqs[n])
        assert np.array_equal(states[n].numpy().view(np.uint32), st)
        assert nw[n] == w.size <= counts[n].sum()
        assert np.array_equal(flat[off[n]:off[n + 1]], w)
        assert np.array_equal(words[n, cap - nw[n]:].numpy().view(np.uint16),
                              w)
        assert not words[n, :cap - nw[n]].any()   # the twin zeroes the rest
    if kind == 'empty':
        assert not nw.any() and flat.size == 0
        assert (states.numpy().view(np.uint32) == rans.RANS_L).all()


@pytest.mark.parametrize('kind', ['ragged', 'full_alphabet', 'min_freq'])
def test_twin_matches_the_pallas_kernel(kind, monkeypatch):
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    syms, freqs, counts = _groups(kind, 10 + KINDS.index(kind), N=2, S=4)
    (states, words, n_words), cap = _twin(syms, freqs, counts)
    pk = np.zeros((2, R, 2, L), np.int32)
    rcp = np.zeros_like(pk)
    for n in range(2):
        for r in range(R):
            pk[n, r], rcp[n, r] = pack_enc_device_tables(freqs[n, r],
                                                         div='mulhi')
    cap_rows = 512
    cb = np.ascontiguousarray(np.broadcast_to(counts[:, :, None],
                                              (2, R, L)))
    j_states, j_words, j_nw = encode_groups_pallas(
        jnp.asarray(syms), jnp.asarray(pk), jnp.asarray(rcp),
        jnp.asarray(cb), n_steps=4, cap_rows=cap_rows, div='mulhi')
    j_nw = np.asarray(j_nw)[:, 0, 0]
    assert np.array_equal(n_words.numpy(), j_nw)
    assert np.array_equal(states.numpy(), np.asarray(j_states))
    capw = cap_rows * L
    for n in range(2):
        want = np.asarray(j_words[n]).reshape(-1)[capw - j_nw[n]:capw]
        got = words[n, cap - j_nw[n]:].numpy().view(np.uint16)
        assert np.array_equal(got, want)


def test_words_never_leave_the_region():
    """A region smaller than the stream (a caller's fault) loses words
    instead of writing outside it, and the wrapper raises."""
    syms, freqs, counts = _groups('full_alphabet', 5, N=1, S=2)
    pk, rcp = renc.pack_encoder_tables(freqs)
    args = tuple(torch.from_numpy(a) for a in (syms, pk, rcp, counts))
    states, words, n_words = renc.encode_groups_ref(*args, cap=64)
    assert int(n_words[0]) > 64 and tuple(words.shape) == (1, 64)
    with pytest.raises(RuntimeError, match='region'):
        renc.encode_groups(*args, cap=64)


def test_encode_groups_checks_its_inputs():
    syms, freqs, counts = _groups('ragged', 6, N=1, S=2)
    pk, rcp = renc.pack_encoder_tables(freqs)
    t = [torch.from_numpy(a) for a in (syms, pk, rcp, counts)]
    with pytest.raises(ValueError, match='symbols'):
        renc.encode_groups(t[0][:, :, :100], *t[1:], cap=10)
    with pytest.raises(ValueError, match='counts'):
        renc.encode_groups(*t[:3], t[3].long(), cap=10)
    with pytest.raises(ValueError, match='cap'):
        renc.encode_groups(*t, cap=0)
    assert renc.launches['rans_encode'] == 0     # twins never count


@pytest.mark.parametrize('region_end', REGION_ENDS)
@pytest.mark.parametrize('case', sorted(EDGE_CASES))
def test_twin_edge_cases(case, region_end):
    """The twin K6 is held to on the card, on the inputs its windowed
    design makes risky: 1 step and step counts around its 16-step
    window, steps emitting close to 4096 words, rows of count 0 and
    ragged counts, a region that the largest stream fills exactly or
    that ends off the 8-word grid; against the normative encoder."""
    rows, freqs, counts, steps = edge_groups(case)
    want = [rans.rans_encode_group(g, freqs[n]) for n, g in enumerate(rows)]
    args, cap = edge_k6_inputs(rows, freqs, counts, steps,
                               [w.size for _st, w in want], region_end)
    assert args[0].shape[2] == steps * L
    states, words, n_words = renc.encode_groups(*args, cap=cap)
    assert n_words.tolist() == [w.size for _st, w in want]
    if region_end == 'exact':
        # (A one-step group emits no word: its region is one word.)
        assert max(n_words.tolist()) == cap or not n_words.any()
    else:
        assert cap % 8
    for n, (st, w) in enumerate(want):
        assert np.array_equal(states[n].numpy().view(np.uint32), st)
        assert np.array_equal(
            words[n, cap - w.size:].numpy().view(np.uint16), w)
        assert not words[n, :cap - w.size].any()


@pytest.mark.parametrize('case', sorted(EDGE_CASES))
def test_twins_round_trip_edge_cases(case):
    """K6's twin encodes each edge case and K1's twin decodes the streams
    it wrote back to the source rows, reading every word."""
    rows, freqs, counts, steps = edge_groups(case)
    n_words = [rans.rans_encode_group(g, freqs[n])[1].size
               for n, g in enumerate(rows)]
    args, cap = edge_k6_inputs(rows, freqs, counts, steps, n_words, 'exact')
    states, words, got_words = renc.encode_groups(*args, cap=cap)
    streams = [(states[n].numpy().view(np.uint32),
                words[n, cap - nw:].numpy().view(np.uint16))
               for n, nw in enumerate(got_words.tolist())]
    k1 = edge_k1_inputs(rows, freqs, counts, streams, 'exact')
    syms, used = decode_groups(k1[0], k1[1], k1[2], k1[4], k1[5], steps)
    assert used.tolist() == got_words.tolist() == n_words
    for n, group in enumerate(rows):
        for r, row in enumerate(group):
            assert np.array_equal(syms[n, r, :row.size].numpy(), row)
