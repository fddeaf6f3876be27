"""The yardstick pinned: the signals by a hash at a tiny size, the
reference decoder against files the program writes, and its refusal of a
damaged file."""

import hashlib

import numpy as np
import pytest
import torch

import mtscomp_tpu_torch as mt
from portbench.reference import decode, samples_wrong
from portbench.signals import probe_seed, walk


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize('step_std, clip, digest', [
    ((6.0, 6.0), 30000, '45041ec0c7fbcdbe'),
    ((3.0, 40.0), 30000, 'f4494a16a4b88b81'),
    ((3.0, 40.0), 50, '14cc8007998737ab'),
    ((3.0, 40.0), None, 'f4494a16a4b88b81'),
])
def test_signals_are_pinned(step_std, clip, digest):
    a = walk(1000, 7, step_std, clip, 2**31 + 5, torch.device('cpu'))
    assert a.dtype == np.int16 and a.shape == (1000, 7)
    assert clip is None or np.abs(a).max() <= clip
    assert _sha(a) == digest


def test_a_rigs_first_probe_is_the_walk_of_the_seed_and_the_next_pinned():
    cpu = torch.device('cpu')
    seed = 2**31 + 5
    a = walk(1000, 7, (6.0, 6.0), 30000, seed, cpu)
    assert probe_seed(seed, 0) == seed
    assert np.array_equal(walk(1000, 7, (6.0, 6.0), 30000,
                               probe_seed(seed, 0), cpu), a)
    b = walk(1000, 7, (6.0, 6.0), 30000, probe_seed(seed, 1), cpu)
    assert not np.array_equal(a, b)
    assert _sha(b) == '6561148c3452452b'
    seeds = {probe_seed(s, p) for s in (0, 1, seed, 2**40)
             for p in range(1, 7)}
    assert len(seeds) == 24 and all(0 <= s < 1 << 63 for s in seeds)


def test_signals_follow_the_seed_and_the_blocks(monkeypatch):
    cpu = torch.device('cpu')
    a = walk(300, 5, (6.0, 6.0), 30000, 7, cpu)
    assert np.array_equal(a, walk(300, 5, (6.0, 6.0), 30000, 7, cpu))
    assert not np.array_equal(a, walk(300, 5, (6.0, 6.0), 30000, 8, cpu))
    # Unclipped, the sum wraps: its modular diffs are the steps.
    w = walk(200000, 2, (300.0, 300.0), None, 3, cpu)
    wide = walk(200000, 2, (300.0, 300.0), 1 << 30, 3, cpu)
    assert w.min() < -30000 and w.max() > 30000
    assert np.array_equal(np.diff(w, axis=0), np.diff(wide, axis=0))
    # The steps of one chunk have the configured spread.
    d = np.diff(walk(20000, 3, (3.0, 40.0), 1 << 30, 9, cpu).astype(
        np.int64), axis=0)
    assert d[:, 0].std() == pytest.approx(3.0, rel=0.05)
    assert d[:, -1].std() == pytest.approx(40.0, rel=0.05)


LAYOUTS = [
    ('int16', 40, {}),
    ('int16', 33, {'time_diff_order': 2}),
    ('int16', 24, {'do_spatial_diff': True}),
    ('int32', 9, {'chunk_order': 'C'}),
    ('uint16', 64, {'ans_table_mode': 'plane'}),
    ('int16', 16, {'transform_adapt': 2}),
    ('int64', 5, {}),
]


@pytest.mark.parametrize('dtype, n_channels, opts', LAYOUTS)
@pytest.mark.parametrize('device', ['none', 'cpu'])
def test_the_reference_decodes_what_the_program_writes(
        tmp_path, dtype, n_channels, opts, device):
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    a = np.cumsum(rng.normal(0, 40, (2 * 1500 + 77, n_channels)), axis=0)
    a = np.clip(a + (info.max // 4 if info.min == 0 else 0),
                info.min, info.max).astype(dtype)
    a.tofile(tmp_path / 'a.bin')
    opts = dict({'time_diff_order': 1, 'do_spatial_diff': False}, **opts)
    mt.compress(tmp_path / 'a.bin', tmp_path / 'a.cbin', tmp_path / 'a.ch',
                sample_rate=1500.0, n_channels=n_channels, dtype=dtype,
                algorithm='ans', quiet=True, check_after_compress=False,
                device=device, n_threads=2, **opts)
    got = decode.decode_file(tmp_path / 'a.cbin', tmp_path / 'a.ch')
    out = np.concatenate([got[i] for i in sorted(got)])
    assert samples_wrong(out, a) == 0
    assert _sha(out) == _sha(a)


def test_the_reference_refuses_a_damaged_file(tmp_path):
    a = walk(3000, 12, (6.0, 6.0), 30000, 1, torch.device('cpu'))
    a.tofile(tmp_path / 'a.bin')
    mt.compress(tmp_path / 'a.bin', tmp_path / 'a.cbin', tmp_path / 'a.ch',
                sample_rate=1000.0, n_channels=12, dtype='int16',
                algorithm='ans', quiet=True, check_after_compress=False,
                device='none')
    raw = bytearray((tmp_path / 'a.cbin').read_bytes())
    raw[len(raw) // 2] ^= 0x10
    (tmp_path / 'a.cbin').write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        decode.decode_file(tmp_path / 'a.cbin', tmp_path / 'a.ch')


def test_samples_wrong():
    a = np.arange(12, dtype=np.int16).reshape(4, 3)
    b = a.copy()
    b[1, 2] += 1
    assert samples_wrong(a, a) == 0 and samples_wrong(b, a) == 1
    assert samples_wrong(a[:2], a) == 12 and samples_wrong(None, a) == 12
    assert samples_wrong(a.astype(np.int32), a) == 12
