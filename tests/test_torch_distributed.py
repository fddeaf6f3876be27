"""PyTorch port: chunk-range compression and part merging
(``parallel/distributed.py``).

The JAX package's ``tests/test_distributed.py`` run against the port's
own copy, then the two packages against each other: parts written by
one package merge under the other into the same bytes, and the spawned
workers keep to the host codec unless the caller names a device (the
port's default is ``'cuda'``).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
import mtscomp_tpu.config as ref_config  # noqa: E402
import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
from mtscomp_tpu_torch import compress, decompress  # noqa: E402
from mtscomp_tpu_torch.parallel.distributed import (  # noqa: E402
    compress_range, compress_multihost, merge_parts, plan_ranges)
from conftest import make_signal, to_int16, write_arr  # noqa: E402


@pytest.fixture
def tmp_path_(tmp_path, monkeypatch):
    """A directory that holds both packages' user config files; the
    port's names the host codec as its default device (no GPU here:
    tests that want the kernels' twins pass ``device='cpu'``)."""
    monkeypatch.setattr(ref_config, 'CONFIG_PATH', tmp_path / '.mtscomp')
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp_torch')
    mt_config.CONFIG_PATH.write_text(json.dumps({'device': 'none'}))
    monkeypatch.setenv('MTSCOMP_PALLAS_INTERPRET', '1')
    return tmp_path


SR = 2000.0
NC = 13


def _make(tmp_path_, ns=5 * 2000 + 700):
    arr = to_int16(make_signal('colored', ns=ns, nc=NC))
    return arr, write_arr(tmp_path_ / 'raw.bin', arr)


def test_plan_ranges():
    assert plan_ranges(10, 3) == [(0, 3), (3, 7), (7, 10)]
    assert plan_ranges(2, 5) == [(0, 1), (1, 2)]
    assert plan_ranges(7, 1) == [(0, 7)]


@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
def test_part_is_standalone(tmp_path_, algorithm):
    """A ranged write is itself a fully valid compressed file."""
    arr, raw = _make(tmp_path_)
    compress_range(raw, tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', 2, 4,
                   sample_rate=SR, n_channels=NC, dtype='int16',
                   algorithm=algorithm, quiet=True)
    meta = json.loads((tmp_path_ / 'p.ch').read_text())
    assert meta['part'] == [2, 4]
    assert meta['chunk_bounds'][0] == 0
    r = decompress(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr[2 * 2000:4 * 2000])
    finally:
        r.close()


@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
def test_merge_matches_full_compress(tmp_path_, algorithm):
    """Range-compress + merge is byte-identical to one full compress."""
    arr, raw = _make(tmp_path_)
    compress(raw, tmp_path_ / 'full.cbin', tmp_path_ / 'full.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm=algorithm, quiet=True)
    full_meta = json.loads((tmp_path_ / 'full.ch').read_text())
    n_chunks = len(full_meta['chunk_bounds']) - 1
    parts = []
    for first, last in plan_ranges(n_chunks, 3):
        cbin = tmp_path_ / ('p%d.cbin' % first)
        ch = tmp_path_ / ('p%d.ch' % first)
        compress_range(raw, cbin, ch, first, last, sample_rate=SR,
                       n_channels=NC, dtype='int16', algorithm=algorithm,
                       quiet=True)
        parts.append((cbin, ch))
    merged = merge_parts(parts, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                         expected_n_chunks=n_chunks)
    assert (tmp_path_ / 'm.cbin').read_bytes() == \
        (tmp_path_ / 'full.cbin').read_bytes()
    assert merged['chunk_bounds'] == full_meta['chunk_bounds']
    assert merged['chunk_offsets'] == full_meta['chunk_offsets']
    assert merged['sha1_compressed'] == full_meta['sha1_compressed']
    # The merge decodes each part, so the merged sidecar carries a REAL
    # decoded hash — identical to what the one-shot compress recorded
    # (mtsverify --deep can audit merged files end to end).
    assert merged['sha1_uncompressed'] == full_meta['sha1_uncompressed']
    assert merged['sha1_uncompressed'] is not None
    assert 'part' not in merged
    r = decompress(tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_merge_rejects_bad_parts(tmp_path_):
    arr, raw = _make(tmp_path_, ns=3 * 2000)
    a = (tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch')
    b = (tmp_path_ / 'b.cbin', tmp_path_ / 'b.ch')
    compress_range(raw, *a, 0, 2, sample_rate=SR, n_channels=NC,
                   dtype='int16', quiet=True)
    compress_range(raw, *b, 2, 3, sample_rate=SR, n_channels=NC,
                   dtype='int16', quiet=True)
    # Gap: skipping part a.
    with pytest.raises(ValueError):
        merge_parts([b], tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch')
    # Missing tail: contiguous from 0 but incomplete coverage (the
    # part_of field written by ranged writes catches it).
    with pytest.raises(ValueError):
        merge_parts([a], tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch')
    # A failed merge must not leave a partial output file behind.
    assert not (tmp_path_ / 'm.cbin').exists()
    # Corrupt part bytes fail the per-part SHA1 during the copy.
    data = bytearray(a[0].read_bytes())
    data[len(data) // 2] ^= 0xFF
    a[0].write_bytes(bytes(data))
    with pytest.raises(IOError):
        merge_parts([a, b], tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch')


def test_merge_rejects_decode_identity_mismatch(tmp_path_):
    """Round-3 silent-corruption regression: parts written with
    different v2 sidecar extensions (time_diff_order, float_bitcast)
    are individually valid and pass every byte-level check, but one
    merged sidecar cannot describe both — merging silently corrupted
    the mismatched chunks. The decode-identity guard must refuse."""
    import json as _json
    rng = np.random.RandomState(0)
    t = np.arange(4 * 2000) / SR
    arr = (np.sin(2 * np.pi * 3.0 * t)[:, None] * 9000.
           + rng.normal(0, 20., (4 * 2000, NC))).astype(np.int16)
    h1 = write_arr(tmp_path_ / 'h1.bin', arr[:2 * 2000])
    h2 = write_arr(tmp_path_ / 'h2.bin', arr[2 * 2000:])
    a = (tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch')
    b = (tmp_path_ / 'b.cbin', tmp_path_ / 'b.ch')
    # Mixed prediction orders (explicit configs — or 'auto' resolving
    # differently across parts of one session, the shipped default).
    compress(h1, *a, sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', time_diff_order=1, quiet=True)
    compress(h2, *b, sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', time_diff_order=2, quiet=True)
    assert _json.loads(b[1].read_text())['time_diff_order'] == 2
    with pytest.raises(ValueError, match='time_diff_order'):
        merge_parts([a, b], tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                    expected_n_chunks=4)
    assert not (tmp_path_ / 'm.cbin').exists()
    # Mixed float domains: a bitcast part and a legacy-domain float
    # part (absent key) must not merge either.
    f = arr.astype(np.float32)
    f1 = write_arr(tmp_path_ / 'f1.bin', f[:2 * 2000])
    f2 = write_arr(tmp_path_ / 'f2.bin', f[2 * 2000:])
    fa = (tmp_path_ / 'fa.cbin', tmp_path_ / 'fa.ch')
    fb = (tmp_path_ / 'fb.cbin', tmp_path_ / 'fb.ch')
    for src, dst in ((f1, fa), (f2, fb)):
        compress(src, *dst, sample_rate=SR, n_channels=NC,
                 dtype='float32', algorithm='ans', time_diff_order=1,
                 quiet=True)
    meta = _json.loads(fb[1].read_text())
    assert meta.pop('float_bitcast') is True
    fb[1].write_text(_json.dumps(meta))
    with pytest.raises(ValueError, match='float_bitcast'):
        merge_parts([fa, fb], tmp_path_ / 'fm.cbin', tmp_path_ / 'fm.ch',
                    expected_n_chunks=4)


def test_merge_decoded_hash_and_fast_flag(tmp_path_):
    """The decode pass cross-checks each part's own sha1_uncompressed
    (catching a part whose sidecar does not describe its payload), and
    mtsmerge --fast skips it (sha1_uncompressed: null, chop-style)."""
    import hashlib as _hashlib
    import json as _json
    from mtscomp_tpu_torch.cli import mtsmerge
    from mtscomp_tpu_torch.verify import verify_file
    arr, raw = _make(tmp_path_, ns=4 * 2000)
    parts = []
    for first, last in plan_ranges(4, 2):
        cbin = tmp_path_ / ('p%d.cbin' % first)
        ch = tmp_path_ / ('p%d.ch' % first)
        compress_range(raw, cbin, ch, first, last, sample_rate=SR,
                       n_channels=NC, dtype='int16', algorithm='ans',
                       quiet=True)
        parts.append((cbin, ch))
    merged = merge_parts(parts, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch')
    assert merged['sha1_uncompressed'] == \
        _hashlib.sha1(arr.tobytes()).hexdigest()
    # mtsverify --deep fully audits the merged file now.
    report = verify_file(tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                         deep=True, quiet=True)
    assert report['ok'] and report['checks']['sha1_uncompressed'] == 'ok'
    # A part whose sidecar misdescribes its payload (the corruption
    # vector if the identity guard were ever bypassed): the decode
    # cross-check fails the merge even though all byte hashes pass.
    bad_meta = _json.loads(parts[0][1].read_text())
    bad_meta['sha1_uncompressed'] = '0' * 40
    parts[0][1].write_text(_json.dumps(bad_meta))
    with pytest.raises(IOError, match='sha1_uncompressed'):
        merge_parts(parts, tmp_path_ / 'm2.cbin', tmp_path_ / 'm2.ch')
    # --fast: byte-verified only, hash-less sidecar (still merges).
    mtsmerge([str(parts[0][0]), str(parts[1][0]), '--fast',
              '-o', str(tmp_path_ / 'm3.cbin'),
              '-m', str(tmp_path_ / 'm3.ch')])
    assert _json.loads(
        (tmp_path_ / 'm3.ch').read_text())['sha1_uncompressed'] is None
    r = decompress(tmp_path_ / 'm3.cbin', tmp_path_ / 'm3.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_multihost_resumable(tmp_path_):
    """compress_multihost reuses valid existing parts (crash resume)."""
    arr, raw = _make(tmp_path_)
    pdir = tmp_path_ / 'parts'
    meta = compress_multihost(raw, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                              n_parts=3, part_dir=pdir, sample_rate=SR,
                              n_channels=NC, dtype='int16', quiet=True)
    n_chunks = len(meta['chunk_bounds']) - 1
    # Simulate a crash that lost one part; rerun must redo only it.
    victims = sorted(pdir.glob('part_*.cbin'))
    victims[1].unlink()
    mtimes = {p: p.stat().st_mtime_ns for p in sorted(pdir.glob('*.cbin'))}
    meta2 = compress_multihost(raw, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                               n_parts=3, part_dir=pdir, sample_rate=SR,
                               n_channels=NC, dtype='int16', quiet=True)
    assert len(meta2['chunk_bounds']) - 1 == n_chunks
    for p, t in mtimes.items():
        assert p.stat().st_mtime_ns == t, "untouched part was rewritten"
    r = decompress(tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_multihost_process_parallel(tmp_path_, monkeypatch):
    """n_workers > 1 runs ranges in spawned OS processes — the real
    multi-host execution model (isolated interpreters sharing only the
    filesystem) — and the merged output is byte-identical to a serial
    full compress."""
    # Hermetic ~/.mtscomp for the spawned workers (they don't inherit
    # the in-process CONFIG_PATH monkeypatch, only the environment).
    monkeypatch.setenv('HOME', str(tmp_path_))
    arr, raw = _make(tmp_path_)
    compress(raw, tmp_path_ / 'full.cbin', tmp_path_ / 'full.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True)
    meta = compress_multihost(raw, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                              n_parts=3, n_workers=2,
                              part_dir=tmp_path_ / 'parts', sample_rate=SR,
                              n_channels=NC, dtype='int16',
                              algorithm='ans', quiet=True)
    assert (tmp_path_ / 'm.cbin').read_bytes() == \
        (tmp_path_ / 'full.cbin').read_bytes()
    assert len(list((tmp_path_ / 'parts').glob('part_*.cbin'))) == 3
    full_meta = json.loads((tmp_path_ / 'full.ch').read_text())
    assert meta['sha1_compressed'] == full_meta['sha1_compressed']
    r = decompress(tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_rank_based_cluster_flow(tmp_path_):
    """Each 'host' runs the same command with its own --rank; one host
    merges. No coordination beyond shared storage."""
    from mtscomp_tpu_torch.cli import mtscomp as cli_compress
    from mtscomp_tpu_torch.cli import mtsmerge as cli_merge
    arr, raw = _make(tmp_path_)
    compress(raw, tmp_path_ / 'full.cbin', tmp_path_ / 'full.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True)
    for rank in (2, 0, 1):                      # any completion order
        cli_compress([str(raw), str(tmp_path_ / 'm.cbin'),
                      str(tmp_path_ / 'm.ch'), '-d', 'int16', '-s',
                      str(SR), '-n', str(NC), '-a', 'ans', '-nc',
                      '--parts', '3', '--rank', str(rank)])
    # Rerunning a finished rank reuses its valid part (crash resume).
    parts = sorted(tmp_path_.glob('part_*.cbin'))
    assert len(parts) == 3
    mtime = parts[0].stat().st_mtime_ns
    cli_compress([str(raw), str(tmp_path_ / 'm.cbin'),
                  str(tmp_path_ / 'm.ch'), '-d', 'int16', '-s', str(SR),
                  '-n', str(NC), '-a', 'ans', '-nc',
                  '--parts', '3', '--rank', '0'])
    assert parts[0].stat().st_mtime_ns == mtime
    cli_merge([str(p) for p in parts]
              + ['-o', str(tmp_path_ / 'm.cbin'),
                 '-m', str(tmp_path_ / 'm.ch')])
    assert (tmp_path_ / 'm.cbin').read_bytes() == \
        (tmp_path_ / 'full.cbin').read_bytes()
    with pytest.raises(ValueError, match='rank'):
        from mtscomp_tpu_torch.parallel.distributed import compress_part_rank
        compress_part_rank(raw, tmp_path_ / 'm.cbin', 7, 3,
                           sample_rate=SR, n_channels=NC, dtype='int16',
                           quiet=True)


def test_cli_parts_workers(tmp_path_, monkeypatch):
    """mtscomp --parts N --workers W: process-parallel compress+merge."""
    from mtscomp_tpu_torch.cli import mtscomp as cli_compress
    monkeypatch.setenv('HOME', str(tmp_path_))
    arr, raw = _make(tmp_path_, ns=3 * 2000)
    cli_compress([str(raw), '-d', 'int16', '-s', str(SR), '-n', str(NC),
                  '-a', 'ans', '--parts', '2', '--workers', '2', '-nc'])
    r = decompress(tmp_path_ / 'raw.cbin', tmp_path_ / 'raw.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_chop_drops_part_provenance(tmp_path_):
    """A chopped part must not keep part/part_of: merge would otherwise
    accept a silently truncated 'complete' set."""
    from mtscomp_tpu_torch import Reader
    arr, raw = _make(tmp_path_, ns=4 * 2000)
    compress_range(raw, tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch', 0, 4,
                   sample_rate=SR, n_channels=NC, dtype='int16',
                   quiet=True)
    r = Reader(quiet=True)
    r.open(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch')
    try:
        r.chop(2, tmp_path_ / 'chopped.cbin')
    finally:
        r.close()
    meta = json.loads((tmp_path_ / 'chopped.ch').read_text())
    assert meta['chopped'] is True
    assert 'part' not in meta and 'part_of' not in meta


def test_merge_plain_files_coverage(tmp_path_, caplog):
    """Hand-assembled merges of plain (non-ranged) files: warn without
    provenance; --expect-chunks / expected_n_chunks asserts coverage."""
    import logging
    arr, raw = _make(tmp_path_, ns=4 * 2000)
    # Two plain compressed halves (no part provenance in the sidecars).
    h1 = write_arr(tmp_path_ / 'h1.bin', arr[:2 * 2000])
    h2 = write_arr(tmp_path_ / 'h2.bin', arr[2 * 2000:])
    a = (tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch')
    b = (tmp_path_ / 'b.cbin', tmp_path_ / 'b.ch')
    compress(h1, *a, sample_rate=SR, n_channels=NC, dtype='int16',
             quiet=True)
    compress(h2, *b, sample_rate=SR, n_channels=NC, dtype='int16',
             quiet=True)
    assert 'part' not in json.loads(a[1].read_text())

    # No provenance, no expected count: merge succeeds but warns loudly.
    with caplog.at_level(logging.WARNING, logger='mtscomp_tpu_torch'):
        merge_parts([a, b], tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch')
    assert any('cannot verify' in rec.message for rec in caplog.records)

    # Expected count catches a missing tail file.
    with pytest.raises(ValueError, match='refusing'):
        merge_parts([a], tmp_path_ / 'm2.cbin', tmp_path_ / 'm2.ch',
                    expected_n_chunks=4)
    # And passes when coverage is complete.
    merge_parts([a, b], tmp_path_ / 'm3.cbin', tmp_path_ / 'm3.ch',
                expected_n_chunks=4)
    r = decompress(tmp_path_ / 'm3.cbin', tmp_path_ / 'm3.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_mtsmerge_expect_chunks_cli(tmp_path_):
    from mtscomp_tpu_torch.cli import mtsmerge
    arr, raw = _make(tmp_path_, ns=3 * 2000)
    a = (tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch')
    compress_range(raw, *a, 0, 2, sample_rate=SR, n_channels=NC,
                   dtype='int16', quiet=True)
    # Declared count conflicts with the parts' own part_of provenance.
    with pytest.raises(ValueError):
        mtsmerge([str(a[0]), '-o', str(tmp_path_ / 'm.cbin'),
                  '--expect-chunks', '2'])


def test_cli_workers_with_rank_rejected(tmp_path_):
    """--workers is dead with --rank (one part per rank): explicit error."""
    from mtscomp_tpu_torch.cli import mtscomp as mtscomp_cli
    arr, raw = _make(tmp_path_, ns=2 * 2000)
    with pytest.raises(ValueError, match='--workers'):
        mtscomp_cli([str(raw), '-s', str(SR), '-n', str(NC), '-d', 'int16',
                     '--parts', '2', '--rank', '0', '--workers', '2'])


class _CapturingPool:
    """Stands in for ProcessPoolExecutor: runs the tasks in this process
    and records the keyword arguments each worker would receive."""
    captured = []

    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def map(self, fn, tasks):
        for t in tasks:
            self.captured.append(t[-1])
            yield fn(t)


@pytest.mark.parametrize('named,want', [(None, 'none'), ('auto', 'none'),
                                        ('none', 'none'), ('cpu', 'cpu')])
def test_spawned_workers_keep_to_the_host_unless_named(tmp_path_,
                                                       monkeypatch, named,
                                                       want):
    """Tasks shipped to spawned workers carry ``device='none'`` unless
    the caller named a device: the port's default (``'cuda'``) and
    ``'auto'`` would have N fresh processes each open a CUDA context on
    one card. An explicit device passes through untouched, and the
    planning writer resolves none (the default configuration, on a host
    with no GPU, still runs)."""
    import concurrent.futures
    from mtscomp_tpu_torch.parallel import distributed as dist
    mt_config.CONFIG_PATH.unlink()            # the default: device 'cuda'
    assert mt_config.read_config().device == 'cuda'
    arr, raw = _make(tmp_path_, ns=3 * 2000)
    monkeypatch.setattr(_CapturingPool, 'captured', [])
    monkeypatch.setattr(concurrent.futures, 'ProcessPoolExecutor',
                        _CapturingPool)
    kw = {} if named is None else {'device': named}
    dist.compress_multihost(raw, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                            n_parts=2, n_workers=2,
                            part_dir=tmp_path_ / 'parts', sample_rate=SR,
                            n_channels=NC, dtype='int16',
                            algorithm='ans', quiet=True, **kw)
    captured = _CapturingPool.captured
    assert len(captured) == 2
    assert all(k['device'] == want for k in captured)
    r = decompress(tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch', device='none',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_multihost_uses_the_spawn_context(tmp_path_, monkeypatch):
    """A forked child cannot re-initialise CUDA: the pool is spawned."""
    import concurrent.futures
    from mtscomp_tpu_torch.parallel import distributed as dist
    arr, raw = _make(tmp_path_, ns=3 * 2000)
    seen = {}

    class Pool(_CapturingPool):
        def __init__(self, max_workers=None, mp_context=None):
            seen['method'] = mp_context.get_start_method()
            seen['workers'] = max_workers

    monkeypatch.setattr(_CapturingPool, 'captured', [])
    monkeypatch.setattr(concurrent.futures, 'ProcessPoolExecutor', Pool)
    dist.compress_multihost(raw, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
                            n_parts=3, n_workers=2, sample_rate=SR,
                            n_channels=NC, dtype='int16', algorithm='ans',
                            quiet=True)
    assert seen == {'method': 'spawn', 'workers': 2}


def test_merge_mixed_seg_parts_exact_and_verifiable(tmp_path_):
    """Parts whose sidecars differ only in ans_seg_log2/ans_table_mode
    ARE decode-identity-equal (both keys are payload-level: every chunk
    header self-describes them) and must merge; the merged file must
    decode exactly and pass a deep verify via the real merged decoded
    hash. Guards the DECODE_IDENTITY_KEYS boundary from the other side:
    the round-3 fix must reject only keys that actually change decode
    semantics."""
    from mtscomp_tpu_torch.verify import verify_file
    arr, raw = _make(tmp_path_)
    parts = []
    for (first, last), seg, tmode in zip(
            plan_ranges(6, 2), (12, 10), ('segment', 'plane')):
        cbin = tmp_path_ / ('ms%d.cbin' % first)
        ch = tmp_path_ / ('ms%d.ch' % first)
        compress_range(raw, cbin, ch, first, last, sample_rate=SR,
                       n_channels=NC, dtype='int16', algorithm='ans',
                       quiet=True, ans_seg_log2=seg, ans_table_mode=tmode)
        parts.append((cbin, ch))
    merged = merge_parts(parts, tmp_path_ / 'ms.cbin', tmp_path_ / 'ms.ch')
    assert merged['sha1_uncompressed'] is not None
    r = decompress(tmp_path_ / 'ms.cbin', tmp_path_ / 'ms.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()
    rep = verify_file(tmp_path_ / 'ms.cbin', tmp_path_ / 'ms.ch', deep=True)
    assert rep['ok']


# --- the two packages against each other ----------------------------------

@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
@pytest.mark.parametrize('writers', ['port+jax', 'jax+port', 'jax+jax'])
@pytest.mark.parametrize('merger', ['port', 'jax'])
def test_parts_of_one_package_merge_under_the_other(tmp_path_, algorithm,
                                                    writers, merger):
    """Two chunk-range parts, each written by either package, merge
    under either package into the bytes of a whole-file compress (the
    port's merge of the JAX package's parts included), and both
    packages' ``verify_file`` give the merged pair the same report."""
    from mtscomp_tpu.parallel import distributed as ref_dist
    arr, raw = _make(tmp_path_)
    kw = dict(sample_rate=SR, n_channels=NC, dtype='int16',
              algorithm=algorithm, quiet=True, device='none')
    compress(raw, tmp_path_ / 'whole.cbin', tmp_path_ / 'whole.ch', **kw)
    n_chunks = len(json.loads(
        (tmp_path_ / 'whole.ch').read_text())['chunk_bounds']) - 1
    ranges = plan_ranges(n_chunks, 2)
    assert ranges == ref_dist.plan_ranges(n_chunks, 2)
    parts = []
    for who, (first, last) in zip(writers.split('+'), ranges):
        cbin, ch = (tmp_path_ / ('part%d%s' % (first, ext))
                    for ext in ('.cbin', '.ch'))
        (compress_range if who == 'port' else ref_dist.compress_range)(
            raw, cbin, ch, first, last, **kw)
        parts.append((cbin, ch))
    (merge_parts if merger == 'port' else ref_dist.merge_parts)(
        parts, tmp_path_ / 'm.cbin', tmp_path_ / 'm.ch',
        expected_n_chunks=n_chunks)
    assert (tmp_path_ / 'm.cbin').read_bytes() == \
        (tmp_path_ / 'whole.cbin').read_bytes()
    got = json.loads((tmp_path_ / 'm.ch').read_text())
    want = json.loads((tmp_path_ / 'whole.ch').read_text())
    assert got == want
    assert mt.verify_file(tmp_path_ / 'm.cbin', quiet=True) == \
        ref.verify_file(tmp_path_ / 'm.cbin', quiet=True)
    assert mt.verify_file(tmp_path_ / 'm.cbin', quiet=True)['ok']


def test_multihost_on_the_twins_writes_the_host_route_s_bytes(tmp_path_):
    """``device='cpu'`` named by the caller reaches the ranged writers
    (sequential here): the parts go through the device encode's twins
    and merge into the host route's bytes, equal to the JAX package's
    ``compress_multihost`` of the same file."""
    from mtscomp_tpu.parallel import distributed as ref_dist
    arr, raw = _make(tmp_path_)
    kw = dict(n_parts=2, sample_rate=SR, n_channels=NC, dtype='int16',
              algorithm='ans', quiet=True)
    mt.reset_launch_counts()
    compress_multihost(raw, tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
                       part_dir=tmp_path_ / 'pa', device='cpu', **kw)
    ref_dist.compress_multihost(raw, tmp_path_ / 'b.cbin',
                                tmp_path_ / 'b.ch',
                                part_dir=tmp_path_ / 'pb', device='none',
                                **kw)
    assert (tmp_path_ / 'a.cbin').read_bytes() == \
        (tmp_path_ / 'b.cbin').read_bytes()
    assert json.loads((tmp_path_ / 'a.ch').read_text()) == \
        json.loads((tmp_path_ / 'b.ch').read_text())


def test_part_helpers_match_the_reference(tmp_path_):
    from mtscomp_tpu.parallel import distributed as ref_dist
    from mtscomp_tpu_torch.parallel import distributed as dist
    for n_chunks, n_parts in [(10, 3), (2, 5), (7, 1), (1800, 7), (5, 5)]:
        assert dist.plan_ranges(n_chunks, n_parts) == \
            ref_dist.plan_ranges(n_chunks, n_parts)
    assert dist.part_paths(tmp_path_ / 'x.cbin', 3, 9) == \
        ref_dist.part_paths(tmp_path_ / 'x.cbin', 3, 9)
    assert dist.part_paths('x.cbin', 0, 4, tmp_path_) == \
        ref_dist.part_paths('x.cbin', 0, 4, tmp_path_)
    arr, raw = _make(tmp_path_, ns=3 * 2000)
    ref_dist.compress_range(raw, tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch',
                            0, 2, sample_rate=SR, n_channels=NC,
                            dtype='int16', algorithm='ans', quiet=True,
                            device='none')
    assert dist._part_valid(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch')
    data = bytearray((tmp_path_ / 'p.cbin').read_bytes())
    data[50] ^= 1
    (tmp_path_ / 'p.cbin').write_bytes(bytes(data))
    assert not dist._part_valid(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch')
    assert not ref_dist._part_valid(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch')
