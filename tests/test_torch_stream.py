"""PyTorch port: ``StreamWriter`` / ``StreamReader`` (live
append-as-acquired compression, byte-identical to batch compress).

The JAX package's ``tests/test_stream.py`` run against the port's own
``stream.py``, then the two packages against each other: a stream begun
by one package is resumed and finished by the other into the bytes of a
batch compress, and the resume of a sidecar that publishes no chunk
(``chunk_offsets == [0]``), on which the JAX package raises IndexError,
gives an empty stream.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip('jax')

import mtscomp_tpu as ref  # noqa: E402
import mtscomp_tpu.config as ref_config  # noqa: E402
import mtscomp_tpu_torch as mt  # noqa: E402
import mtscomp_tpu_torch.config as mt_config  # noqa: E402
import hashlib  # noqa: E402

from mtscomp_tpu_torch import (StreamReader, StreamWriter,  # noqa: E402
                               compress, decompress)
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
NC = 11


@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
def test_stream_matches_batch(tmp_path_, algorithm):
    """Arbitrary block sizes stream to the exact bytes of compress()."""
    arr = to_int16(make_signal('colored', ns=5 * 2000 + 333, nc=NC))
    path = write_arr(tmp_path_ / 'batch.bin', arr)
    compress(path, tmp_path_ / 'batch.cbin', tmp_path_ / 'batch.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm=algorithm, quiet=True)
    rng = np.random.default_rng(3)
    with StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                      sample_rate=SR, n_channels=NC, dtype='int16',
                      algorithm=algorithm) as w:
        i = 0
        while i < arr.shape[0]:
            n = int(rng.integers(1, 3000))
            w.append(arr[i:i + n])
            i += n
    assert (tmp_path_ / 'live.cbin').read_bytes() == \
        (tmp_path_ / 'batch.cbin').read_bytes()
    import json
    live = json.loads((tmp_path_ / 'live.ch').read_text())
    batch = json.loads((tmp_path_ / 'batch.ch').read_text())
    assert live == batch
    r = decompress(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_stream_single_sample_blocks(tmp_path_):
    """Degenerate feed: one sample at a time, sub-chunk total."""
    arr = to_int16(make_signal('randn', ns=700, nc=NC))
    with StreamWriter(tmp_path_ / 's.cbin', tmp_path_ / 's.ch',
                      sample_rate=SR, n_channels=NC,
                      dtype='int16') as w:
        for i in range(arr.shape[0]):
            w.append(arr[i])
    r = decompress(tmp_path_ / 's.cbin', tmp_path_ / 's.ch', quiet=True)
    try:
        assert np.array_equal(r[:], arr)
        assert r.n_chunks == 1          # single partial chunk
    finally:
        r.close()


def test_stream_reused_acquisition_buffer(tmp_path_):
    """A caller may refill ONE buffer between append() calls (the DMA
    block pattern); the writer must copy, never alias."""
    arr = to_int16(make_signal('colored', ns=5 * 300, nc=NC))
    buf = np.empty((300, NC), dtype=np.int16)
    with StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                      sample_rate=SR, n_channels=NC, dtype='int16',
                      algorithm='ans') as w:
        for i in range(5):
            buf[:] = arr[i * 300:(i + 1) * 300]
            w.append(buf)
    r = decompress(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_stream_segment_tables_matches_batch(tmp_path_):
    """ans_table_mode reaches the stream codec (byte-identity holds)."""
    rng = np.random.default_rng(4)
    stds = np.logspace(0.0, 1.6, NC)
    arr = np.clip(np.cumsum(rng.normal(0, 1, (3 * 2000 + 77, NC)) * stds,
                            axis=0), -30000, 30000).astype(np.int16)
    path = write_arr(tmp_path_ / 'batch.bin', arr)
    compress(path, tmp_path_ / 'batch.cbin', tmp_path_ / 'batch.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', ans_table_mode='segment', quiet=True)
    with StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                      sample_rate=SR, n_channels=NC, dtype='int16',
                      algorithm='ans', ans_table_mode='segment') as w:
        w.append(arr)
    assert (tmp_path_ / 'live.cbin').read_bytes() == \
        (tmp_path_ / 'batch.cbin').read_bytes()
    import json
    live = json.loads((tmp_path_ / 'live.ch').read_text())
    assert live.get('ans_table_mode') == 'segment'


def test_stream_close_after_abort_is_benign(tmp_path_):
    """close() after an aborted context exits cleanly (no AttributeError)."""
    w = StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16')
    try:
        with w:
            w.append(to_int16(make_signal('randn', ns=10, nc=NC)))
            raise RuntimeError('acquisition died')
    except RuntimeError:
        pass
    assert w.close() is None
    assert not (tmp_path_ / 'live.cbin').exists()


def test_stream_reader_tails_live_stream(tmp_path_):
    """StreamReader follows a live_sidecar writer: snapshots publish
    only whole chunks, refresh() sees growth, finalized flips on close,
    and every snapshot is itself a valid compressed prefix file."""
    import hashlib as hl
    import json
    from mtscomp_tpu_torch import StreamReader
    arr = to_int16(make_signal('colored', ns=5 * 2000 + 500, nc=NC))
    w = StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     algorithm='ans', live_sidecar=True)
    w.append(arr[:2 * 2000 + 700])            # 2 full chunks + 700 pending
    r = StreamReader(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch')
    try:
        assert r.n_samples == 2 * 2000        # whole chunks only
        assert not r.finalized
        assert np.array_equal(r[:], arr[:2 * 2000])
        assert np.array_equal(r[-500:], arr[2 * 2000 - 500:2 * 2000])
        # The snapshot is a fully valid compressed file of the prefix.
        meta = json.loads((tmp_path_ / 'live.ch').read_text())
        assert meta['streaming'] is True
        assert meta['sha1_uncompressed'] == \
            hl.sha1(np.ascontiguousarray(arr[:2 * 2000])).hexdigest()
        rd = decompress(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                        quiet=True)
        try:
            assert np.array_equal(rd[:], arr[:2 * 2000])
        finally:
            rd.close()
        # No growth -> refresh() is False; growth -> True.
        assert r.refresh() is False
        w.append(arr[2 * 2000 + 700:])
        assert r.refresh() is True
        assert r.n_samples == 5 * 2000
        w.close()
        assert r.refresh() is True            # final (partial) chunk
        assert r.finalized
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_stream_reader_requires_sidecar(tmp_path_):
    from mtscomp_tpu_torch import StreamReader
    (tmp_path_ / 'x.cbin').write_bytes(b'')
    with pytest.raises(IOError, match='live_sidecar'):
        StreamReader(tmp_path_ / 'x.cbin', tmp_path_ / 'x.ch')


def test_stream_live_abort_removes_sidecar(tmp_path_):
    arr = to_int16(make_signal('randn', ns=3000, nc=NC))
    try:
        with StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                          sample_rate=SR, n_channels=NC, dtype='int16',
                          live_sidecar=True) as w:
            w.append(arr)
            raise RuntimeError('boom')
    except RuntimeError:
        pass
    assert not (tmp_path_ / 'live.cbin').exists()
    assert not (tmp_path_ / 'live.ch').exists()


def test_stream_empty_rejected(tmp_path_):
    w = StreamWriter(tmp_path_ / 'e.cbin', tmp_path_ / 'e.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16')
    with pytest.raises(ValueError):
        w.close()
    assert not (tmp_path_ / 'e.cbin').exists()


def test_stream_abort_cleans_up(tmp_path_):
    """An exception inside the with-block removes the partial output."""
    arr = to_int16(make_signal('randn', ns=3000, nc=NC))
    with pytest.raises(RuntimeError):
        with StreamWriter(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
                          sample_rate=SR, n_channels=NC,
                          dtype='int16') as w:
            w.append(arr)
            raise RuntimeError("acquisition died")
    assert not (tmp_path_ / 'a.cbin').exists()
    assert not (tmp_path_ / 'a.ch').exists()


def test_stream_reader_with_segment_tables(tmp_path_):
    """Live tailing works for bit4 (segment-table) streams."""
    from mtscomp_tpu_torch import StreamReader
    rng = np.random.default_rng(8)
    stds = np.logspace(0.0, 1.6, NC)
    arr = np.clip(np.cumsum(rng.normal(0, 1, (3 * 2000 + 250, NC)) * stds,
                            axis=0), -30000, 30000).astype(np.int16)
    w = StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     algorithm='ans', ans_table_mode='segment',
                     live_sidecar=True)
    w.append(arr[:2 * 2000 + 100])
    r = StreamReader(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch')
    try:
        assert np.array_equal(r[:], arr[:2 * 2000])
        w.append(arr[2 * 2000 + 100:])
        w.close()
        r.refresh()
        assert r.finalized
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_stream_close_inside_with_block_preserved(tmp_path_):
    """An exception AFTER an explicit close() must not delete the
    finalized recording."""
    arr = to_int16(make_signal('randn', ns=3000, nc=NC))
    try:
        with StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                          sample_rate=SR, n_channels=NC, dtype='int16',
                          live_sidecar=True) as w:
            w.append(arr)
            w.close()
            raise RuntimeError('post-processing died')
    except RuntimeError:
        pass
    r = decompress(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_stream_append_type_errors(tmp_path_):
    """Mismatched blocks raise (never silently cast, even under -O)."""
    w = StreamWriter(tmp_path_ / 'x.cbin', tmp_path_ / 'x.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16')
    with pytest.raises(ValueError, match='dtype'):
        w.append(np.zeros((10, NC), dtype=np.int32))
    with pytest.raises(ValueError, match='channels'):
        w.append(np.zeros((10, NC + 1), dtype=np.int16))
    # 1-D block whose length is not a multiple of n_channels: the same
    # descriptive error, not numpy's raw reshape error.
    with pytest.raises(ValueError, match='channels'):
        w.append(np.zeros(NC + 1, dtype=np.int16))
    w.append(np.zeros(2 * NC, dtype=np.int16))       # valid flat block
    w.append(np.zeros((10, NC), dtype=np.int16))
    w.close()


def test_stream_reader_tolerates_torn_sidecar(tmp_path_):
    """A garbage sidecar mid-poll keeps the previous reader."""
    from mtscomp_tpu_torch import StreamReader
    arr = to_int16(make_signal('randn', ns=2 * 2000, nc=NC))
    w = StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     live_sidecar=True)
    w.append(arr)
    r = StreamReader(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch')
    try:
        assert r.n_samples == 2 * 2000
        good = (tmp_path_ / 'live.ch').read_bytes()
        (tmp_path_ / 'live.ch').write_bytes(good[:20])     # torn write
        assert r.refresh() is False                        # kept old
        assert r.n_samples == 2 * 2000
        (tmp_path_ / 'live.ch').write_bytes(good)          # restored
        r.refresh()
        assert np.array_equal(r[:], arr)
    finally:
        r.close()
        w.close()


def test_stream_reader_refresh_error_discipline(tmp_path_, caplog):
    """Reader bugs surface; persistent parse failures warn after retries."""
    import logging
    from mtscomp_tpu_torch import StreamReader
    from mtscomp_tpu_torch.api import Reader
    arr = to_int16(make_signal('randn', ns=2000, nc=NC))
    w = StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     live_sidecar=True)
    w.append(arr)
    r = StreamReader(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch')
    try:
        # A genuine reader bug (AttributeError) must NOT be swallowed
        # as a torn sidecar.
        orig_open = Reader.open

        def boom(self, *a, **k):
            raise AttributeError('reader bug')
        Reader.open = boom
        (tmp_path_ / 'live.ch').write_bytes(b'{}')   # force a re-open
        try:
            with pytest.raises(AttributeError, match='reader bug'):
                r.refresh()
        finally:
            Reader.open = orig_open

        # A permanently malformed sidecar warns after 10 consecutive
        # parse failures instead of staying silent forever.
        (tmp_path_ / 'live.ch').write_bytes(b'not json')
        with caplog.at_level(logging.DEBUG, logger='mtscomp_tpu_torch'):
            for _ in range(10):
                assert r.refresh() is False
        assert any('consecutive' in rec.message
                   for rec in caplog.records
                   if rec.levelno >= logging.WARNING)
    finally:
        r.close()
        w.close()


def test_chop_of_live_snapshot_drops_streaming_marker(tmp_path_):
    from mtscomp_tpu_torch import Reader
    arr = to_int16(make_signal('colored', ns=3 * 2000, nc=NC))
    w = StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     live_sidecar=True)
    w.append(arr)                  # 3 chunks published, stream still open
    r = Reader(quiet=True)
    r.open(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch')
    try:
        r.chop(2, tmp_path_ / 'chopped.cbin')
    finally:
        r.close()
        w.close()
    import json
    meta = json.loads((tmp_path_ / 'chopped.ch').read_text())
    assert meta['chopped'] is True and 'streaming' not in meta
    rd = decompress(tmp_path_ / 'chopped.cbin', tmp_path_ / 'chopped.ch',
                    quiet=True)
    try:
        assert np.array_equal(rd[:], arr[:2 * 2000])
    finally:
        rd.close()


def _crash(writer):
    """Simulate a process crash: drop the writer without close() —
    whatever was not flushed to disk is lost."""
    writer._fb.close()
    writer._closed = True


@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
def test_stream_resume_matches_batch(tmp_path_, algorithm):
    """Crash mid-stream, resume from the snapshot, finish: the output
    must be byte-identical to an uninterrupted batch compress."""
    arr = to_int16(make_signal('colored', ns=5 * 2000 + 333, nc=NC))
    path = write_arr(tmp_path_ / 'batch.bin', arr)
    compress(path, tmp_path_ / 'batch.cbin', tmp_path_ / 'batch.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm=algorithm, quiet=True)
    w = StreamWriter(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     algorithm=algorithm, live_sidecar=True)
    cut = 2 * 2000 + 777                 # 2 full chunks + buffered tail
    w.append(arr[:cut])
    _crash(w)
    w2 = StreamWriter.resume(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch')
    assert w2.n_samples == 2 * 2000      # the buffered tail was lost
    w2.append(arr[w2.n_samples:])        # replay from the last sample
    w2.close()
    assert (tmp_path_ / 'live.cbin').read_bytes() == \
        (tmp_path_ / 'batch.cbin').read_bytes()
    import json
    assert json.loads((tmp_path_ / 'live.ch').read_text()) == \
        json.loads((tmp_path_ / 'batch.ch').read_text())


def test_stream_resume_truncates_unflushed_bytes(tmp_path_):
    """Bytes past the last published chunk offset (a write the crash
    interrupted) are dropped on resume."""
    arr = to_int16(make_signal('colored', ns=3 * 2000, nc=NC))
    w = StreamWriter(tmp_path_ / 's.cbin', tmp_path_ / 's.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     algorithm='ans', live_sidecar=True)
    w.append(arr[:2 * 2000])
    _crash(w)
    with open(tmp_path_ / 's.cbin', 'ab') as f:
        f.write(b'\x01\x02\x03garbage-partial-write')
    w2 = StreamWriter.resume(tmp_path_ / 's.cbin', tmp_path_ / 's.ch')
    w2.append(arr[w2.n_samples:])
    w2.close()
    r = decompress(tmp_path_ / 's.cbin', tmp_path_ / 's.ch', quiet=True,
                   device='none')
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_stream_resume_rejects_corrupt_prefix(tmp_path_):
    """A flipped byte in the surviving payload must fail the resume
    audit instead of silently continuing a corrupt recording."""
    arr = to_int16(make_signal('colored', ns=3 * 2000, nc=NC))
    w = StreamWriter(tmp_path_ / 'c.cbin', tmp_path_ / 'c.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     algorithm='ans', live_sidecar=True)
    w.append(arr[:2 * 2000])
    _crash(w)
    blob = bytearray((tmp_path_ / 'c.cbin').read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (tmp_path_ / 'c.cbin').write_bytes(bytes(blob))
    with pytest.raises(IOError):
        StreamWriter.resume(tmp_path_ / 'c.cbin', tmp_path_ / 'c.ch')


def test_stream_resume_rejects_partial_tail(tmp_path_):
    """A finalized recording whose last chunk is partial cannot be
    extended byte-identically."""
    arr = to_int16(make_signal('colored', ns=2 * 2000 + 500, nc=NC))
    with StreamWriter(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch',
                      sample_rate=SR, n_channels=NC, dtype='int16',
                      algorithm='ans') as w:
        w.append(arr)
    with pytest.raises(ValueError, match='partial'):
        StreamWriter.resume(tmp_path_ / 'p.cbin', tmp_path_ / 'p.ch')


def test_stream_resume_append_to_finalized(tmp_path_):
    """resume() doubles as append-to-existing when the finalized
    recording ends on a chunk boundary."""
    arr = to_int16(make_signal('colored', ns=4 * 2000, nc=NC))
    with StreamWriter(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch',
                      sample_rate=SR, n_channels=NC, dtype='int16',
                      algorithm='ans') as w:
        w.append(arr[:2 * 2000])
    w2 = StreamWriter.resume(tmp_path_ / 'a.cbin', tmp_path_ / 'a.ch')
    assert w2.live_sidecar is False      # finalized source: batch style
    w2.append(arr[2 * 2000:])
    w2.close()
    path = write_arr(tmp_path_ / 'full.bin', arr)
    compress(path, tmp_path_ / 'full.cbin', tmp_path_ / 'full.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True)
    assert (tmp_path_ / 'a.cbin').read_bytes() == \
        (tmp_path_ / 'full.cbin').read_bytes()


def test_stream_resume_rejects_format_overrides(tmp_path_):
    """Every key defining how already-written chunks decode is
    sidecar-owned on resume: an override (e.g. time_diff_order='auto'
    resolving to 1 over an order-2 prefix) would finalize a sidecar
    that silently misdescribes the surviving chunks."""
    arr = to_int16(make_signal('colored', ns=2 * 2000, nc=NC))
    with StreamWriter(tmp_path_ / 'o.cbin', tmp_path_ / 'o.ch',
                      sample_rate=SR, n_channels=NC, dtype='int16',
                      algorithm='ans', time_diff_order=2) as w:
        w.append(arr)
    for key, val in [('time_diff_order', 'auto'), ('time_diff_order', 1),
                     ('do_time_diff', False), ('do_spatial_diff', True),
                     ('chunk_order', 'C'), ('float_bitcast', False),
                     ('algorithm', 'zlib'), ('dtype', 'int32')]:
        with pytest.raises(ValueError, match='cannot be overridden'):
            StreamWriter.resume(tmp_path_ / 'o.cbin', tmp_path_ / 'o.ch',
                                **{key: val})


@pytest.mark.parametrize('opts', [
    dict(ans_table_mode='plane'),
    dict(ans_channel_segments=False),
])
def test_stream_resume_preserves_layout_choices(tmp_path_, opts):
    """Layout options the sidecar does not spell out (plane tables are
    recorded by omission; channel alignment is a container flag) must
    survive a resume, or resumed chunks diverge from the batch bytes."""
    arr = to_int16(make_signal('colored', ns=4 * 2000, nc=NC))
    path = write_arr(tmp_path_ / 'full.bin', arr)
    compress(path, tmp_path_ / 'full.cbin', tmp_path_ / 'full.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True, **opts)
    w = StreamWriter(tmp_path_ / 'l.cbin', tmp_path_ / 'l.ch',
                     sample_rate=SR, n_channels=NC, dtype='int16',
                     algorithm='ans', live_sidecar=True, **opts)
    w.append(arr[:2 * 2000])
    _crash(w)
    w2 = StreamWriter.resume(tmp_path_ / 'l.cbin', tmp_path_ / 'l.ch')
    w2.append(arr[2 * 2000:])
    w2.close()
    assert (tmp_path_ / 'l.cbin').read_bytes() == \
        (tmp_path_ / 'full.cbin').read_bytes()


def test_stream_float_bitcast_resume_batch_identical(tmp_path_):
    """Float streams code in bitcast domain like the batch Writer:
    stream + crash-resume at a chunk boundary must produce a
    bit-exact round trip AND the exact bytes of a one-shot batch
    compress (the resume follows the sidecar's recorded domain)."""
    rng = np.random.RandomState(5)
    arr = rng.normal(0, 1, (9000, NC)).astype(np.float32)
    cb, ch = tmp_path_ / 'fs.cbin', tmp_path_ / 'fs.ch'
    with StreamWriter(cb, ch, sample_rate=3000.0, n_channels=NC,
                      dtype='float32', algorithm='ans') as w:
        w.append(arr[:6000])
    w2 = StreamWriter.resume(cb, ch)
    w2.append(arr[6000:])
    w2.close()
    r = decompress(cb, ch, quiet=True)
    try:
        assert r.cmeta['float_bitcast'] is True
        out = np.asarray(r[:])
        assert np.array_equal(out.view(np.int32), arr.view(np.int32))
    finally:
        r.close()
    raw = write_arr(tmp_path_ / 'fb.bin', arr)
    compress(raw, tmp_path_ / 'fb.cbin', tmp_path_ / 'fb.ch',
             sample_rate=3000.0, n_channels=NC, dtype='float32',
             algorithm='ans', quiet=True, check_after_compress=False)
    assert cb.read_bytes() == (tmp_path_ / 'fb.cbin').read_bytes()


def test_stream_resume_chopped_file(tmp_path_):
    """A chopped file is a finalized archive with NULLED hashes
    (reference chop semantics) — resume must accept it (nothing to
    audit against), append byte-identically, and finalize with REAL
    re-derived hashes. Previously `hexdigest() != None` surfaced as a
    false 'surviving prefix is corrupt' IOError (found by the
    lifecycle storm)."""
    import json
    arr = to_int16(make_signal('colored', ns=5 * 2000, nc=NC))
    raw = write_arr(tmp_path_ / 'full.bin', arr)
    compress(raw, tmp_path_ / 'full.cbin', tmp_path_ / 'full.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm='ans', quiet=True)
    r = decompress(tmp_path_ / 'full.cbin', tmp_path_ / 'full.ch',
                   quiet=True)
    bounds = r.chunk_bounds
    r.chop(2, tmp_path_ / 'head.cbin')
    r.close()
    head_meta = json.loads((tmp_path_ / 'head.ch').read_text())
    assert head_meta['sha1_compressed'] is None
    w = StreamWriter.resume(tmp_path_ / 'head.cbin', tmp_path_ / 'head.ch')
    w.append(arr[bounds[2]:])
    w.close()
    # Byte-identical to the uninterrupted batch compress, with the
    # chopped sidecar's null hashes replaced by real re-derived ones.
    assert (tmp_path_ / 'head.cbin').read_bytes() == \
        (tmp_path_ / 'full.cbin').read_bytes()
    full_meta = json.loads((tmp_path_ / 'full.ch').read_text())
    meta = json.loads((tmp_path_ / 'head.ch').read_text())
    assert meta['sha1_compressed'] == full_meta['sha1_compressed']
    assert meta['sha1_uncompressed'] == full_meta['sha1_uncompressed']
    r = decompress(tmp_path_ / 'head.cbin', tmp_path_ / 'head.ch',
                   quiet=True)
    try:
        assert np.array_equal(r[:], arr)
    finally:
        r.close()


def test_stream_resume_rejects_legacy_float_domain(tmp_path_):
    """Legacy-domain (non-bitcast) float files decode within CHECK_ATOL
    only: the raw-stream hash state cannot be re-derived, so resume
    must refuse with the crafted contract error (not a misleading
    hash-mismatch IOError)."""
    rng = np.random.RandomState(9)
    arr = rng.normal(0, 1, (2 * 2000, NC)).astype(np.float32)
    cb, ch = tmp_path_ / 'lf.cbin', tmp_path_ / 'lf.ch'
    with StreamWriter(cb, ch, sample_rate=SR, n_channels=NC,
                      dtype='float32', algorithm='zlib') as w:
        w.append(arr)
    # A resume that can never succeed must be side-effect-free: even
    # unflushed trailing bytes (normally truncated during resume) must
    # survive the refusal untouched.
    before = cb.read_bytes() + b'\x01\x02\x03trailing'
    cb.write_bytes(before)
    with pytest.raises(ValueError, match='legacy'):
        StreamWriter.resume(cb, ch)
    assert cb.read_bytes() == before


# --- the two packages against each other ----------------------------------

def _stream_source(n_chunks=5, tail=333):
    return to_int16(make_signal('colored', ns=n_chunks * 2000 + tail, nc=NC))


@pytest.mark.parametrize('algorithm', ['zlib', 'ans'])
@pytest.mark.parametrize('starter,finisher', [('port', 'jax'),
                                              ('jax', 'port'),
                                              ('port', 'port')])
def test_stream_begun_by_one_package_resumes_under_the_other(
        tmp_path_, algorithm, starter, finisher):
    """A live stream that stops after three chunks is resumed by the
    other package and finished: the file is, byte for byte, the batch
    compress of the whole recording by either package."""
    writers = {'port': StreamWriter, 'jax': ref.StreamWriter}
    arr = _stream_source()
    path = write_arr(tmp_path_ / 'batch.bin', arr)
    kw = dict(sample_rate=SR, n_channels=NC, dtype='int16',
              algorithm=algorithm)
    compress(path, tmp_path_ / 'batch.cbin', tmp_path_ / 'batch.ch',
             quiet=True, **kw)
    ref.compress(path, tmp_path_ / 'jbatch.cbin', tmp_path_ / 'jbatch.ch',
                 quiet=True, device='none', **kw)
    assert (tmp_path_ / 'batch.cbin').read_bytes() == \
        (tmp_path_ / 'jbatch.cbin').read_bytes()
    w = writers[starter](tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
                         live_sidecar=True, **kw)
    w.append(arr[:3 * 2000 + 77])       # 77 samples die in the buffer
    w._fb.close()                       # the crash
    w2 = writers[finisher].resume(tmp_path_ / 'live.cbin',
                                  tmp_path_ / 'live.ch')
    assert w2.n_samples == 3 * 2000
    w2.append(arr[w2.n_samples:])
    w2.close()
    assert (tmp_path_ / 'live.cbin').read_bytes() == \
        (tmp_path_ / 'batch.cbin').read_bytes()
    assert json.loads((tmp_path_ / 'live.ch').read_text()) == \
        json.loads((tmp_path_ / 'batch.ch').read_text())
    assert mt.verify_file(tmp_path_ / 'live.cbin', quiet=True) == \
        ref.verify_file(tmp_path_ / 'live.cbin', quiet=True)


@pytest.mark.parametrize('reader', ['port', 'jax'])
@pytest.mark.parametrize('device', [None, 'cpu'])
def test_stream_written_by_one_package_is_tailed_by_the_other(
        tmp_path_, reader, device):
    """A StreamReader of either package follows the other's live
    writer; the port's on the configured device (here the host codec)
    when none is named, and on the twins when asked."""
    arr = _stream_source(4, 0)
    writer = ref.StreamWriter if reader == 'port' else StreamWriter
    tail_cls = StreamReader if reader == 'port' else ref.StreamReader
    kw = {} if device is None else {'device': device}
    if reader == 'jax' and device is None:
        kw = {'device': 'none'}
    w = writer(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch',
               sample_rate=SR, n_channels=NC, dtype='int16',
               algorithm='ans', live_sidecar=True)
    w.append(arr[:2000])
    t = tail_cls(tmp_path_ / 'live.cbin', tmp_path_ / 'live.ch', **kw)
    try:
        if reader == 'port':
            want = None if device is None else 'cpu'
            got = t._reader.device
            assert (got is None) if want is None else (got.type == want)
        assert t.n_samples == 2000 and not t.finalized
        assert np.array_equal(t[-500:], arr[1500:2000])
        w.append(arr[2000:6000])
        assert t.refresh() and t.n_samples == 6000
        assert np.array_equal(t[1990:4010], arr[1990:4010])
        w.append(arr[6000:])
        w.close()
        assert t.refresh() and t.finalized
        assert np.array_equal(t[:], arr)
    finally:
        t.close()


def _unpublished(tmp_path_, algorithm, hashes):
    """A live stream with one flushed chunk whose sidecar publishes no
    payload byte (``chunk_offsets == [0]``), written by the JAX package;
    with ``hashes`` the sidecar records the hashes of the empty prefix,
    else none."""
    arr = _stream_source(2, 0)
    w = ref.StreamWriter(tmp_path_ / 'e.cbin', tmp_path_ / 'e.ch',
                         sample_rate=SR, n_channels=NC, dtype='int16',
                         algorithm=algorithm, live_sidecar=True)
    w.append(arr[:2000])
    w._fb.close()
    cm = json.loads((tmp_path_ / 'e.ch').read_text())
    assert cm['chunk_bounds'] == [0, 2000] and len(cm['chunk_offsets']) == 2
    empty = hashlib.sha1().hexdigest() if hashes else None
    cm.update(chunk_offsets=[0], sha1_compressed=empty,
              sha1_uncompressed=empty)
    (tmp_path_ / 'e.ch').write_text(json.dumps(cm))
    return arr


@pytest.mark.parametrize('hashes', [False, True])
def test_reference_raises_indexerror_on_an_unpublished_stream(tmp_path_,
                                                              hashes):
    """The fault the port does not carry: the JAX package's resume reads
    ``offsets[1]`` of a sidecar that publishes no chunk."""
    _unpublished(tmp_path_, 'ans', hashes)
    with pytest.raises(IndexError):
        ref.StreamWriter.resume(tmp_path_ / 'e.cbin', tmp_path_ / 'e.ch')


@pytest.mark.parametrize('hashes', [False, True])
@pytest.mark.parametrize('algorithm', ['ans', 'zlib'])
def test_resume_of_an_unpublished_stream_starts_empty(tmp_path_, algorithm,
                                                      hashes):
    """On the same files the port resumes: no payload byte is published,
    so the stream restarts at sample 0 with the sidecar's format and
    chunk size, the unpublished bytes are dropped, and the finished file
    is the batch compress of what was appended."""
    arr = _unpublished(tmp_path_, algorithm, hashes)
    assert (tmp_path_ / 'e.cbin').stat().st_size > 0
    w = StreamWriter.resume(tmp_path_ / 'e.cbin', tmp_path_ / 'e.ch')
    assert w.n_samples == 0 and w.chunk_size == 2000
    assert w.chunk_bounds == [0] and w.chunk_offsets == [0]
    assert w.live_sidecar and w.algorithm == algorithm
    assert (tmp_path_ / 'e.cbin').stat().st_size == 0
    w.append(arr)
    w.close()
    path = write_arr(tmp_path_ / 'batch.bin', arr)
    cm = json.loads((tmp_path_ / 'e.ch').read_text())
    compress(path, tmp_path_ / 'batch.cbin', tmp_path_ / 'batch.ch',
             sample_rate=SR, n_channels=NC, dtype='int16',
             algorithm=algorithm, quiet=True,
             time_diff_order=int(cm.get('time_diff_order', 1)),
             do_spatial_diff=cm['do_spatial_diff'],
             ans_table_mode=cm.get('ans_table_mode') or 'plane')
    assert (tmp_path_ / 'e.cbin').read_bytes() == \
        (tmp_path_ / 'batch.cbin').read_bytes()
    assert cm == json.loads((tmp_path_ / 'batch.ch').read_text())
    assert mt.verify_file(tmp_path_ / 'e.cbin', quiet=True)['ok']


def test_resume_of_an_unpublished_stream_still_audits_its_hashes(tmp_path_):
    """A sidecar that publishes no chunk but records the hash of some
    payload is refused, and an empty stream still cannot be finalized."""
    _unpublished(tmp_path_, 'ans', True)
    cm = json.loads((tmp_path_ / 'e.ch').read_text())
    cm['sha1_compressed'] = 'f' * 40
    (tmp_path_ / 'e.ch').write_text(json.dumps(cm))
    with pytest.raises(IOError, match='sha1_compressed'):
        StreamWriter.resume(tmp_path_ / 'e.cbin', tmp_path_ / 'e.ch')
    _unpublished(tmp_path_, 'ans', False)
    w = StreamWriter.resume(tmp_path_ / 'e.cbin', tmp_path_ / 'e.ch')
    with pytest.raises(ValueError, match='empty stream'):
        w.close()
    # No chunk bounds at all is still the reference's clean error.
    cm = json.loads((tmp_path_ / 'e.ch').read_text()) \
        if (tmp_path_ / 'e.ch').exists() else cm
    cm.update(chunk_bounds=[0], chunk_offsets=[0])
    (tmp_path_ / 'e.ch').write_text(json.dumps(cm))
    (tmp_path_ / 'e.cbin').write_bytes(b'')
    for resume in (StreamWriter.resume, ref.StreamWriter.resume):
        with pytest.raises(ValueError, match='no complete chunks'):
            resume(tmp_path_ / 'e.cbin', tmp_path_ / 'e.ch')
