"""PyTorch port: the bulk decodes' staged fetch (``pipeline.StagingRing``).

A block decoded on a card reaches the result of ``decompress_to_array``,
``DeviceBatchDecoder.decode_batch`` or ``decompress_multi`` through a
ring of pinned host slots (``pipeline._HostRows``): each slot's bytes are
copied into their rows of the result on a thread pool, and a slot is
reused only after that copy has ended. On the CPU the same schedule runs
with plain host slots and a host tensor as the source (``StagingRing``
without a stream), held byte for byte against the path of a CPU device
(the block fetched, then copied or returned as it is).

The tests marked ``chip`` need a CUDA card and skip without one; on a
machine with a card they run with
``python -m pytest --noconftest -m chip tests/test_torch_fetch.py``
(this file imports no JAX).
"""

import threading

import numpy as np
import pytest
import torch
from concurrent.futures import ThreadPoolExecutor

import mtscomp_tpu_torch as mt
import mtscomp_tpu_torch.config as mt_config
from mtscomp_tpu_torch.parallel import pipeline as tp
from mtscomp_tpu_torch.parallel.mesh import chunk_mesh
from mtscomp_tpu_torch.utils import trace

#: Element dtypes a file may hold; floats are coded as their bits.
DTYPES = ('uint8', 'int16', 'uint16', 'int32', 'int64', 'uint64', 'float32',
          'float64')
C = 7


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    monkeypatch.setattr(mt_config, 'CONFIG_PATH', tmp_path / '.mtscomp')


def _bits(a):
    """The bytes of ``a`` as unsigned integers: NaN payloads compare."""
    return np.ascontiguousarray(a).view('u%d' % a.dtype.itemsize)


def _source(dtype, n, seed=0, channels=C):
    """A walk in ``dtype``, wrapping at its width; floats a walk x 1.5
    with NaN and both infinities planted."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-40, 41, size=(n, channels)), axis=0)
    dt = np.dtype(dtype)
    if dt.kind == 'f':
        arr = (walk * 1.5).astype(dt)
        arr.reshape(-1)[[1, 2 * channels + 3]] = [np.nan, np.inf]
        arr.reshape(-1)[-1] = -np.inf
        return arr
    return (walk + (1 << (8 * dt.itemsize - 2))).astype(dt)


def _compressed(tmp_path, arr, T, device='none'):
    path = tmp_path / 'src.bin'
    arr.tofile(path)
    cbin, ch = tmp_path / 's.cbin', tmp_path / 's.ch'
    mt.compress(path, cbin, ch, sample_rate=float(T),
                n_channels=arr.shape[1], dtype=str(arr.dtype),
                algorithm='ans', quiet=True, check_after_compress=False,
                device=device)
    return cbin, ch


def _host_ring(monkeypatch, n_slots, slot_bytes):
    """Send every block, host tensors included, through one plain host
    ring of ``n_slots`` slots of ``slot_bytes``."""
    ring = tp.StagingRing(n_slots, slot_bytes)
    monkeypatch.setattr(tp, '_fetch_ring', lambda device: ring)
    return ring


def _fetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith('mts-fetch') and t.is_alive()]


# --- the schedule alone ------------------------------------------------

#: name -> (rows, slots, slot bytes): a block smaller than one slot, one
#: whose bytes are not a multiple of the slot, slot edges inside rows.
GEOMETRIES = {'under_one_slot': (5, 2, 4096),
              'not_a_slot_multiple': (40, 3, 128),
              'edges_cut_rows': (23, 2, 24)}


@pytest.mark.parametrize('order', ['C', 'F'])
@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
@pytest.mark.parametrize('dtype', DTYPES)
def test_fetch_fills_any_destination_as_numpy_would(dtype, geometry, order):
    """``fetch`` writes a host tensor's elements, bytes as they are,
    into the destination's rows: the result equals NumPy's assignment of
    the block's view in the destination's dtype, for a C- or F-ordered
    destination."""
    rows, n_slots, slot_bytes = GEOMETRIES[geometry]
    dt = np.dtype(dtype)
    bits = np.random.default_rng(rows).integers(
        0, 256, size=rows * C * dt.itemsize, dtype=np.uint8)
    want = bits.view(dt).reshape(rows, C)
    dst = np.zeros((rows, C), dt, order=order)
    ring = tp.StagingRing(n_slots, slot_bytes)
    with ThreadPoolExecutor(3) as pool:
        ring.fetch(torch.from_numpy(bits.view(tp._BITS[dt.itemsize][1])
                                    .reshape(rows, C)), dst, pool)
    assert np.array_equal(_bits(dst), _bits(want))
    assert not ring.lock.locked()


def test_fetch_refuses_a_destination_of_another_size():
    ring = tp.StagingRing(2, 64)
    with ThreadPoolExecutor(1) as pool, pytest.raises(ValueError):
        ring.fetch(torch.zeros((4, C), dtype=torch.int16),
                   np.empty((3, C), np.int16), pool)
    assert not ring.lock.locked()


# --- decompress_to_array through the ring --------------------------------

#: case -> (chunks of the file's batches, caller's ``out``, the host codec
#: decodes the middle batch, slots, slot bytes).
CASES = {'one_batch_in_one_slot': (0, None, False, 2, 1 << 16),
         'several_batches': (2, None, False, 3, 200),
         'host_batch_between': (2, None, True, 2, 200),
         'out_c_order': (2, 'C', False, 3, 200),
         'out_f_order': (2, 'F', False, 3, 200)}


def _with_host_batch(monkeypatch, k):
    """Make the ``k``-th batch of every decode the host codec's, as
    ``_decode_runs`` yields a batch ``supported()`` declines."""
    real = tp._decode_runs

    def runs(reader, first_chunk, last_chunk, device):
        n0 = reader.chunk_bounds[first_chunk]
        for i, (pos, block) in enumerate(real(reader, first_chunk,
                                              last_chunk, device)):
            if i == k:
                a = np.searchsorted(reader.chunk_bounds, n0 + pos)
                b = np.searchsorted(reader.chunk_bounds,
                                    n0 + pos + block.shape[0])
                block = np.concatenate([reader._decompress_chunk(j)[1]
                                        for j in range(a, b)])
            yield pos, block
    monkeypatch.setattr(tp, '_decode_runs', runs)


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('dtype', DTYPES)
def test_to_array_through_the_ring_is_todays(tmp_path, monkeypatch, dtype,
                                              case):
    """``Reader.to_array`` with its blocks sent through a host ring gives
    the bytes today's CPU path gives and the source holds: in one batch
    inside one slot, in several batches whose slot edges cut rows, with a
    host-codec batch between two device batches, and into a caller's
    ``out`` in C and in F order."""
    batch, order, host_batch, n_slots, slot_bytes = CASES[case]
    T = 11
    arr = _source(dtype, 5 * T + 4)             # a ragged last chunk
    cbin, ch = _compressed(tmp_path, arr, T)
    r = mt.decompress(cbin, ch, device='cpu', batch_chunks=batch,
                      n_threads=3, quiet=True)
    try:
        if host_batch:
            _with_host_batch(monkeypatch, 1)
        today = r.to_array()
        ring = _host_ring(monkeypatch, n_slots, slot_bytes)
        out = None if order is None else np.full(arr.shape, 3, arr.dtype,
                                                 order=order)
        got = tp.decompress_to_array(r, out=out, device=r.device)
        assert out is None or got is out
        assert got.flags.writeable
        assert np.array_equal(_bits(got), _bits(today))
        assert np.array_equal(_bits(got), _bits(arr))
        assert not ring.lock.locked() and not _fetch_threads()
    finally:
        r.close()


# --- decode_batch and decompress_multi through the ring -------------------

def _decode_batch(readers, mesh):
    """Every chunk of the one reader through ``decode_batch``, as rows."""
    r = readers[0]
    parsed = [r.codec.parse(tp._read_payload(r, i))
              for i in range(r.n_chunks)]
    out = tp.DeviceBatchDecoder(r, r.device).decode_batch(
        parsed, r.chunk_bounds[1], mesh=mesh)
    return [out.reshape(-1, r.n_channels)]


BULK_CALLS = {'decode_batch': _decode_batch,
              'multi': lambda readers, mesh: mt.decompress_multi(
                  readers, mesh=mesh)}

#: case -> (call, probes, chunks a probe, ``batch_chunks``, mesh width,
#: probe 1's first chunk constant): ``decode_batch`` without a mesh and
#: over two devices; ``decompress_multi`` in one batch, in several, over
#: two devices whose shards each span two probes (3 probes x 2 chunks),
#: and with a probe whose first chunk's plane modes differ from reader
#: 0's (the merge declined: per-reader ``to_array``).
BULK = {'decode_batch': ('decode_batch', 1, 4, 0, None, False),
        'decode_batch_mesh2': ('decode_batch', 1, 4, 0, 2, False),
        'multi_one_batch': ('multi', 2, 4, 0, None, False),
        'multi_several_batches': ('multi', 2, 4, 2, None, False),
        'multi_mesh2_shards_span_probes': ('multi', 3, 2, 0, 2, False),
        'multi_first_chunk_differs': ('multi', 2, 4, 0, None, True)}


def _probes(tmp_path, dtype, T, n_probes, n_chunks, differs=False, **kw):
    """``n_probes`` sources of ``n_chunks`` chunks and their readers on
    the CPU device; with ``differs``, probe 1's first chunk is
    constant."""
    arrs, readers = [], []
    for p in range(n_probes):
        arr = _source(dtype, n_chunks * T, seed=p)
        if differs and p == 1:
            arr[:T] = arr[0]
        d = tmp_path / ('p%d' % p)
        d.mkdir()
        cbin, ch = _compressed(d, arr, T)
        arrs.append(arr)
        readers.append(mt.decompress(cbin, ch, device='cpu', quiet=True,
                                     **kw))
    return arrs, readers


@pytest.mark.parametrize('case', sorted(BULK))
@pytest.mark.parametrize('dtype', DTYPES)
def test_bulk_decodes_through_the_ring_are_todays(tmp_path, monkeypatch,
                                                  dtype, case):
    """``decode_batch`` and ``decompress_multi`` with their blocks sent
    through a host ring give the bytes the CPU device's path gives and
    the sources hold, in every result's shape and dtype."""
    call, n_probes, n_chunks, batch, width, differs = BULK[case]
    T = 11
    arrs, readers = _probes(tmp_path, dtype, T, n_probes, n_chunks,
                            differs, batch_chunks=batch, n_threads=3)
    mesh = None if width is None else chunk_mesh(['cpu'] * width)
    try:
        today = BULK_CALLS[call](readers, mesh)
        ring = _host_ring(monkeypatch, 3, 200)
        got = BULK_CALLS[call](readers, mesh)
        assert len(got) == len(today) == len(arrs)
        for g, t, arr in zip(got, today, arrs):
            assert g.shape == t.shape == arr.shape
            assert g.dtype == t.dtype and g.flags.writeable
            assert np.array_equal(_bits(g), _bits(t))
            assert np.array_equal(_bits(g), _bits(arr))
        assert not ring.lock.locked() and not _fetch_threads()
    finally:
        for r in readers:
            r.close()


@pytest.mark.parametrize('call', sorted(BULK_CALLS))
def test_every_decoded_byte_is_staged(tmp_path, monkeypatch, call):
    """Every byte ``decode_batch`` and ``decompress_multi`` decode
    reaches the host through the ring (``transfer.d2h_staged_bytes``),
    in one fetch under ``decode.to_host``: the one batch's, which
    ``decompress_multi`` fetches through ``decode_batch``."""
    T = 11
    n_probes = 1 if call == 'decode_batch' else 2
    arrs, readers = _probes(tmp_path, 'int16', T, n_probes, 4)
    _host_ring(monkeypatch, 2, 64)
    trace.enable_tracing()
    try:
        trace.reset_stats()
        for got, arr in zip(BULK_CALLS[call](readers, None), arrs):
            assert np.array_equal(got, arr)
        counters = trace.counter_stats()
        spans = {k: v[0] for k, v in trace.phase_stats().items()}
    finally:
        trace.enable_tracing(False)
        for r in readers:
            r.close()
    assert counters.get('transfer.d2h_staged_bytes') == \
        sum(a.nbytes for a in arrs)
    assert 'transfer.d2h_bytes' not in counters
    assert spans['decode.to_host'] == 1


def _corrupt_chunk(cbin, ch, idx):
    """Flip a byte in the middle of chunk ``idx``'s payload."""
    r = mt.decompress(cbin, ch, device='none', quiet=True)
    o0, o1 = r.chunk_offsets[idx], r.chunk_offsets[idx + 1]
    r.close()
    data = bytearray(cbin.read_bytes())
    data[(o0 + o1) // 2] ^= 0x5A
    cbin.write_bytes(bytes(data))


@pytest.mark.parametrize('fault', ['corrupt_second_batch',
                                   'read_only_out'])
def test_an_error_leaves_no_copy_running_and_the_ring_free(
        tmp_path, monkeypatch, fault):
    """A decode that raises in its second batch (a corrupt payload: the
    codec's IOError), or a copy into the result that fails, leaves no
    copy running and the ring's lock free: the next call succeeds."""
    T = 11
    arr = _source('int16', 6 * T)
    cbin, ch = _compressed(tmp_path, arr, T)
    clean = cbin.read_bytes()
    ring = _host_ring(monkeypatch, 2, 64)
    out = None
    if fault == 'corrupt_second_batch':
        _corrupt_chunk(cbin, ch, 3)
        error = IOError
    else:
        out = np.empty(arr.shape, arr.dtype)
        out.flags.writeable = False
        error = ValueError
    r = mt.decompress(cbin, ch, device='cpu', batch_chunks=2, n_threads=3,
                      quiet=True)
    try:
        with pytest.raises(error):
            tp.decompress_to_array(r, out=out, device=r.device)
    finally:
        r.close()
    assert not ring.lock.locked() and not _fetch_threads()
    cbin.write_bytes(clean)
    r = mt.decompress(cbin, ch, device='cpu', batch_chunks=2, n_threads=3,
                      quiet=True)
    try:
        assert np.array_equal(tp.decompress_to_array(r, device=r.device),
                              arr)
    finally:
        r.close()


def test_staged_bytes_are_counted(tmp_path, monkeypatch):
    """``transfer.d2h_staged_bytes`` counts the bytes that went through
    the ring, and no other: a host-codec batch is not staged, and a host
    tensor crosses no link (``transfer.d2h_bytes`` stays 0).
    ``decode.to_host`` spans each staged fetch, ``decode.assemble`` the
    result's allocation and the host batch's copy."""
    T = 11
    arr = _source('int16', 6 * T)
    cbin, ch = _compressed(tmp_path, arr, T)
    _host_ring(monkeypatch, 2, 64)
    _with_host_batch(monkeypatch, 1)
    r = mt.decompress(cbin, ch, device='cpu', batch_chunks=2, quiet=True)
    trace.enable_tracing()
    try:
        trace.reset_stats()
        assert np.array_equal(r.to_array(), arr)
        counters = trace.counter_stats()
        spans = {k: v[0] for k, v in trace.phase_stats().items()}
    finally:
        trace.enable_tracing(False)
        r.close()
    assert counters.get('transfer.d2h_staged_bytes') == 4 * T * C * 2
    assert 'transfer.d2h_bytes' not in counters
    # Two staged fetches; the result allocated once, the host batch
    # copied once.
    assert spans['decode.to_host'] == 2 and spans['decode.assemble'] == 2


# --- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', torch.cuda.current_device())


#: 385 channels at 30 kHz, int16: 23.1 MB a chunk, so that a batch of 3
#: crosses several 32-MiB slots with edges inside rows.
CARD_T, CARD_C = 30000, 385


@pytest.fixture(scope='module')
def card_file(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    tmp = tmp_path_factory.mktemp('card')
    arr = _source('int16', 7 * CARD_T + 1234, seed=3, channels=CARD_C)
    return arr, _compressed(tmp, arr, CARD_T, device='cuda')


@pytest.mark.chip
def test_card_to_array_equals_the_source_and_to_tensor(card_file):
    _card()
    arr, (cbin, ch) = card_file
    r = mt.decompress(cbin, ch, device='cuda', batch_chunks=3, quiet=True)
    try:
        got = r.to_array()
        assert got.flags.writeable and got.flags.c_contiguous
        assert np.array_equal(got, arr)
        assert np.array_equal(r.to_tensor().cpu().numpy(), arr)
        assert np.array_equal(r.to_array(2, 5), arr[2 * CARD_T:6 * CARD_T])
    finally:
        r.close()


@pytest.mark.chip
def test_card_ring_is_allocated_once(card_file):
    dev = _card()
    arr, (cbin, ch) = card_file
    ptrs = []
    for _ in range(2):
        r = mt.decompress(cbin, ch, device='cuda', batch_chunks=3,
                          quiet=True)
        try:
            assert np.array_equal(r.to_array(), arr)
        finally:
            r.close()
        ring = tp._fetch_ring(dev)
        assert all(s.is_pinned() for s in ring.slots)
        assert [s.numel() for s in ring.slots] == \
            [tp.FETCH_SLOT_BYTES] * tp.FETCH_SLOTS
        ptrs.append([s.data_ptr() for s in ring.slots])
    assert ptrs[0] == ptrs[1]


@pytest.mark.chip
def test_card_staged_bytes_are_the_decoded_bytes(card_file):
    _card()
    arr, (cbin, ch) = card_file
    mt.reset_launch_counts()
    r = mt.decompress(cbin, ch, device='cuda', batch_chunks=3, quiet=True)
    trace.enable_tracing()
    try:
        trace.reset_stats()
        assert np.array_equal(r.to_array(), arr)
        counters = trace.counter_stats()
        spans = {k: v[0] for k, v in trace.phase_stats().items()}
    finally:
        trace.enable_tracing(False)
        r.close()
    assert mt.launch_counts()['host_fallback_chunks'] == 0, spans
    assert counters['transfer.d2h_staged_bytes'] == arr.nbytes, counters
    assert counters['transfer.d2h_bytes'] >= arr.nbytes, counters
    # One staged fetch a batch staged on the card, the result allocated
    # once.
    assert spans['decode.to_host'] == spans['decode.pack'] >= 3, spans
    assert spans['decode.assemble'] == 1, spans


@pytest.mark.chip
@pytest.mark.parametrize('call', ['decode_batch', 'decompress_multi'])
def test_card_bulk_decodes_stage_every_byte(card_file, call):
    """``decode_batch`` (six chunks, one batch) and ``decompress_multi``
    (two readers of the file, chunks 0-5, batches of three chunks) fetch
    every decoded byte through the card's ring."""
    _card()
    arr, (cbin, ch) = card_file
    want = arr[:6 * CARD_T]
    readers = [mt.decompress(cbin, ch, device='cuda', batch_chunks=3,
                             quiet=True) for _ in range(2)]
    trace.enable_tracing()
    try:
        trace.reset_stats()
        if call == 'decode_batch':
            r = readers[0]
            parsed = [r.codec.parse(tp._read_payload(r, i))
                      for i in range(6)]
            got = [tp.DeviceBatchDecoder(r, r.device).decode_batch(
                parsed, CARD_T).reshape(want.shape)]
        else:
            got = mt.decompress_multi(readers, last_chunk=5)
        counters = trace.counter_stats()
    finally:
        trace.enable_tracing(False)
        for r in readers:
            r.close()
    assert all(np.array_equal(g, want) for g in got)
    nbytes = len(got) * want.nbytes
    assert counters['transfer.d2h_staged_bytes'] == nbytes, counters
    assert counters['transfer.d2h_bytes'] >= nbytes, counters


@pytest.mark.chip
def test_card_two_threads_read_two_files_at_once(card_file, tmp_path):
    _card()
    arr, (cbin, ch) = card_file
    arr2 = _source('int16', 4 * CARD_T, seed=5, channels=CARD_C)
    cbin2, ch2 = _compressed(tmp_path, arr2, CARD_T, device='cuda')
    results = {}

    def read(key, c, s):
        r = mt.decompress(c, s, device='cuda', batch_chunks=2, quiet=True)
        try:
            results[key] = [r.to_array() for _ in range(3)]
        finally:
            r.close()

    threads = [threading.Thread(target=read, args=(k, c, s))
               for k, c, s in ((1, cbin, ch), (2, cbin2, ch2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert all(np.array_equal(a, arr) for a in results[1])
    assert all(np.array_equal(a, arr2) for a in results[2])
