"""Multi-host chunk-range compression and part merging.

Chunks are fully independent (the format's core invariant), so the
multi-host parallelization of ``compress`` needs no communication at
all: each host compresses a disjoint chunk range of the shared raw file
into a standalone part (``Writer.write(first_chunk=..., last_chunk=...)``,
itself a valid ``.cbin``/``.ch`` pair of that sample range), and one
host concatenates the parts — rebasing the offset/bounds tables and
streaming the global SHA1 during the byte copy, exactly like the
reference's ordered batch write-back (mtscomp.py:474-483) lifted from
threads to hosts. The same mechanism is the crash-resume story: a
failed run reruns only the missing ranges (SURVEY §5 checkpoint/resume;
each part's own SHA1 lets the merge verify surviving parts first).

This is plain host code by design (the reference's analogue is its
ThreadPool loop); the batched device encode lives in
``parallel.pipeline`` and composes with this: each host drives its own
GPU over its own range when the caller names a device.
"""

import hashlib
import json
from pathlib import Path

import numpy as np

from ..format import decode_identity, read_cmeta, write_cmeta
from ..utils.misc import logger


def plan_ranges(n_chunks, n_parts):
    """Split ``n_chunks`` into ``n_parts`` contiguous [first, last) ranges."""
    n_parts = min(max(1, int(n_parts)), n_chunks)
    edges = np.linspace(0, n_chunks, n_parts + 1).round().astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def compress_range(path, out, outmeta, first_chunk, last_chunk,
                   sample_rate=None, n_channels=None, dtype=None, **kwargs):
    """Compress chunks ``[first_chunk, last_chunk)`` of a raw file.

    One host's share of a multi-host compress. The output is a
    standalone valid compressed file of that sample range whose sidecar
    records ``part: [first, last]``. Returns the part's size ratio.
    """
    from ..api import Writer
    w = Writer(**kwargs)
    try:
        w.open(path, sample_rate=sample_rate, n_channels=n_channels,
               dtype=dtype)
        return w.write(out, outmeta, first_chunk=first_chunk,
                       last_chunk=last_chunk)
    finally:
        w.close()


def _stream_file(path, consume):
    """Feed a file's bytes through ``consume(buf)``; returns its SHA1 hex."""
    sha = hashlib.sha1()
    with open(path, 'rb') as f:
        while True:
            buf = f.read(1 << 22)
            if not buf:
                break
            sha.update(buf)
            consume(buf)
    return sha.hexdigest()


def merge_parts(parts, out, outmeta, expected_n_chunks=None,
                decoded_hash=True):
    """Concatenate compressed parts into one ``.cbin`` + ``.ch``.

    ``parts``: ordered list of ``(cbin_path, ch_path)`` pairs produced
    by :func:`compress_range` (or any compressed files with identical
    parameters). Each part's bytes are verified against its own
    ``sha1_compressed`` while being copied; the merged sidecar gets the
    global ``sha1_compressed`` computed during the copy.

    With ``decoded_hash=True`` (default) each part is also DECODED
    during the merge and the merged sidecar gets a real
    ``sha1_uncompressed`` — the hash of the raw sample stream, equal to
    what one full ``compress`` of the source would have recorded
    (reference dual-SHA1 semantics, mtscomp.py:341-358) — so
    ``mtsverify --deep`` and ``check()`` validate merged files
    end-to-end. Each decoded part is cross-checked against its own
    ``sha1_uncompressed`` when present, catching parts whose sidecar
    parameters do not describe their payload. Only byte-exact formats
    qualify (integer dtypes, ``float_bitcast`` files); legacy-domain
    float files get ``sha1_uncompressed: None`` (their decoded bytes
    legitimately differ from the raw file's — the ``chop`` precedent
    for hash-less but valid sidecars). ``decoded_hash=False`` skips the
    decode pass (always ``None``).

    Coverage is validated: ``part`` ranges must be contiguous from 0
    and, when the sidecars record the source's total chunk count
    (``part_of``, written by ranged writes) or ``expected_n_chunks`` is
    given, the parts must cover ALL of it — a merge missing its tail
    parts must not produce a sidecar indistinguishable from a complete
    recording. The merged ``.cbin`` is written to a temp file and
    renamed on success, so a failed merge leaves no partial output.
    Returns the merged cmeta dict.
    """
    assert parts, "nothing to merge"
    metas = [read_cmeta(ch) for _, ch in parts]
    first = metas[0]
    # Decode identity first: one merged sidecar describes every chunk,
    # so parts whose payloads decode differently (incl. the v2
    # extensions time_diff_order/float_bitcast, absent = default) must
    # never merge — the mismatched chunks would decode to silently
    # wrong samples. The shared predicate lives in format.py so new
    # sidecar extensions cannot go stale here.
    ident0 = decode_identity(first)
    check_keys = ('comp_level', 'sample_rate', 'version')
    for m in metas[1:]:
        ident = decode_identity(m)
        if ident != ident0:
            k = next(k for k in ident0 if ident[k] != ident0[k])
            raise ValueError("part parameter mismatch: %s (%r != %r)"
                             % (k, ident[k], ident0[k]))
        for k in check_keys:
            if m.get(k) != first.get(k):
                raise ValueError("part parameter mismatch: %s (%r != %r)"
                                 % (k, m.get(k), first.get(k)))
    next_chunk = 0
    total = expected_n_chunks
    for m in metas:
        pr = m.get('part')
        if pr is not None:
            if pr[0] != next_chunk:
                raise ValueError("part ranges not contiguous: expected "
                                 "chunk %d, got %d" % (next_chunk, pr[0]))
            if pr[1] - pr[0] != len(m['chunk_bounds']) - 1:
                # Never trust the declared range over the actual chunk
                # count: a mismatch would make the coverage guard pass
                # on a silently truncated part.
                raise ValueError(
                    "part declares chunks [%d, %d) but contains %d "
                    "chunks" % (pr[0], pr[1], len(m['chunk_bounds']) - 1))
            next_chunk = pr[1]
        else:
            next_chunk += len(m['chunk_bounds']) - 1
        part_of = m.get('part_of')
        if part_of is not None:
            if total is not None and total != part_of:
                raise ValueError("parts disagree on the source chunk "
                                 "count (%d != %d)" % (part_of, total))
            total = part_of
    if total is not None and next_chunk != total:
        raise ValueError("parts cover %d of %d source chunks — refusing "
                         "to merge an incomplete set" % (next_chunk, total))
    if total is None:
        # Hand-assembled merge of plain (non-ranged) files: nothing
        # records the source's chunk count, so a missing middle/tail
        # file would produce a sidecar indistinguishable from a
        # complete recording. Warn loudly; callers that know the count
        # should pass expected_n_chunks (mtsmerge: --expect-chunks).
        logger.warning(
            "merge_parts: no part provenance in any sidecar and no "
            "expected_n_chunks given — cannot verify the %d merged "
            "chunks cover the whole source recording.", next_chunk)

    out = Path(out)
    out.parent.mkdir(exist_ok=True, parents=True)
    tmp = out.with_name(out.name + '.merging')
    sha1_all = hashlib.sha1()
    # The merged decoded hash only equals the raw source's hash when
    # decode is byte-exact (integers, bitcast floats); legacy-domain
    # float decodes are allclose-only, so their sidecar keeps None.
    exact = (np.dtype(first['dtype']).kind in 'iu'
             or bool(first.get('float_bitcast', False)))
    sha1_raw = hashlib.sha1() if (decoded_hash and exact) else None
    bounds = [0]
    offsets = [0]
    try:
        with open(tmp, 'wb') as fb:
            for (cbin, ch), m in zip(parts, metas):
                size = 0

                def consume(buf):
                    nonlocal size
                    sha1_all.update(buf)
                    fb.write(buf)
                    size += len(buf)

                part_sha = _stream_file(cbin, consume)
                if m.get('sha1_compressed') and \
                        part_sha != m['sha1_compressed']:
                    raise IOError("part %s does not match its "
                                  "sha1_compressed (corrupt or stale "
                                  "part)." % cbin)
                if size != m['chunk_offsets'][-1]:
                    raise IOError("part %s is %d bytes, sidecar says %d."
                                  % (cbin, size, m['chunk_offsets'][-1]))
                if sha1_raw is not None:
                    _hash_decoded_part(cbin, ch, sha1_raw, m)
                base_b, base_o = bounds[-1], offsets[-1]
                bounds.extend(base_b + b for b in m['chunk_bounds'][1:])
                offsets.extend(base_o + o for o in m['chunk_offsets'][1:])
        tmp.replace(out)
    finally:
        tmp.unlink(missing_ok=True)

    cmeta = dict(first)
    cmeta.pop('part', None)
    cmeta.pop('part_of', None)
    cmeta.pop('streaming', None)   # merged output is a complete file
    cmeta['chunk_bounds'] = bounds
    cmeta['chunk_offsets'] = offsets
    cmeta['shape'] = (bounds[-1], int(first['n_channels']))
    cmeta['sha1_compressed'] = sha1_all.hexdigest()
    cmeta['sha1_uncompressed'] = (sha1_raw.hexdigest()
                                  if sha1_raw is not None else None)
    write_cmeta(outmeta, cmeta)
    logger.info("Merged %d parts into %s (%d chunks, %d samples).",
                len(parts), out, len(bounds) - 1, bounds[-1])
    return cmeta


def _hash_decoded_part(cbin, ch, sha_all, m):
    """Decode one part chunk-by-chunk, feeding its raw sample bytes into
    the merged ``sha1_uncompressed`` accumulator; cross-check against
    the part's own recorded decoded hash when it has one (catches a
    part whose sidecar parameters do not describe its payload — the
    payload-level CRCs cannot see that)."""
    from ..api import Reader
    sha_part = hashlib.sha1()
    r = Reader(quiet=True, device='none')
    r.open(cbin, ch)
    try:
        for i, start, length in r.iter_chunks():
            chunk = np.ascontiguousarray(r.read_chunk(i, start, length))
            sha_part.update(chunk)
            sha_all.update(chunk)
    finally:
        r.close()
    want = m.get('sha1_uncompressed')
    if want and sha_part.hexdigest() != want:
        raise IOError("part %s decodes to data that does not match its "
                      "sha1_uncompressed (corrupt part, or a sidecar "
                      "that does not describe its payload)." % cbin)


def part_paths(out, first, last, part_dir=None):
    """Canonical part file names for chunk range [first, last)."""
    part_dir = Path(part_dir) if part_dir else Path(out).parent
    cbin = part_dir / ('part_%06d_%06d.cbin' % (first, last))
    return cbin, cbin.with_suffix('.ch')


def compress_part_rank(path, out, rank, n_parts, sample_rate=None,
                       n_channels=None, dtype=None, part_dir=None,
                       **kwargs):
    """Compress one host's share of an ``n_parts``-way split.

    Every host of a cluster runs the same command with its own
    ``rank``; the range plan is a pure function of the source geometry,
    so the hosts need no coordination beyond shared storage. Part files
    get the canonical names ``compress_multihost`` uses (valid existing
    parts are reused — rerunning a crashed rank is a no-op for finished
    work); one host finally merges with ``mtsmerge part_*.cbin``.
    """
    from ..api import Writer
    # This writer only counts the chunks: it needs no device.
    w = Writer(**dict(kwargs, check_after_compress=False, device='none'))
    try:
        w.open(path, sample_rate=sample_rate, n_channels=n_channels,
               dtype=dtype)
        n_chunks = w.n_chunks
    finally:
        w.close()
    ranges = plan_ranges(n_chunks, n_parts)
    if not 0 <= int(rank) < len(ranges):
        raise ValueError("rank %d out of range: %d chunks plan into %d "
                         "parts" % (rank, n_chunks, len(ranges)))
    first, last = ranges[int(rank)]
    cbin, ch = part_paths(out, first, last, part_dir)
    cbin.parent.mkdir(exist_ok=True, parents=True)
    if cbin.exists() and ch.exists() and _part_valid(cbin, ch):
        logger.info("Rank %d: valid part %s already exists.", rank, cbin)
        return cbin, ch
    compress_range(path, cbin, ch, first, last, sample_rate=sample_rate,
                   n_channels=n_channels, dtype=dtype, **kwargs)
    return cbin, ch


def _compress_range_task(task):
    """Picklable worker entry for process-parallel part compression."""
    (path, cbin, ch, first, last, sample_rate, n_channels, dtype,
     kwargs) = task
    compress_range(path, cbin, ch, first, last, sample_rate=sample_rate,
                   n_channels=n_channels, dtype=dtype, **kwargs)
    return str(cbin)


def compress_multihost(path, out, outmeta, n_parts, part_dir=None,
                       n_workers=1, sample_rate=None, n_channels=None,
                       dtype=None, **kwargs):
    """Executable spec (and local runner) of the multi-host split.

    Plans ranges, compresses each — on a cluster one range per host; here
    sequentially, or with ``n_workers > 1`` in parallel **OS processes**
    (spawned, fully isolated interpreters: the true multi-host execution
    model exercised on one machine, sharing only the filesystem exactly
    as cluster hosts share storage) — then merges. Doubles as a
    resumable compress: parts that already exist with a valid sidecar
    are reused, so rerunning after a crash only redoes missing ranges.
    """
    from ..api import Writer
    # This writer only counts the chunks: it needs no device.
    w = Writer(**dict(kwargs, check_after_compress=False, device='none'))
    try:
        w.open(path, sample_rate=sample_rate, n_channels=n_channels,
               dtype=dtype)
        n_chunks = w.n_chunks
    finally:
        w.close()
    part_dir = Path(part_dir) if part_dir else Path(out).parent
    part_dir.mkdir(exist_ok=True, parents=True)
    ranges = plan_ranges(n_chunks, n_parts)
    parts, todo = [], []
    for first, last in ranges:
        cbin, ch = part_paths(out, first, last, part_dir)
        if not (cbin.exists() and ch.exists() and _part_valid(cbin, ch)):
            todo.append((path, cbin, ch, first, last, sample_rate,
                         n_channels, dtype, kwargs))
        else:
            logger.info("Reusing existing valid part %s.", cbin)
        parts.append((cbin, ch))
    if len(todo) > 1 and n_workers and int(n_workers) > 1:
        import concurrent.futures
        import multiprocessing
        nw = min(int(n_workers), len(todo))
        # Split the encoder thread budget across concurrent workers so
        # N workers don't each spawn cpu_count C++ threads.
        nt = kwargs.get('n_threads') or multiprocessing.cpu_count()
        kw = dict(kwargs, n_threads=max(1, int(nt) // nw))
        # Spawned workers stay on the host codec unless the caller named
        # a device: the port's default ('cuda') and 'auto' would have N
        # fresh processes each open a CUDA context on one card, which
        # never pays (the device route batches internally). An explicit
        # device ('cuda', 'cuda:N', 'cpu') is honored as given. The
        # 'spawn' context below is required for that: a forked child
        # cannot re-initialise CUDA.
        if kw.get('device') in (None, 'auto'):
            kw['device'] = 'none'
        todo = [t[:-1] + (kw,) for t in todo]
        ctx = multiprocessing.get_context('spawn')
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=nw, mp_context=ctx) as pool:
            for done in pool.map(_compress_range_task, todo):
                logger.info("Part %s written.", done)
    else:
        for task in todo:
            _compress_range_task(task)
    return merge_parts(parts, out, outmeta, expected_n_chunks=n_chunks)


def _part_valid(cbin, ch):
    """Whether an existing part's bytes match its sidecar SHA1."""
    try:
        m = read_cmeta(ch)
    except (OSError, ValueError, AssertionError,
            json.JSONDecodeError):  # pragma: no cover - unreadable sidecar
        return False
    want = m.get('sha1_compressed')
    if not want:
        return False
    return _stream_file(cbin, lambda buf: None) == want
