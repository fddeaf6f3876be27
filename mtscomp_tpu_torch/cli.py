"""Command-line entry points: ``mtscomp``, ``mtsdecomp``, ``mtsdesc``,
``mtschop``, ``mtsverify``, ``mtsmerge``, ``mtsrecompress``.

The port's copy of ``mtscomp_tpu/cli.py``. No console script is
installed for it: run a command as ``python -m mtscomp_tpu_torch.cli
<command> [arguments]`` (:func:`main`), or call its function with the
argument list.

Flag surface matches the reference CLIs (mtscomp.py:1000-1179), including
the shared ``-nc/--no-check``, ``-v/--debug``, ``-p/--cpus`` options, the
``--set-default`` persistence flag, and the traceback-hiding exception
hook, plus ``-a/--algorithm`` to select the rANS format (v2) and
``--device`` with the port's device names.
"""

import argparse
import re
import sys
from pathlib import Path

import numpy as np

from .api import Reader, compress, decompress
from .config import read_config, write_config
from .device import CONFIG_DEVICES
from .utils.misc import add_default_handler, logger


def exception_handler(exception_type, exception, traceback,
                      debug_hook=sys.excepthook):  # pragma: no cover
    """Hide tracebacks unless -v/--debug was passed.

    Diagnostics go to stderr: stdout may be a binary sample stream
    (``mtsdecomp -o -``) that a consumer is parsing.
    """
    if '--debug' in sys.argv or '-v' in sys.argv:
        debug_hook(exception_type, exception, traceback)
    else:
        print("%s: %s" % (exception_type.__name__, exception),
              file=sys.stderr)


def _shared_options(parser):
    parser.add_argument('-nc', '--no-check', action='store_false',
                        help='no check')
    parser.add_argument('-v', '--debug', action='store_true', help='verbose')
    parser.add_argument('-p', '--cpus', type=int,
                        help='number of CPUs to use')


def _device_name(val):
    """argparse type of ``--device``: one of the configuration's names."""
    if not re.fullmatch(r'auto|none|cpu|cuda(:\d+)?', val):
        raise argparse.ArgumentTypeError(
            "invalid device %r (choose from %s)" % (val, CONFIG_DEVICES))
    return val


def _device_option(parser):
    parser.add_argument('--device', type=_device_name, metavar='DEVICE',
                        help="where ans files are coded: 'cuda' (the "
                             "default; the GPU kernels, 'cuda:N' picks a "
                             "card, an error without a GPU), 'cpu' (the "
                             "kernels' plain PyTorch versions), 'none' "
                             "(the host codec only: use on machines "
                             "without a GPU) or 'auto' ('cuda' where a "
                             "GPU is visible, else 'none'). All write "
                             "and read the same bytes")


def _parse_diff_order(val):
    """CLI '--diff-order' string -> config value (None passes through
    so the config merge falls back to defaults)."""
    if val is None or val == 'auto':
        return val
    return int(val)


def _parse_spatial(val):
    """CLI '--spatial-diff' string -> config value (None passes
    through so the config merge falls back to defaults)."""
    if val is None or val == 'auto':
        return val
    return bool(int(val))


def _args_to_config(parser, args, compress=True):
    pargs = parser.parse_args(args)
    # no_check stays True when the flag was NOT given => defer to defaults.
    check_after = None if pargs.no_check is True else False
    kwargs = dict(n_threads=pargs.cpus,
                  device=getattr(pargs, 'device', None))
    if compress:
        kwargs.update(
            sample_rate=pargs.sample_rate,
            n_channels=pargs.n_channels,
            dtype=pargs.dtype.strip() if pargs.dtype else pargs.dtype,
            chunk_duration=pargs.chunk,
            check_after_compress=check_after,
            algorithm=getattr(pargs, 'algorithm', None),
            ans_table_mode=getattr(pargs, 'ans_table_mode', None),
            time_diff_order=_parse_diff_order(
                getattr(pargs, 'time_diff_order', None)),
            do_spatial_diff=_parse_spatial(
                getattr(pargs, 'do_spatial_diff', None)),
            transform_adapt=getattr(pargs, 'transform_adapt', None),
        )
    else:
        kwargs.update(check_after_decompress=check_after)
    return pargs, read_config(**kwargs)


# -- mtscomp -------------------------------------------------------------------

def _compress_stdin(out, outmeta, config):
    """Stream raw samples from stdin into a compressed recording."""
    from .stream import StreamWriter
    cfg = dict(config)
    sr = cfg.pop('sample_rate', None)
    nc = cfg.pop('n_channels', None)
    dt = cfg.pop('dtype', None)
    if not (sr and nc and dt):
        raise ValueError("Compressing from stdin requires -d, -s and -n "
                         "(there is no file to infer them from).")
    dtype = np.dtype(dt)
    nc = int(nc)
    row = nc * dtype.itemsize
    cfg.pop('check_after_compress', None)   # the input is gone at EOF
    # The context manager supplies the abort semantics: an error mid-
    # stream (including the trailing-bytes one below) leaves no
    # half-written outputs behind.
    with StreamWriter(out, outmeta, sample_rate=sr, n_channels=nc,
                      dtype=dtype, **cfg) as w:
        stream = sys.stdin.buffer
        leftover = b''
        while True:
            block = stream.read(1 << 20)
            if not block:
                break
            data = leftover + block
            n = len(data) // row
            leftover = data[n * row:]
            if n:
                w.append(np.frombuffer(data[:n * row],
                                       dtype=dtype).reshape(n, nc))
        if leftover:
            raise ValueError(
                "stdin ended mid-sample: %d trailing bytes do not form "
                "a full %d-channel row (%d bytes/row)."
                % (len(leftover), nc, row))
        ratio = w.close()
    logger.info("Wrote %s from stdin (%d samples, -%.3f%%).",
                out, w.n_samples, 100 - 100 * ratio)


def mtscomp_parser():
    parser = argparse.ArgumentParser(description='Compress a raw binary file.')
    parser.add_argument('path', type=str,
                        help="input path of a raw binary file, or '-' to "
                             "stream raw samples from stdin")
    parser.add_argument('out', type=str, nargs='?',
                        help='output path of the compressed binary file (.cbin)')
    parser.add_argument('outmeta', type=str, nargs='?',
                        help='output path of the compression metadata JSON file (.ch)')
    parser.add_argument('-d', '--dtype', type=str, help='data type')
    parser.add_argument('-s', '--sample-rate', type=float, help='sample rate')
    parser.add_argument('-n', '--n-channels', type=int,
                        help='number of channels')
    parser.add_argument('-c', '--chunk', type=int, help='chunk duration')
    parser.add_argument('-a', '--algorithm', type=str,
                        help="compression algorithm: 'zlib' (legacy) or "
                             "'ans' (lane-parallel rANS, coded on the "
                             "GPU)")
    parser.add_argument('--ans-tables', type=str, dest='ans_table_mode',
                        choices=('plane', 'segment'),
                        help="ans frequency tables: clustered per "
                             "channel segment ('segment', default: "
                             "better ratio on channel-heterogeneous "
                             "bands, e.g. LFP) or one per byte plane "
                             "('plane')")
    parser.add_argument('--diff-order', type=str, dest='time_diff_order',
                        choices=('1', '2', 'auto'),
                        help="ans time-prediction order: 'auto' "
                             "(default) probes the first chunk and "
                             "keeps the winner — order 2 compresses "
                             "oversampled/LFP-like bands far better; "
                             "'1' is the reference transform")
    parser.add_argument('--spatial-diff', type=str, dest='do_spatial_diff',
                        choices=('0', '1', 'auto'),
                        help="channel-axis diff after the time diff: "
                             "'auto' (default) probes the first chunk "
                             "of ans files and keeps it only when it "
                             "wins (channel-correlated bands: smooth "
                             "LFP fields, common-mode artifacts); '0' "
                             "is the reference default, '1' forces it")
    parser.add_argument('--adapt', type=int, nargs='?', const=30,
                        dest='transform_adapt', metavar='N',
                        help="re-probe the transform every N chunks "
                             "(default 30 when the flag is given "
                             "bare; ans only): each window leader is "
                             "probed over the order x spatial grid and "
                             "its choice is stamped per chunk, so "
                             "recordings whose statistics drift (e.g. "
                             "LFP onset mid-file) keep the best "
                             "transform throughout")
    parser.add_argument('--range', type=str, dest='chunk_range',
                        help='compress only chunks FIRST:LAST (exclusive) '
                             'into a standalone part file; merge parts '
                             'with mtsmerge (multi-host / resumable '
                             'compression)')
    parser.add_argument('--parts', type=int, dest='n_parts',
                        help='split the chunk range into N parts '
                             'compressed in parallel worker processes '
                             '(resumable: valid existing parts are '
                             'reused), then merge')
    parser.add_argument('--workers', type=int, dest='n_workers',
                        help='worker processes for --parts '
                             '(default: number of parts)')
    parser.add_argument('--rank', type=int, dest='rank',
                        help='with --parts N: compress only this '
                             "host's part (0-based) — each host of a "
                             'cluster runs the same command with its '
                             'own --rank, then one host runs mtsmerge '
                             'on the part files')
    _shared_options(parser)
    _device_option(parser)
    parser.add_argument('--set-default', action='store_true',
                        help='set the specified parameters as the default')
    return parser


def mtscomp(args=None):
    """Compress a file."""
    sys.excepthook = exception_handler
    parser = mtscomp_parser()
    pargs, config = _args_to_config(parser, args or sys.argv[1:], compress=True)
    add_default_handler('DEBUG' if pargs.debug else 'INFO')
    if pargs.set_default:
        write_config(**config)
    if pargs.rank is not None and not pargs.n_parts:
        raise ValueError("--rank requires --parts N (every host passes "
                         "the same part count plus its own rank).")
    if pargs.rank is not None and pargs.n_workers:
        # Mirror the --range mutual-exclusion guard: each rank
        # compresses exactly one part, so --workers silently doing
        # nothing would mislead.
        raise ValueError("--workers has no effect with --rank (each "
                         "rank compresses exactly one part); drop "
                         "--workers, or drop --rank to run all parts "
                         "on this host.")
    if pargs.chunk_range and (pargs.n_parts or pargs.n_workers
                              or pargs.rank is not None):
        raise ValueError("--range and --parts/--workers/--rank are "
                         "mutually exclusive: --range compresses ONE "
                         "explicit chunk range.")
    if pargs.path == '-':
        # Shell-pipeline streaming: `acquisition | mtscomp - out.cbin
        # out.ch -d int16 -s 30000 -n 385` compresses as samples
        # arrive (StreamWriter), byte-identical to compressing the
        # finished file.
        if (pargs.chunk_range or pargs.n_parts
                or pargs.rank is not None):
            raise ValueError("stdin input cannot be combined with "
                             "--range/--parts/--rank (streams have no "
                             "random access to split).")
        if not (pargs.out and pargs.outmeta):
            raise ValueError("Compressing from stdin requires explicit "
                             "out and outmeta paths.")
        _compress_stdin(pargs.out, pargs.outmeta, config)
        return
    if pargs.chunk_range:
        from .parallel.distributed import compress_range
        if not (pargs.out and pargs.outmeta):
            raise ValueError("--range requires explicit out/outmeta paths "
                             "(parts must not shadow the merged file).")
        first, last = (int(x) for x in pargs.chunk_range.split(':'))
        compress_range(pargs.path, pargs.out, pargs.outmeta, first, last,
                       **config)
        return
    if pargs.n_parts:
        from .io_host import default_compressed_paths
        from .parallel.distributed import (compress_multihost,
                                           compress_part_rank)
        out, outmeta = default_compressed_paths(
            pargs.path, pargs.out, pargs.outmeta)
        if pargs.rank is not None:
            compress_part_rank(pargs.path, out, pargs.rank,
                               pargs.n_parts, **config)
            return
        if pargs.device is None:
            # Not named on the command line: leave the key out, so that
            # the parallel workers keep to the host codec
            # (compress_multihost) and everything else reads the
            # configured default as usual.
            config.pop('device', None)
        compress_multihost(pargs.path, out, outmeta,
                           n_parts=pargs.n_parts,
                           n_workers=pargs.n_workers or pargs.n_parts,
                           **config)
        return
    compress(pargs.path, pargs.out, pargs.outmeta, **config)


# -- mtsdecomp -----------------------------------------------------------------

def mtsdecomp_parser():
    parser = argparse.ArgumentParser(
        description='Decompress a raw binary file.')
    parser.add_argument('cdata', type=str,
                        help='path to the input compressed binary file (.cbin)')
    parser.add_argument('cmeta', type=str, nargs='?',
                        help='path to the input compression metadata JSON file (.ch)')
    parser.add_argument('-o', '--out', type=str, nargs='?',
                        help='path to the output decompressed file (.bin)')
    parser.add_argument('--overwrite', '-f', action='store_true',
                        help='overwrite existing output')
    parser.add_argument('--samples', type=str, default=None,
                        metavar='A:B',
                        help='export only samples [A, B) (random access '
                             'decode of just the covering chunks; the '
                             'whole-file hash checks do not apply)')
    parser.add_argument('--channels', type=str, default=None,
                        metavar='LIST',
                        help='export only these channels, in this order '
                             '(comma-separated indices and A:B ranges, '
                             'e.g. "7,100:104"); on ans files the entropy '
                             'stage decodes only the channel groups '
                             'covering the selection; the whole-file '
                             'hash checks do not apply')
    _shared_options(parser)
    _device_option(parser)
    return parser


def _parse_samples(spec):
    """'A:B' (either side optional, negatives allowed) -> (a, b)."""
    try:
        a_s, b_s = spec.split(':')
        return (int(a_s) if a_s else None, int(b_s) if b_s else None)
    except ValueError:
        raise ValueError("--samples expects A:B (sample indices, either "
                         "side optional), got %r" % spec)


def _parse_channels(spec, n_channels):
    """'7,100:104' -> [7, 100, 101, 102, 103].

    Comma-separated channel indices (negatives count from the end, as
    in NumPy) and half-open A:B ranges (either side optional). Order
    and duplicates are preserved — the output columns follow the
    request, exactly like ``arr[:, list]``.
    """
    cols = []
    for tok in spec.split(','):
        tok = tok.strip()
        if not tok:
            continue
        try:
            if ':' in tok:
                a_s, b_s = tok.split(':')
                sl = slice(int(a_s) if a_s else None,
                           int(b_s) if b_s else None)
                cols.extend(range(*sl.indices(n_channels)))
            else:
                c = int(tok)
                if not -n_channels <= c < n_channels:
                    raise IndexError(
                        "channel %d out of range for %d channels"
                        % (c, n_channels))
                cols.append(c % n_channels)
        except ValueError:
            raise ValueError("--channels expects comma-separated indices "
                             "and A:B ranges, got %r" % tok)
    if not cols:
        raise ValueError("--channels selected no channels: %r" % spec)
    return cols


def _iter_column_blocks(r, a, b, cols):
    """Yield ``r[c0:c1, cols]`` block by block over samples [a, b).

    Memory stays bounded for whole-recording exports. When the file
    supports column-restricted entropy decode (ans, narrow selection),
    each chunk rides that fast path; otherwise (legacy zlib, spatial
    diff, wide selections) chunks are decoded in small multi-chunk
    batches — the native batch decoder / thread pool — and
    column-sliced on the host, instead of running a whole recording
    serially through the per-chunk LRU path.
    """
    i0 = r._validate_index(a, 0)
    i1 = r._validate_index(b, r.n_samples)
    if i1 <= i0:
        return
    first_chunk, last_chunk = r._chunks_for_interval(i0, i1)
    uniq = np.unique(np.asarray(cols, dtype=np.int64))
    fast = (r.algorithm == 'ans' and not r.cmeta.do_spatial_diff
            and hasattr(r.codec, 'decode_channels')
            and 0 < uniq.size <= r.n_channels // 4)
    if fast:
        for idx in range(first_chunk, last_chunk + 1):
            c0 = max(i0, int(r.chunk_bounds[idx]))
            c1 = min(i1, int(r.chunk_bounds[idx + 1]))
            yield r[c0:c1, cols]
        return
    batch = max(1, min(int(r.bounded_batch_size()), 8))
    use_batch = hasattr(r.codec, 'decode_batch')
    if not use_batch:
        r.start_thread_pool()   # legacy codecs: thread over chunks
    try:
        for first in range(first_chunk, last_chunk + 1, batch):
            ids = list(range(first, min(first + batch, last_chunk + 1)))
            decoded = (r._decompress_chunks_batch(ids) if use_batch
                       else r.decompress_chunks(ids, pool=r.pool))
            for idx in ids:
                base = int(r.chunk_bounds[idx])
                c0 = max(i0, base)
                c1 = min(i1, int(r.chunk_bounds[idx + 1]))
                yield decoded[idx][c0 - base:c1 - base][:, cols]
    finally:
        if not use_batch:
            r.stop_thread_pool()


def mtsdecomp(args=None):
    """Decompress a file."""
    sys.excepthook = exception_handler
    parser = mtsdecomp_parser()
    pargs, config = _args_to_config(parser, args or sys.argv[1:],
                                    compress=False)
    add_default_handler('DEBUG' if pargs.debug else 'INFO')
    if (pargs.out == '-' or pargs.samples is not None
            or pargs.channels is not None):
        # Partial export and/or stdout streaming: random access for a
        # window, ordered batch decode for the full stream. The
        # whole-file re-read check does not apply; the full stream is
        # instead hash-verified incrementally (below).
        check = config.pop('check_after_decompress', True)
        r = decompress(pargs.cdata, pargs.cmeta,
                       check_after_decompress=False, **config)
        try:
            # Parse the export specs ONCE (shared by the file and the
            # stdout forms, so the two cannot drift).
            window = (_parse_samples(pargs.samples)
                      if pargs.samples is not None else None)
            cols = (_parse_channels(pargs.channels, r.n_channels)
                    if pargs.channels is not None else None)
            if pargs.out == '-':
                # `mtsdecomp data.cbin -o - | analyze`
                _stream_to_stdout(r, window, check, cols)
            else:
                a, b = window if window is not None else (None, None)
                out = Path(pargs.out) if pargs.out \
                    else Path(pargs.cdata).with_suffix('.bin')
                if out.exists() and not pargs.overwrite:
                    raise ValueError("File %s already exists (use -f to "
                                     "overwrite)." % out)
                if cols is not None:
                    ns = 0
                    with open(out, 'wb') as fb:
                        for block in _iter_column_blocks(r, a, b, cols):
                            fb.write(np.ascontiguousarray(block))
                            ns += block.shape[0]
                    logger.info("Wrote %s (%d samples x %d channels).",
                                out, ns, len(cols))
                else:
                    window = r[a:b]
                    window.tofile(out)
                    logger.info("Wrote %s (%d samples x %d channels).",
                                out, window.shape[0], window.shape[1])
        finally:
            r.close()
        return
    decompress(pargs.cdata, pargs.cmeta, out=pargs.out, write_output=True,
               overwrite=pargs.overwrite, **config)


def _stream_to_stdout(r, window, check, cols=None):
    """Write decoded samples (or a pre-parsed ``window``/``cols``
    selection, see ``mtsdecomp``) to stdout.

    The full stream is exactly the ``sha1_uncompressed`` preimage, so
    unless ``-nc`` was passed the streamed bytes are hashed
    incrementally and checked against the sidecar (chopped files carry
    no hash — skipped; column exports are not the preimage either). A
    consumer closing the pipe early (e.g. ``| head``) ends the stream
    quietly like standard Unix tools.
    """
    import hashlib
    stream = sys.stdout.buffer
    try:
        if cols is not None:
            a, b = window if window is not None else (None, None)
            for block in _iter_column_blocks(r, a, b, cols):
                stream.write(np.ascontiguousarray(block))
            stream.flush()
            return
        if window is not None:
            a, b = window
            stream.write(np.ascontiguousarray(r[a:b]))
            stream.flush()
            return
        want = r.cmeta.get('sha1_uncompressed') if check else None
        sha = hashlib.sha1() if want else None
        batch = r.bounded_batch_size()
        use_batch = hasattr(r.codec, 'decode_batch')
        if not use_batch:
            r.start_thread_pool()   # legacy zlib: thread over chunks
        try:
            for first in range(0, r.n_chunks, batch):
                ids = list(range(first, min(first + batch, r.n_chunks)))
                decoded = (r._decompress_chunks_batch(ids) if use_batch
                           else r.decompress_chunks(ids, pool=r.pool))
                for i in ids:
                    buf = np.ascontiguousarray(decoded[i])
                    if sha is not None:
                        sha.update(buf)
                    stream.write(buf)
        finally:
            if not use_batch:
                r.stop_thread_pool()
        stream.flush()
        if sha is not None and sha.hexdigest() != want:
            raise IOError(
                "Streamed data does not match the sidecar's "
                "sha1_uncompressed — the compressed file is corrupt.")
    except BrokenPipeError:
        # Downstream closed stdout (head -c, a dying consumer): not an
        # error. Detach so interpreter shutdown does not re-flush the
        # broken pipe and print a secondary error.
        try:
            sys.stdout.close()
        except Exception:
            pass


# -- mtsdesc -------------------------------------------------------------------

def mtsdesc(args=None):
    """Describe a compressed file."""
    sys.excepthook = exception_handler
    # Dedicated parser: reusing mtsdecomp's would advertise dead flags
    # (-o/--overwrite/--samples) that describe-only never reads.
    parser = argparse.ArgumentParser(
        description='Describe a compressed file.')
    parser.add_argument('cdata', type=str,
                        help='path to the compressed binary file (.cbin)')
    parser.add_argument('cmeta', type=str, nargs='?',
                        help='path to the compression metadata JSON file '
                             '(.ch)')
    parser.add_argument('--json', action='store_true',
                        help='print the description as one JSON object '
                             '(for scripts)')
    parser.add_argument('-v', '--debug', action='store_true',
                        help='verbose')
    pargs = parser.parse_args(args or sys.argv[1:])
    r = Reader(device='none')       # nothing is decoded
    r.open(pargs.cdata, pargs.cmeta)
    sr = float(r.cmeta.sample_rate)
    info = dict(
        dtype=r.dtype,
        sample_rate=sr,
        n_channels=r.n_channels,
        duration='%.1fs' % (r.n_samples / sr),
        n_samples=r.n_samples,
        chunk_duration='%.1fs' % (np.diff(r.chunk_bounds).mean() / sr),
        n_chunks=r.n_chunks,
        algorithm=r.algorithm,
    )
    if r.cmeta.get('chopped'):
        info['chopped'] = True
    if r.cmeta.get('streaming'):
        info['streaming'] = 'in progress (sidecar snapshot)'
    if r.cmeta.get('ans_table_mode'):
        info['ans_tables'] = r.cmeta['ans_table_mode']
    if int(r.cmeta.get('time_diff_order', 1)) != 1:
        info['time_diff_order'] = int(r.cmeta['time_diff_order'])
    if r.cmeta.get('float_bitcast'):
        info['float_bitcast'] = True
    if r.cmeta.get('transform_adapt'):
        info['transform_adapt'] = ('every %d chunks'
                                   % int(r.cmeta['transform_adapt']))
    part = r.cmeta.get('part')
    if part is not None:
        info['part'] = 'chunks [%d, %d) of %s' % (
            part[0], part[1], r.cmeta.get('part_of', '?'))
    if pargs.json:
        import json as _json
        info['dtype'] = str(info['dtype'])
        print(_json.dumps(info))
        return
    for k, v in info.items():
        print('{:<15}'.format(k), str(v))


# -- mtsverify -----------------------------------------------------------------

def mtsverify(args=None):
    """Audit a compressed pair in place — no raw file needed."""
    sys.excepthook = exception_handler
    parser = argparse.ArgumentParser(
        description='Verify a compressed pair without the original raw '
                    'file: sidecar structure, payload SHA1, a full '
                    'decode with the format\'s corruption machinery '
                    'live (per-chunk CRC32, table validation, stream '
                    'audits), and the decoded-data SHA1. Exit code 0 = '
                    'intact, 1 = verification failed.')
    parser.add_argument('cdata', type=str,
                        help='path to the compressed binary file (.cbin)')
    parser.add_argument('cmeta', type=str, nargs='?',
                        help='path to the compression metadata JSON file '
                             '(.ch; default: cdata with .ch suffix)')
    parser.add_argument('--fast', action='store_true',
                        help='skip the full decode (structure + payload '
                             'hash only)')
    parser.add_argument('-p', '--cpus', type=int,
                        help='number of CPUs to use for the decode pass')
    _device_option(parser)
    parser.add_argument('-v', '--debug', action='store_true',
                        help='verbose')
    pargs = parser.parse_args(args or sys.argv[1:])
    add_default_handler('DEBUG' if pargs.debug else 'INFO')
    from .verify import CHECKS, verify_file
    report = verify_file(pargs.cdata, pargs.cmeta, deep=not pargs.fast,
                         n_threads=pargs.cpus, device=pargs.device)
    for name in CHECKS:
        if name in report['checks']:
            print('{:<18}'.format(name), report['checks'][name])
    print('{:<18}'.format('verdict'), 'OK' if report['ok'] else 'FAILED')
    if not report['ok']:
        sys.exit(1)


# -- mtsmerge ------------------------------------------------------------------

def mtsmerge(args=None):
    """Merge compressed part files (mtscomp --range output) into one."""
    sys.excepthook = exception_handler
    parser = argparse.ArgumentParser(
        description='Merge compressed chunk-range parts into one '
                    '.cbin/.ch (parts are produced by mtscomp --range; '
                    'each part is verified against its own SHA1 during '
                    'the copy).')
    parser.add_argument('parts', type=str, nargs='+',
                        help='part .cbin files, in chunk order (each '
                             'needs its .ch sidecar next to it)')
    parser.add_argument('-o', '--out', type=str, required=True,
                        help='path to the merged compressed file (.cbin)')
    parser.add_argument('-m', '--outmeta', type=str,
                        help='path to the merged metadata file (.ch; '
                             'default: out with .ch suffix)')
    parser.add_argument('--expect-chunks', type=int, dest='expect_chunks',
                        help='total chunk count of the source recording; '
                             'the merge fails unless the parts cover '
                             'exactly this many chunks (needed for '
                             'hand-assembled merges of plain, non-ranged '
                             'files, which carry no part provenance)')
    # No -nc/-p here: the merge ALWAYS verifies each part's SHA1 during
    # the byte copy (safety property, not an option) and is a single
    # sequential stream — advertising dead flags misleads.
    parser.add_argument('--fast', action='store_true',
                        help='skip the decode pass: parts are still '
                             'byte-verified, but the merged sidecar '
                             'gets sha1_uncompressed: null instead of '
                             'the decoded-stream hash, so mtsverify '
                             '--deep cannot fully audit the output')
    parser.add_argument('-v', '--debug', action='store_true',
                        help='verbose')
    pargs = parser.parse_args(args or sys.argv[1:])
    add_default_handler('DEBUG' if pargs.debug else 'INFO')
    from .format import cmeta_sidecar_path
    from .parallel.distributed import merge_parts
    pairs = [(Path(p), cmeta_sidecar_path(p)) for p in pargs.parts]
    outmeta = pargs.outmeta or cmeta_sidecar_path(pargs.out)
    merge_parts(pairs, pargs.out, outmeta,
                expected_n_chunks=pargs.expect_chunks,
                decoded_hash=not pargs.fast)


# -- mtsrecompress -------------------------------------------------------------

def mtsrecompress(args=None):
    """Transcode a compressed file to another format, chunk by chunk."""
    sys.excepthook = exception_handler
    parser = argparse.ArgumentParser(
        description='Re-encode a compressed file with another codec '
                    'without materializing the raw data: upgrade legacy '
                    'zlib files to the v2 rANS format (-a ans), export '
                    'v2 files for reference-implementation consumers '
                    '(-a zlib), or re-encode with different ans '
                    'parameters. The source\'s sha1_uncompressed is '
                    're-derived and verified during the pass.')
    parser.add_argument('cdata', type=str,
                        help='path to the input compressed file (.cbin)')
    parser.add_argument('cmeta', type=str, nargs='?',
                        help='path to the input metadata file (.ch)')
    parser.add_argument('-o', '--out', type=str, required=True,
                        help='path to the output compressed file (.cbin)')
    parser.add_argument('-m', '--outmeta', type=str,
                        help='path to the output metadata file (.ch; '
                             'default: out with .ch suffix)')
    parser.add_argument('-a', '--algorithm', type=str, default='ans',
                        help="target algorithm: 'ans' (default) or "
                             "'zlib' (legacy export)")
    parser.add_argument('--ans-tables', type=str, dest='ans_table_mode',
                        choices=('plane', 'segment'),
                        help='ans frequency table mode (see mtscomp)')
    parser.add_argument('--overwrite', '-f', action='store_true',
                        help='overwrite existing output files')
    _device_option(parser)
    parser.add_argument('-v', '--debug', action='store_true',
                        help='verbose')
    pargs = parser.parse_args(args or sys.argv[1:])
    add_default_handler('DEBUG' if pargs.debug else 'INFO')
    from .transcode import transcode
    kwargs = {}
    if pargs.ans_table_mode:
        kwargs['ans_table_mode'] = pargs.ans_table_mode
    transcode(pargs.cdata, pargs.cmeta, pargs.out, pargs.outmeta,
              algorithm=pargs.algorithm, overwrite=pargs.overwrite,
              device=pargs.device, **kwargs)


# -- mtschop -------------------------------------------------------------------

def mtschop(args=None):
    """Chop a compressed file to its first N chunks without decompressing."""
    sys.excepthook = exception_handler
    parser = argparse.ArgumentParser(
        description='Chop a compressed file to N chunks without '
                    'decompressing it.')
    parser.add_argument('cdata', type=str,
                        help='path to the input compressed binary file (.cbin)')
    parser.add_argument('-n', '--n_chunks', type=int, required=True,
                        help='number of chunks to chop')
    parser.add_argument('-o', '--out', type=str, required=True,
                        help='path to the output chopped compressed file (.cbin)')
    _shared_options(parser)
    pargs = parser.parse_args(args or sys.argv[1:])
    r = Reader(device='none')       # a byte copy: nothing is decoded
    r.open(pargs.cdata)
    r.chop(pargs.n_chunks, pargs.out)
    r.close()


# -- python -m mtscomp_tpu_torch.cli <command> ---------------------------------

COMMANDS = {f.__name__: f for f in (mtscomp, mtsdecomp, mtsdesc, mtschop,
                                    mtsverify, mtsmerge, mtsrecompress)}


def main(argv=None):
    """Run ``<command> [arguments]``: the seven commands under one entry
    point, as ``python -m mtscomp_tpu_torch.cli`` calls it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m mtscomp_tpu_torch.cli {%s} [arguments]"
              % ','.join(COMMANDS), file=sys.stderr)
        sys.exit(2)
    # The mains read ``sys.argv[1:]`` when given no arguments, and the
    # exception hook looks for -v/--debug there: shift the command off.
    sys.argv = [argv[0]] + argv[1:]
    COMMANDS[argv[0]](argv[1:])


if __name__ == '__main__':
    main()
