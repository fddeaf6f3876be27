"""Measure the BASELINE.json configs on the port; print a markdown report.

Usage::

    python -m mtscomp_tpu_torch.benchmarks.baseline_report [--seconds S]
        [--lfp-seconds S] [--reps N] [--device cuda|cpu] [--reference DIR]

The JAX package's report (``mtscomp_tpu/benchmarks/baseline_report.py``)
on the port. ``--device cuda`` (the default) runs the kernels and exits
with code 2 where no GPU is visible; ``--device cpu`` runs their plain
twins, and then no number below is a device number. Every call names
its device: ``--device``, or ``'none'`` in the rows labelled ``host``,
or ``'auto'`` (config 3), so the user's configured device is not read.

Staged decode rates (configs 2 and 4): the file's chunks are cut into
the bounded batches a bulk decode makes (``pipeline.batch_limit``); each
batch is staged once on the device (``DeviceBatchDecoder.pack``), its
word audit run and its output checked byte for byte against its slice
of the source, and only then timed: CUDA events, the median of
``--reps`` after one warm-up (on the twins the host clock). The rate is
the decoded bytes over the sum of the batch medians. The header names the
card, its power limit and the software; the last line holds every
number as one JSON object, with the kernel launches of each config.
"""

import argparse
import json
import resource
import shutil
import sys
import tempfile
import time

import numpy as np

from .harness import bench_tmp_base, bench_tmpdir, cuda_ms, synth_walk


def _median_time(fn, reps):
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _synth(ns, nc, diff_std, seed=0):
    """The JAX report's random walk (steps of ``diff_std``, cast to int16
    without a clip), drawn block by block (:func:`~.harness.synth_walk`)."""
    rng = np.random.default_rng(seed)
    return synth_walk(ns, nc,
                      lambda n: rng.normal(0.0, diff_std, size=(n, nc)),
                      clip=False)


def _synth_gradient(ns, nc, lo, hi, seed=0):
    """Per-channel step size swept log-uniformly lo..hi (LFP-like
    amplitude gradient along the probe)."""
    rng = np.random.default_rng(seed)
    stds = np.logspace(np.log10(lo), np.log10(hi), nc)
    return synth_walk(ns, nc,
                      lambda n: rng.normal(0.0, 1.0, size=(n, nc)) * stds,
                      clip=True)


def _device_ms(fn, reps, device, inner=1):
    """Median ms of ``fn()`` after a warm-up: CUDA events over ``inner``
    calls a repeat on a card, the host clock of one call on the twins."""
    if device.type == 'cuda':
        return cuda_ms(fn, reps, inner)
    return 1e3 * _median_time(fn, reps)


def _staged_decode_rate(readers, T, arrs, reps, inner=1):
    """Staged device decode of the readers' chunks of ``T`` samples (a
    shorter last chunk is left out), merged reader-major as
    ``decompress_multi`` cuts them, in bounded batches: ``(GB/s,
    byte-exact, batches, most chunks in a batch)``, or ``(None, False, 0,
    0)`` when a batch is not one the device decodes. ``inner`` calls
    a timed repeat on a card (:func:`_device_ms`)."""
    from ..parallel.pipeline import (DeviceBatchDecoder, _uniform_batches,
                                     check_words_used)
    r0 = readers[0]
    bounds = r0.chunk_bounds
    full = [i for i in range(r0.n_chunks) if bounds[i + 1] - bounds[i] == T]
    dec = DeviceBatchDecoder(r0, r0.device)
    total_ms, nbytes, exact, n_batches, widest = 0.0, 0, True, 0, 0
    for ids, parsed in _uniform_batches(readers, full, T, dec):
        if not dec.supported(parsed, T):
            return None, False, 0, 0
        fn, args = dec.pack(parsed, T)
        out, used = fn(*args)
        check_words_used(parsed, used)
        got = out.cpu().numpy().reshape(len(readers), len(ids) * T, -1)
        rows = slice(bounds[ids[0]], bounds[ids[-1] + 1])
        exact = exact and all(np.array_equal(g.view(a.dtype), a[rows])
                              for g, a in zip(got, arrs))
        nbytes += got.nbytes
        del out, used, got
        total_ms += _device_ms(lambda: fn(*args), reps, dec.device, inner)
        n_batches += 1
        widest = max(widest, len(parsed))
        del fn, args, parsed
    if not n_batches:
        return None, False, 0, 0
    return nbytes / 1e6 / total_ms, exact, n_batches, widest


def _to_array_s(cbin, ch, arr, device):
    """Seconds of one ``to_array()`` of the file on ``device`` (its
    result is in host memory: the fetch waits for the card), and whether
    it gave the source."""
    from .. import decompress
    r = decompress(cbin, ch, quiet=True, device=device)
    try:
        t0 = time.perf_counter()
        out = r.to_array()
        s = time.perf_counter() - t0
    finally:
        r.close()
    exact = np.array_equal(out, arr)
    del out
    return s, exact


def config1_cpu_roundtrip(reps, out):
    """256-ch int16 @20 kHz roundtrip on the host paths (both algos)."""
    from .. import compress, decompress
    arr = _synth(20000 * 10, 256, 4.0)
    tmp = bench_tmpdir()
    arr.tofile(tmp / 'c1.bin')
    rows = []
    try:
        for algo in ('zlib', 'ans'):
            ratio = [None]

            def do_compress(algo=algo, ratio=ratio):
                ratio[0] = compress(
                    tmp / 'c1.bin', tmp / ('c1%s.cbin' % algo),
                    tmp / ('c1%s.ch' % algo), sample_rate=20000.0,
                    n_channels=256, dtype='int16', algorithm=algo,
                    quiet=True, check_after_compress=False, device='none')

            wt = _median_time(do_compress, max(1, reps // 2))
            r = decompress(tmp / ('c1%s.cbin' % algo),
                           tmp / ('c1%s.ch' % algo), quiet=True,
                           device='none')
            dec = [None]

            def do_decode(r=r, dec=dec):
                # Repeated timed reads must re-decode, not hit the
                # random-access LRU.
                r.read_chunk.cache_clear()
                dec[0] = r[:]

            rt = _median_time(do_decode, reps)
            exact = np.array_equal(dec[0], arr)
            r.close()
            rows.append((algo, 1 / ratio[0], arr.nbytes / 1e6 / wt,
                         arr.nbytes / 1e6 / rt, exact))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.append("## Config 1 — 256-ch int16 @20 kHz, host (CPU) roundtrip\n")
    out.append("| algorithm | ratio | compress MB/s | decompress MB/s | "
               "byte-exact |")
    out.append("|---|---|---|---|---|")
    for algo, ratio, w, rd, ex in rows:
        out.append("| %s | %.2fx | %.0f | %.0f | %s |"
                   % (algo, ratio, w, rd, ex))
    out.append("")
    return {algo: {'ratio': ratio, 'compress_mbps': w,
                   'decompress_mbps': rd, 'exact': ex}
            for algo, ratio, w, rd, ex in rows}


def config2_neuropixels(seconds, reps, out, device='cuda'):
    """385-ch int16 @30 kHz: compress + staged device decompress + check,
    and ``to_array()`` on ``device`` and on the host codec."""
    from .. import check, compress, decompress
    from ..io_host import load_raw_data
    from ..parallel.pipeline import batch_limit
    arr = _synth(30000 * seconds, 385, 6.0)
    tmp = bench_tmpdir()
    try:
        arr.tofile(tmp / 'c2.bin')
        t0 = time.perf_counter()
        ratio = compress(tmp / 'c2.bin', tmp / 'c2.cbin', tmp / 'c2.ch',
                         sample_rate=30000.0, n_channels=385, dtype='int16',
                         algorithm='ans', quiet=True,
                         check_after_compress=False, device=device)
        wt = time.perf_counter() - t0
        data = load_raw_data(tmp / 'c2.bin', n_channels=385, dtype=np.int16)
        t0 = time.perf_counter()
        check(data, tmp / 'c2.cbin', tmp / 'c2.ch')   # full verify (host)
        ct = time.perf_counter() - t0
        del data
        (tmp / 'c2.bin').unlink()        # tmpfs: the raw file is memory
        r = decompress(tmp / 'c2.cbin', tmp / 'c2.ch', quiet=True,
                       device=device)
        try:
            T = r.chunk_bounds[1]
            limit = batch_limit(r, T)
            gbps, exact, n_batches, widest = _staged_decode_rate(
                [r], T, [arr], reps)
        finally:
            r.close()
        routes = {}
        for label, dev in ((device, device), ('host', 'none')):
            routes[label] = _to_array_s(tmp / 'c2.cbin', tmp / 'c2.ch', arr,
                                        dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gb = arr.nbytes / 1e9
    out.append("## Config 2 — Neuropixels AP: 385-ch int16 @30 kHz "
               "(%d s, %.2f GB)\n" % (seconds, gb))
    out.append("| metric | value |")
    out.append("|---|---|")
    out.append("| compression ratio | %.2fx |" % (1 / ratio))
    out.append("| compress (%s) | %.0f MB/s |"
               % (device, arr.nbytes / 1e6 / wt))
    out.append("| device decompress (staged) | %s |"
               % ("%.2f GB/s (%d batches of at most %d chunks; bound %d)"
                  % (gbps, n_batches, widest, limit) if gbps is not None
                  else "n/a (host path)"))
    out.append("| full compress-then-verify (host) | %.0f MB/s |"
               % (arr.nbytes / 1e6 / ct))
    for label, (s, ex) in routes.items():
        out.append("| to_array() (%s) | %.3f s, %.2f GB/s, byte-exact %s |"
                   % (label, s, gb / s, ex))
    out.append("| byte-exact (staged) | %s |" % exact)
    out.append("")
    return {'seconds': seconds, 'gb': gb, 'ratio': 1 / ratio,
            'compress_device': device,
            'compress_mbps': arr.nbytes / 1e6 / wt,
            'check_mbps': arr.nbytes / 1e6 / ct,
            'staged': {'gbps': gbps, 'batches': n_batches,
                       'widest_batch': widest, 'batch_limit': limit,
                       'exact': exact},
            'to_array': {label: {'s': s, 'gbps': gb / s, 'exact': ex}
                         for label, (s, ex) in routes.items()}}


def config3_lfp_windows(reps, out, seconds=240, device='cuda'):
    """LFP band 385-ch @2.5 kHz (``seconds`` of it): random 1-s window
    reads r[i0:i1] on the host codec, ``device`` and ``'auto'``."""
    from .. import compress, decompress
    from ..api import AUTO_DEVICE_MIN_BYTES
    arr = _synth_gradient(2500 * seconds, 385, 3.0, 40.0)
    tmp = bench_tmpdir()
    try:
        arr.tofile(tmp / 'c3.bin')
        ratio = compress(tmp / 'c3.bin', tmp / 'c3.cbin', tmp / 'c3.ch',
                         sample_rate=2500.0, n_channels=385, dtype='int16',
                         algorithm='ans', quiet=True,
                         ans_table_mode='segment',
                         check_after_compress=False, device=device)
        ratio_plane = compress(tmp / 'c3.bin', tmp / 'c3p.cbin',
                               tmp / 'c3p.ch', sample_rate=2500.0,
                               n_channels=385, dtype='int16',
                               algorithm='ans', quiet=True,
                               ans_table_mode='plane',
                               check_after_compress=False, device=device)
        (tmp / 'c3.bin').unlink()
        rng = np.random.default_rng(1)
        lat, exact, auto_route = {}, True, None
        for dev, label in (('none', 'host'), (device, device),
                           ('auto', 'auto')):
            r = decompress(tmp / 'c3.cbin', tmp / 'c3.ch', quiet=True,
                           device=dev)
            try:
                n = r.shape[0]
                idx = [int(rng.integers(0, n - 2500)) for _ in range(12)]
                win = r[idx[0]:idx[0] + 2500]            # warm-up
                exact = exact and np.array_equal(win,
                                                 arr[idx[0]:idx[0] + 2500])
                ts = []
                for i0 in idx:
                    t0 = time.perf_counter()
                    win = r[i0:i0 + 2500]
                    ts.append(time.perf_counter() - t0)
                    exact = exact and np.array_equal(win,
                                                     arr[i0:i0 + 2500])
                lat[label] = sorted(ts)[len(ts) // 2] * 1e3
                if dev == 'auto':
                    auto_route = ('card' if r._use_device(
                        window=(idx[0], idx[0] + 2500)) else 'host')
            finally:
                r.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gb = arr.nbytes / 1e9
    out.append("## Config 3 — LFP: 385-ch int16 @2.5 kHz (%d s, %.2f GB), "
               "random 1-s window reads\n" % (seconds, gb))
    out.append("| metric | value |")
    out.append("|---|---|")
    out.append("| compression ratio (segment tables) | %.2fx |"
               % (1 / ratio))
    out.append("| compression ratio (plane tables) | %.2fx |"
               % (1 / ratio_plane))
    for label, ms in lat.items():
        out.append("| window read latency (%s) | %.1f ms |" % (label, ms))
    out.append("| byte-exact (every window) | %s |" % exact)
    out.append("")
    gate = AUTO_DEVICE_MIN_BYTES / 1e9
    out.append("(Median of 12 windows as they fall, cached or not, a chunk "
               "cache of 10. On `%s` the windows took %.1f ms against %.1f "
               "ms on the host codec. `'auto'` took the %s: %s.)"
               % (device, lat[device], lat['host'], auto_route,
                  "the recording, %.2f GB, is under its size gate "
                  "`AUTO_DEVICE_MIN_BYTES` of %.2f GB" % (gb, gate)
                  if gb < gate else
                  "the recording, %.2f GB, passes its size gate of %.2f GB, "
                  "so its cost model chose (`Reader._use_device`)"
                  % (gb, gate)))
    out.append("")
    return {'seconds': seconds, 'gb': gb, 'ratio_segment': 1 / ratio,
            'ratio_plane': 1 / ratio_plane, 'window_ms': lat,
            'auto_route': auto_route, 'exact': exact}


def config4_multiprobe(seconds, reps, out, device='cuda'):
    """4 x 384-ch probes decoded in merged batches on ``device``, and
    sharded over every visible card."""
    from .. import compress, decompress
    from ..parallel.mesh import chunk_mesh
    from ..parallel.pipeline import decompress_multi
    tmp = bench_tmpdir()
    readers, arrs = [], []
    try:
        for p in range(4):
            arr = _synth(30000 * seconds, 384, 6.0, seed=p)
            arrs.append(arr)
            arr.tofile(tmp / ('p%d.bin' % p))
            compress(tmp / ('p%d.bin' % p), tmp / ('p%d.cbin' % p),
                     tmp / ('p%d.ch' % p), sample_rate=30000.0,
                     n_channels=384, dtype='int16', algorithm='ans',
                     quiet=True, check_after_compress=False, device=device)
            (tmp / ('p%d.bin' % p)).unlink()
            readers.append(decompress(tmp / ('p%d.cbin' % p),
                                      tmp / ('p%d.ch' % p), quiet=True,
                                      device=device))
        t0 = time.perf_counter()
        outs = decompress_multi(readers)
        multi_s = time.perf_counter() - t0
        exact = all(np.array_equal(o, a) for o, a in zip(outs, arrs))
        del outs
        # Staged rate over the merged batches.
        gbps, staged_exact, n_batches, widest = _staged_decode_rate(
            readers, readers[0].chunk_bounds[1], arrs, reps)
        mesh = chunk_mesh() if device == 'cuda' else chunk_mesh([device])
        t0 = time.perf_counter()
        outs = decompress_multi(readers, mesh=mesh)
        mesh_s = time.perf_counter() - t0
        mesh_exact = all(np.array_equal(o, a) for o, a in zip(outs, arrs))
        del outs
        total = sum(a.nbytes for a in arrs)
    finally:
        for r in readers:
            r.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out.append("## Config 4 — multi-probe: 4 x 384-ch int16 @30 kHz, "
               "merged device batch (%d s each)\n" % seconds)
    out.append("| metric | value |")
    out.append("|---|---|")
    out.append("| decompress_multi (%s) | %.3f s, %.2f GB/s |"
               % (device, multi_s, total / 1e9 / multi_s))
    out.append("| aggregate device decompress (staged) | %s |"
               % ("%.2f GB/s (%d batches of at most %d chunks)"
                  % (gbps, n_batches, widest) if gbps is not None
                  else "n/a (host path)"))
    out.append("| decompress_multi(mesh=chunk_mesh()), width %d (%s) | "
               "%.3f s, %.2f GB/s |"
               % (len(mesh), ', '.join(str(d) for d in mesh), mesh_s,
                  total / 1e9 / mesh_s))
    out.append("| byte-exact (all probes: merged, staged, mesh) | %s, %s, "
               "%s |" % (exact, staged_exact, mesh_exact))
    out.append("")
    return {'seconds': seconds, 'gb': total / 1e9,
            'decompress_multi': {'s': multi_s, 'exact': exact},
            'staged': {'gbps': gbps, 'batches': n_batches,
                       'widest_batch': widest, 'exact': staged_exact},
            'mesh': {'width': len(mesh), 's': mesh_s, 'exact': mesh_exact}}


def config5_legacy(out, reference=None, device='cuda'):
    """Reference-written zlib .cbin -> our reader -> re-encode as ans on
    ``device``.

    ``reference`` is a directory holding the reference ``mtscomp``
    package; without it (or where it does not import) the port's own
    zlib writer writes the legacy file."""
    from .. import compress, decompress
    tmp = bench_tmpdir()
    arr = _synth(30000 * 4, 385, 6.0)
    try:
        arr.tofile(tmp / 'c5.bin')
        who = 'self-written (reference unavailable)'
        if reference is not None:
            sys.path.insert(0, str(reference))
            try:
                import mtscomp as ref
                ref.compress(tmp / 'c5.bin', tmp / 'c5.cbin', tmp / 'c5.ch',
                             sample_rate=30000.0, n_channels=385,
                             dtype=np.int16, check_after_compress=False)
                who = 'reference-written'
            except ImportError:
                pass
            finally:
                sys.path.remove(str(reference))
        if who != 'reference-written':
            compress(tmp / 'c5.bin', tmp / 'c5.cbin', tmp / 'c5.ch',
                     sample_rate=30000.0, n_channels=385, dtype='int16',
                     algorithm='zlib', quiet=True, check_after_compress=False,
                     device=device)
        r = decompress(tmp / 'c5.cbin', tmp / 'c5.ch', quiet=True,
                       device=device)
        try:
            dec = r[:]
            exact = np.array_equal(dec, arr)
            zlib_size = (tmp / 'c5.cbin').stat().st_size
        finally:
            r.close()
        dec.tofile(tmp / 'c5r.bin')
        ratio = compress(tmp / 'c5r.bin', tmp / 'c5r.cbin', tmp / 'c5r.ch',
                         sample_rate=30000.0, n_channels=385, dtype='int16',
                         algorithm='ans', quiet=True,
                         check_after_compress=False, device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.append("## Config 5 — legacy interop: %s zlib .cbin\n" % who)
    out.append("| metric | value |")
    out.append("|---|---|")
    out.append("| legacy file decoded byte-exactly | %s |" % exact)
    out.append("| legacy zlib ratio | %.2fx |"
               % (arr.nbytes / zlib_size))
    out.append("| re-encoded (ans) ratio | %.2fx |" % (1 / ratio))
    out.append("")
    return {'writer': who, 'exact': exact,
            'zlib_ratio': arr.nbytes / zlib_size, 'ans_ratio': 1 / ratio}


def config6_float(out, device='cuda'):
    """Float recordings on ``device``: bit-exactness + ratio of the v2
    bitcast transform vs the reference's float-domain zlib (which is
    only allclose, and whose automatic check can fail near zero
    crossings).
    """
    from .. import compress, decompress
    tmp = bench_tmpdir()
    rng = np.random.default_rng(6)
    nc = 64
    arr = np.cumsum(rng.normal(0.0, 1.0, size=(20 * 2500, nc)),
                    axis=0).astype(np.float32)
    arr -= arr.mean(axis=0, keepdims=True)
    rows = {}
    try:
        arr.tofile(tmp / 'c6.bin')
        for algo in ('zlib', 'ans'):
            ratio = compress(tmp / 'c6.bin', tmp / ('c6%s.cbin' % algo),
                             tmp / ('c6%s.ch' % algo), sample_rate=2500.0,
                             n_channels=nc, dtype='float32', algorithm=algo,
                             quiet=True, check_after_compress=False,
                             device=device)
            r = decompress(tmp / ('c6%s.cbin' % algo),
                           tmp / ('c6%s.ch' % algo), quiet=True,
                           device=device)
            try:
                dec = r[:]
                exact = np.array_equal(dec.view(np.uint32),
                                       arr.view(np.uint32))
            finally:
                r.close()
            rows[algo] = (1 / ratio, exact)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.append("## Config 6 — float32 LFP-like: 64-ch @2.5 kHz "
               "(byte-exact floats are v2-only)\n")
    out.append("| algorithm | ratio | bit-exact round trip |")
    out.append("|---|---|---|")
    out.append("| zlib (reference float semantics) | %.2fx | %s |"
               % (rows['zlib'][0], rows['zlib'][1]))
    out.append("| ans (bitcast transform) | %.2fx | %s |"
               % (rows['ans'][0], rows['ans'][1]))
    out.append("")
    return {'zlib': {'ratio': rows['zlib'][0], 'bit_exact': rows['zlib'][1]},
            'ans': {'ratio': rows['ans'][0], 'exact': rows['ans'][1]}}


def main(argv=None):
    import torch

    from .. import launch_counts, native, reset_launch_counts
    from ..device import resolve_device
    from ..ops import _build
    from ..storm import _card_line
    p = argparse.ArgumentParser(
        prog='python -m mtscomp_tpu_torch.benchmarks.baseline_report')
    p.add_argument('--seconds', type=int, default=8,
                   help='seconds of 30 kHz data per probe')
    p.add_argument('--lfp-seconds', type=int, default=240,
                   help='seconds of the 2.5 kHz LFP band of config 3')
    p.add_argument('--reps', type=int, default=5)
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help="'cuda' runs the kernels (the default; exits 2 "
                        "without a GPU), 'cpu' their plain twins")
    p.add_argument('--reference', default=None, metavar='DIR',
                   help='directory of the reference mtscomp package, for '
                        "config 5 (else the port's own zlib writer)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print('baseline_report: %s' % e, file=sys.stderr)
        return 2

    # The runtimes build at first use: before the first config.
    t0 = time.perf_counter()
    if device.type == 'cuda':
        _build.library()
        torch.cuda.synchronize(device)
    native.available()
    setup_s = time.perf_counter() - t0
    tmp_base = bench_tmp_base() or tempfile.gettempdir()
    card = (_card_line() if device.type == 'cuda'
            else 'none (the plain twins on the CPU: no device number)')
    out = ["# BASELINE.json configs on the port",
           "",
           "Card: %s. torch %s, CUDA %s; device `%s`. Generated by "
           "`python -m mtscomp_tpu_torch.benchmarks.baseline_report%s` "
           "(kernels and host library built in %.1f s before the first "
           "config; working files in `%s`). See the module docstring for "
           "the method (staged device batches cut as a bulk decode cuts "
           "them)."
           % (card, torch.__version__, torch.version.cuda, args.device,
              ''.join(' ' + a for a in (argv if argv is not None
                                         else sys.argv[1:])), setup_s,
              tmp_base),
           ""]
    results = {'card': card, 'torch': torch.__version__,
               'cuda': torch.version.cuda, 'device': args.device,
               'tmp_base': tmp_base,
               'seconds': args.seconds, 'lfp_seconds': args.lfp_seconds,
               'reps': args.reps, 'setup_s': setup_s}
    dev = args.device
    runs = (
        ('config1', lambda: config1_cpu_roundtrip(args.reps, out)),
        ('config2', lambda: config2_neuropixels(args.seconds, args.reps, out,
                                                dev)),
        ('config3', lambda: config3_lfp_windows(args.reps, out,
                                                args.lfp_seconds, dev)),
        ('config4', lambda: config4_multiprobe(
            max(2, args.seconds // 4), args.reps, out, dev)),
        ('config5', lambda: config5_legacy(out, args.reference, dev)),
        ('config6', lambda: config6_float(out, dev)))
    for name, run in runs:
        reset_launch_counts()
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        results[name] = run()
        results[name].update(
            wall_s=time.perf_counter() - t0,
            launches={k: v for k, v in launch_counts().items() if v},
            # The process's peak resident memory so far (Linux: KiB).
            host_peak_gb=resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
            device_peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == 'cuda' else None))
    out.append("## Kernel launches by config\n")
    out.append("| config | seconds | host peak GB (process, so far) | "
               "device peak GB | launches (and chunks left to the host "
               "codec) |")
    out.append("|---|---|---|---|---|")
    for name, _run in runs:
        res = results[name]
        out.append("| %s | %.1f | %.2f | %s | %s |" % (
            name[-1], res['wall_s'], res['host_peak_gb'],
            'n/a' if res['device_peak_gb'] is None
            else '%.2f' % res['device_peak_gb'],
            ', '.join('%s %d' % kv for kv in res['launches'].items())
            or 'none'))
    out.append("")
    print('\n'.join(out))
    print('## Every number\n\n```json\n%s\n```'
          % json.dumps({'baseline_report': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
