"""Headline benchmark of the port: decompress throughput on the
Neuropixels configuration, on one GPU.

The JAX package's ``bench.py`` (the same phases, names, synthesis and
JSON line) for the port::

    python -m mtscomp_tpu_torch.bench [--device cuda|cpu]

Configuration (BASELINE.json #2): 385-channel int16 at 30 kHz, 1-s
chunks, ans (v2) files: a seeded random walk with diff std 6 (entropy
comparable to real Neuropixels recordings), ``BENCH_SECONDS`` of it (8
by default). The phases, each in a child process of its own:

- ``probe``: is there a card (``torch.cuda``), its name, power limit
  (``nvidia-smi``) and count; the kernels and the host codec's C++
  library built here, so that no timed phase pays for ``nvcc``;
- ``encode``: ``compress(..., algorithm='ans')`` on the host codec
  (``device='none'``, what the JAX bench's ``'auto'`` took at this
  size) and on the card (K6 in every batch, no chunk left to the host
  codec), in turns, median of 5; both routes' files byte-identical;
- ``dev_decode``, the headline: the file's chunks staged on the card in
  the bounded batches a bulk decode makes, each batch's word audit run
  and its output compared byte for byte, then timed with CUDA events
  (``baseline_report._staged_decode_rate``); GB/s of decoded output.
  At 385 channels the fuse8 route runs: K1 (octet) and K3, nothing else;
- ``e2e``: ``Reader.tofile()`` on the card and on the host codec, in
  turns, median of 5, the written bytes checked;
- ``dev_encode``: K6 alone on B = min(4, seconds) chunks, in GB/s of raw
  input, after every payload of the batch equals the host codec's.

Every phase names its route: the port's ``'auto'`` sends a file this
size to the host before any probe (``api.AUTO_DEVICE_MIN_BYTES``).

The parent process runs no CUDA call, builds nothing and launches no
kernel (this module's own imports are the standard library, numpy and
the numpy-only ``benchmarks`` helpers; the package's ``__init__`` loads
torch, which does not initialize CUDA): a
hang or a crash of CUDA's initialization, of a kernel build or of a
kernel stays in a child. Each child runs in a session of its own and
its whole process group is killed when it exits or at its deadline
(its output goes to a file, which a child's ``nvcc`` processes cannot
hold open the way they would hold a pipe). The headline
phase and every other phase get one retry; the global budget caps every
deadline. A phase that does not run, fails or times out reports
``null`` where its numbers would be, and says why in ``phase_errors``.

Prints ONE JSON line: the JAX keys (``metric``, ``value`` in GB/s,
``unit``, ``vs_baseline``, ``compression_ratio``, ``encode_mbps``,
``device_encode_gbps``, ``e2e_decomp_mbps``, ``e2e_decomp_path``,
``bench_fs``, ``byte_exact``, ``phase_errors``) and the port's:
``device`` (platform, name, power limit, count),
``device_compress_mbps``, ``e2e_host_mbps``, ``launches`` (each phase's
kernel launches by form, timed repeats included), ``geometry`` and
``elapsed_s``. The exit code is 0 only when the headline was measured on
a card and every byte check of every phase held; without a GPU the line
says ``error`` and the exit code is 2. ``--device cpu`` runs the
kernels' plain twins: every rate is ``null`` (a CPU time is no device
number) and the exit code 0 means that every byte check held.

Env knobs: ``BENCH_SECONDS``, ``BENCH_INNER``, ``BENCH_REPS``
(measurement geometry: seconds of data, calls a timed repeat and timed
repeats of the staged phases); ``BENCH_BUDGET`` (global wall-clock
budget for all phases, seconds), ``BENCH_PHASE_TIMEOUT`` (deadline of
one attempt of the headline phase); ``MTSCOMP_BENCH_FAULT=
"hang:<phase>[:n]"`` hangs the named phase's first n attempts (testing
only).
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

from .benchmarks.baseline_report import _synth
from .benchmarks.harness import bench_tmpdir

C, SR = 385, 30000.0
METRIC = 'decompress_throughput_neuropixels_385ch_int16'
#: The baseline of ``vs_baseline``: the reference's single-threaded zlib
#: decompression, 22 MB/s (int-brain-lab/mtscomp, README.md:177).
BASELINE_GBPS = 0.022
#: Kernel forms the headline's fuse8 route launches at 385 channels (K1's
#: tables built on the card, K1 octet and K3), and nothing else.
DECODE_FORMS = frozenset(('decode_tables', 'rans_decode_octet',
                          'finalize_u8_tail'))
PHASES = ('probe', 'encode', 'dev_decode', 'e2e', 'dev_encode')
#: The directory that holds the package, on the children's import path.
_ROOT = str(Path(__file__).resolve().parent.parent)


def _log(msg):
    print('[bench] %s' % msg, file=sys.stderr, flush=True)


def _env_int(name, default):
    return int(os.environ.get(name, default))


def _median_mbps(nbytes, seconds):
    return nbytes / 1e6 / sorted(seconds)[len(seconds) // 2]


def _fs_type(path):
    """Type of the file system that holds ``path`` (the longest mount
    point of ``/proc/mounts`` above it), or None where that is unknown."""
    path = os.path.realpath(path)
    best, kind = '', None
    try:
        with open('/proc/mounts') as f:
            for line in f:
                fields = line.split()
                mnt, fs = fields[1], fields[2]
                if ((path == mnt or path.startswith(mnt.rstrip('/') + '/'))
                        and len(mnt) > len(best)):
                    best, kind = mnt, fs
    except (OSError, IndexError):
        return None
    return kind


# ---------------------------------------------------------------------------
# Parent orchestrator: no CUDA call, no build, no kernel.
# ---------------------------------------------------------------------------

def synthesize(seconds, sample_rate=SR):
    """The recording: the JAX bench's seed-0 random walk bit for bit,
    ``np.cumsum(rng.normal(0, 6, (T * seconds, C)), axis=0).astype(
    np.int16)`` with ``T = sample_rate``, drawn block by block in rows
    (``harness.synth_walk``). Numpy only: safe in the parent."""
    return _synth(int(sample_rate) * seconds, C, 6.0, seed=0)


def _line(**fields):
    """The JSON line: every key, ``None`` where no number was taken."""
    out = dict.fromkeys((
        'value', 'vs_baseline', 'compression_ratio', 'encode_mbps',
        'device_encode_gbps', 'e2e_decomp_mbps', 'e2e_decomp_path',
        'bench_fs', 'device', 'device_compress_mbps', 'e2e_host_mbps'))
    out.update(metric=METRIC, unit='GB/s', byte_exact=False,
               phase_errors={}, launches={})
    out.update(fields)
    return out


def orchestrate(device='cuda', seconds=None, sample_rate=SR):
    """Run every phase in a child and print the JSON line; returns the
    exit code. ``device`` is ``'cuda'`` (the kernels) or ``'cpu'`` (their
    twins, no rate); ``seconds`` (default ``BENCH_SECONDS``, else 8) of
    ``C`` channels at ``sample_rate``, in chunks of one second."""
    t0 = time.time()
    budget = float(os.environ.get('BENCH_BUDGET', '1100'))

    def remaining():
        return budget - (time.time() - t0)

    if seconds is None:
        seconds = _env_int('BENCH_SECONDS', 8)
    tmp = bench_tmpdir()
    geometry = {'device': device, 'seconds': seconds,
                'sample_rate': sample_rate, 'n_channels': C}
    (tmp / 'bench.json').write_text(json.dumps(geometry))
    common = {'geometry': geometry, 'bench_fs': _fs_type(tmp)}

    def emit(line):
        line['elapsed_s'] = time.time() - t0
        print(json.dumps(line), flush=True)

    probe, note = _run_phase('probe', tmp, timeout=min(240.0, remaining()),
                             attempts=2, budget_left=remaining)
    if not probe or probe.get('error'):
        error = probe['error'] if probe else 'probe: %s' % note
        emit(_line(error=error, phase_errors={'probe': error}, **common))
        return 2
    info = probe['device']
    _log('device=%s seconds=%d budget=%.0fs' % (json.dumps(info), seconds,
                                                budget))

    synthesize(seconds, sample_rate).tofile(tmp / 'bench.bin')

    errors, results = {}, {}
    # (phase, deadline of an attempt, least budget left to start it)
    plan = (('encode', 420.0, 0.0),
            ('dev_decode', float(os.environ.get('BENCH_PHASE_TIMEOUT', '420')),
             0.0),
            ('e2e', 300.0, 90.0), ('dev_encode', 360.0, 90.0))
    for name, deadline, least in plan:
        if name != 'encode' and 'encode' not in results:
            errors[name] = 'skipped: no compressed file'
            continue
        if remaining() <= least:
            errors[name] = 'skipped: budget'
            continue
        res, note = _run_phase(name, tmp,
                               timeout=min(deadline, max(60.0, remaining())),
                               attempts=2, budget_left=remaining)
        if res is None:
            errors[name] = note
            continue
        if res.get('error'):
            errors[name] = res['error']
        results[name] = res

    def get(phase, key):
        return results.get(phase, {}).get(key)

    gbps = get('dev_decode', 'gbps')
    byte_exact = (not errors and len(results) == len(PHASES) - 1
                  and all(r.get('byte_exact') for r in results.values()))
    emit(_line(
        value=gbps,
        vs_baseline=gbps / BASELINE_GBPS if gbps is not None else None,
        compression_ratio=get('encode', 'ratio'),
        encode_mbps=get('encode', 'enc_mbps'),
        device_encode_gbps=get('dev_encode', 'dev_enc_gbps'),
        e2e_decomp_mbps=get('e2e', 'e2e_mbps'),
        e2e_decomp_path='device' if 'e2e' in results else None,
        byte_exact=byte_exact, phase_errors=errors, device=info,
        device_compress_mbps=get('encode', 'device_compress_mbps'),
        e2e_host_mbps=get('e2e', 'e2e_host_mbps'),
        launches={name: res.get('launches', {})
                  for name, res in results.items()},
        **common))
    if not byte_exact:
        return 1
    return 0 if device == 'cpu' or gbps is not None else 1


def _kill_group(pgid):
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def _run_child(cmd, timeout, env=None):
    """Run ``cmd`` in a session of its own, its output to a temporary
    file, and kill its whole process group when it exits or at
    ``timeout`` seconds: ``(its exit code, or None when killed at the
    deadline; its output)``.

    The output goes to a file, not a pipe: ``subprocess.run(timeout=)``
    waits for its pipe to close, which a grandchild holding it (a kernel
    build's ``nvcc``) can delay without end.
    """
    with tempfile.TemporaryFile() as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                env=env, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            _kill_group(proc.pid)
            proc.wait()
        out.seek(0)
        return rc, out.read().decode('utf-8', 'replace')


def run_module(args, timeout, env=None):
    """``python -m mtscomp_tpu_torch.bench *args`` through ``_run_child``,
    with this package first on the child's import path and ``env``'s
    variables set over this process's environment."""
    env = dict(os.environ, **(env or {}))
    path = env.get('PYTHONPATH')
    env['PYTHONPATH'] = _ROOT + (os.pathsep + path if path else '')
    return _run_child([sys.executable, '-m', 'mtscomp_tpu_torch.bench']
                      + list(args), timeout, env=env)


def _run_phase(name, tmp, timeout, attempts, budget_left):
    """Run one phase in a killable child: ``(its result dict or None,
    a note of what went wrong)``.

    The child writes its result to ``phase_<name>.json`` (its output is
    logged on a failure). Deadlines are capped by the remaining global
    budget.
    """
    res_path = tmp / ('phase_%s.json' % name)
    note = 'not run'
    for attempt in range(1, attempts + 1):
        to = min(timeout, max(30.0, budget_left()))
        if budget_left() < 20:
            _log('%s: skipped (budget exhausted)' % name)
            return None, note + '; budget exhausted'
        res_path.unlink(missing_ok=True)
        _log('%s: attempt %d/%d (deadline %.0fs)'
             % (name, attempt, attempts, to))
        t0 = time.time()
        rc, out = run_module(['--phase', name, '--dir', str(tmp),
                              '--attempt', str(attempt)], to)
        if rc is None:
            note = 'killed at its deadline (%.0f s)' % to
            _log('%s: %s' % (name, note))
            continue
        if rc != 0:
            last = out.strip().splitlines()[-1:] or ['']
            note = 'child rc=%d: %s' % (rc, last[0][-300:])
            _log('%s: child rc=%d after %.0fs\n%s'
                 % (name, rc, time.time() - t0, out[-2000:]))
            continue
        try:
            res = json.loads(res_path.read_text())
        except (OSError, ValueError):
            note = 'child exited 0 without a readable result'
            _log('%s: %s' % (name, note))
            continue
        _log('%s: done in %.0fs: %s' % (name, time.time() - t0, json.dumps(
            {k: v for k, v in res.items() if k != 'build_log'})))
        if 'build_log' in res:
            log = res['build_log']
            _log('%s: ptxas: %d kernel entries, at most %d registers, %d '
                 'bytes of spill stores' % (
                     name, log.count('Compiling entry function'),
                     max(map(int, re.findall(r'Used (\d+) registers', log)),
                         default=0),
                     sum(map(int, re.findall(r'(\d+) bytes spill stores',
                                             log)))))
        return res, None
    return None, note


# ---------------------------------------------------------------------------
# Phase children: all torch / mtscomp_tpu_torch work, one phase a process.
# ---------------------------------------------------------------------------

def _child_init(name, attempt, tmp):
    """Fault injection, and the user's configuration file kept out of
    the measurement (every call names its device; the other keys would
    change the bytes)."""
    fault = os.environ.get('MTSCOMP_BENCH_FAULT', '')
    if fault.startswith('hang:'):
        parts = fault.split(':')
        if parts[1] == name and attempt <= int(parts[2] if len(parts) > 2
                                               else 1):
            time.sleep(86400)  # a simulated hang; the parent must kill us
    from . import config
    config.CONFIG_PATH = Path(tmp) / '.mtscomp'


def run_phase(name, tmp, attempt):
    """Child: run phase ``name`` on the files in ``tmp`` and write its
    result to ``phase_<name>.json``."""
    tmp = Path(tmp)
    _child_init(name, attempt, tmp)
    geo = json.loads((tmp / 'bench.json').read_text())
    arr = None
    raw = tmp / 'bench.bin'
    if raw.exists():
        arr = np.fromfile(raw, dtype=np.int16).reshape(-1, geo['n_channels'])
    fn = {'probe': _phase_probe, 'encode': _phase_encode,
          'dev_decode': _phase_dev_decode, 'e2e': _phase_e2e,
          'dev_encode': _phase_dev_encode}[name]
    res = fn(tmp, arr, geo['device'], geo['sample_rate'])
    (tmp / ('phase_%s.json' % name)).write_text(json.dumps(res))
    return 0


def _launched():
    """Nonzero kernel launch counts (and host-codec chunks) so far."""
    from . import launch_counts
    return {k: v for k, v in launch_counts().items() if v}


def _phase_probe(tmp, arr, device, sample_rate):
    """The card, and the kernels and the host library built. No card
    where ``device`` is ``'cuda'`` is an error: no fallback."""
    from .native import available
    if device == 'cpu':
        if not available():
            return {'error': 'the native host library did not build'}
        return {'device': {'platform': 'cpu', 'name': None,
                           'power_limit': None, 'count': None}}
    import torch
    if not torch.cuda.is_available():
        return {'error': 'no CUDA GPU is visible (pass --device cpu to '
                         'run the plain twins; they give no rate)'}
    from .ops import _build
    from .storm import _card_line
    t0 = time.perf_counter()
    _, build_log = _build.build()
    _build.library()
    if not available():
        return {'error': 'the native host library did not build'}
    name = torch.cuda.get_device_name(0)
    line = _card_line()
    power = (line.rsplit(',', 1)[1].strip()
             if line.startswith(name + ',') else None)
    return {'device': {'platform': 'gpu', 'name': name,
                       'power_limit': power,
                       'count': torch.cuda.device_count()},
            'build_s': time.perf_counter() - t0, 'build_log': build_log}


def _phase_encode(tmp, arr, device, sample_rate):
    """``compress(..., algorithm='ans')`` of ``bench.bin`` on the host
    codec (``bench.cbin``/``.ch``, which every later phase reads) and on
    ``device`` (``bench_dev.*``), in turns (host, card, card, host, ...),
    each run's files compared byte for byte and its launches checked
    (the card's: K6 launched, no chunk on the host codec; the host's:
    nothing launched). Median of 5 on a card; rates only there."""
    from . import compress, reset_launch_counts
    raw = tmp / 'bench.bin'
    on_card = device == 'cuda'
    files = {'none': ('bench.cbin', 'bench.ch'),
             device: ('bench_dev.cbin', 'bench_dev.ch')}
    times = {route: [] for route in files}
    launches, ratio = Counter(), None
    for rep in range(5 if on_card else 1):
        for route in (('none', device) if rep % 2 == 0 else (device, 'none')):
            cbin, ch = (tmp / f for f in files[route])
            for p in (cbin, ch):
                p.unlink(missing_ok=True)
            _drain_writeback()
            reset_launch_counts()
            t0 = time.perf_counter()
            ratio = compress(raw, cbin, ch, sample_rate=sample_rate,
                             n_channels=arr.shape[1], dtype='int16',
                             algorithm='ans', quiet=True,
                             check_after_compress=False, device=route)
            times[route].append(time.perf_counter() - t0)
            got = _launched()
            launches.update(got)
            if route == 'none' and got:
                return {'error': 'the host compress launched %s' % got}
            if route != 'none' and (got.get('host_encoded_chunks')
                                    or on_card and not got.get('rans_encode')):
                return {'error': 'the %s compress was not all K6: %s'
                                 % (route, got)}
        for a, b in zip(files['none'], files[device]):
            if (tmp / a).read_bytes() != (tmp / b).read_bytes():
                return {'error': '%s on %s differs from the host codec\'s'
                                 % (b, device), 'byte_exact': False}

    return {'ratio': 1.0 / ratio,
            'enc_mbps': _median_mbps(arr.nbytes, times['none'])
            if on_card else None,
            'device_compress_mbps': _median_mbps(arr.nbytes, times[device])
            if on_card else None,
            'byte_exact': True, 'launches': dict(launches)}


def _phase_dev_decode(tmp, arr, device, sample_rate):
    """Staged decode, the headline: ``bench.cbin`` on ``device`` in the
    bounded batches of a bulk decode, each batch audited and compared
    byte for byte, then timed (CUDA events, median of ``BENCH_REPS`` of
    ``BENCH_INNER`` calls); GB/s of decoded output, on a card only. On a
    card K1 octet and K3 must launch, and nothing else."""
    from . import decompress, reset_launch_counts
    from .benchmarks.baseline_report import _staged_decode_rate
    on_card = device == 'cuda'
    reps = _env_int('BENCH_REPS', 8 if on_card else 1)
    inner = _env_int('BENCH_INNER', 8 if on_card else 1)
    reset_launch_counts()
    r = decompress(tmp / 'bench.cbin', tmp / 'bench.ch', quiet=True,
                   device=device, check_after_decompress=False)
    try:
        gbps, exact, n_batches, widest = _staged_decode_rate(
            [r], int(sample_rate), [arr], reps, inner)
    finally:
        r.close()
    launches = _launched()
    res = {'gbps': gbps if on_card and exact else None, 'byte_exact': exact,
           'batches': n_batches, 'widest_batch': widest,
           'launches': launches}
    if not n_batches:
        res['error'] = 'the device batch decoder declined the file'
    elif not exact:
        res['error'] = 'round trip mismatch'
    elif on_card and set(launches) != DECODE_FORMS:
        res.update(gbps=None, error='the decode launched %s, not K1\'s '
                                    'tables, K1 octet and K3 alone'
                                    % launches)
    return res


def _drain_writeback():
    """Flush dirty pages before a timed phase that writes files.

    Dev VMs sit on virtual disks that drain dirty pages at tens of
    MB/s; a timed write that starts behind a setup phase's backlog
    blocks in balance_dirty_pages and measures the backlog, not the
    codec. Syncing first makes the IO-inclusive numbers reproducible:
    the timed writes then land in the page cache.
    """
    os.sync()


def _phase_e2e(tmp, arr, device, sample_rate):
    """End to end: ``Reader.tofile()`` of ``bench.cbin`` on ``device``
    and on the host codec (``'none'``), in turns, each written file
    checked against the source and each run's launches (the device's:
    K1 octet and K3 on a card, no chunk on the host codec; the host's:
    nothing). Median of 5 on a card; rates only there."""
    from . import decompress, reset_launch_counts
    on_card = device == 'cuda'
    readers = {route: decompress(tmp / 'bench.cbin', tmp / 'bench.ch',
                                 quiet=True, device=route,
                                 check_after_decompress=False)
               for route in (device, 'none')}
    times = {route: [] for route in readers}
    launches = Counter()
    out = tmp / 'bench_e2e.bin'
    try:
        for rep in range(5 if on_card else 1):
            for route in ((device, 'none') if rep % 2 == 0
                          else ('none', device)):
                _drain_writeback()
                reset_launch_counts()
                t0 = time.perf_counter()
                readers[route].tofile(out, overwrite=True)
                times[route].append(time.perf_counter() - t0)
                got = _launched()
                launches.update(got)
                dec = np.fromfile(out, dtype=arr.dtype)
                if not np.array_equal(dec.reshape(arr.shape), arr):
                    return {'error': 'tofile on %s: mismatch' % route,
                            'byte_exact': False}
                del dec
                if route == 'none' and got:
                    return {'error': 'the host decode launched %s' % got}
                if route != 'none' and (
                        got.get('host_fallback_chunks')
                        or on_card and set(got) != DECODE_FORMS):
                    return {'error': 'tofile on %s launched %s'
                                     % (route, got)}
    finally:
        for r in readers.values():
            r.close()
        out.unlink(missing_ok=True)

    return {'e2e_mbps': _median_mbps(arr.nbytes, times[device])
            if on_card else None,
            'e2e_host_mbps': _median_mbps(arr.nbytes, times['none'])
            if on_card else None,
            'path': 'device', 'byte_exact': True, 'launches': dict(launches)}


def _phase_dev_encode(tmp, arr, device, sample_rate):
    """K6 alone, in GB/s of raw input: one device encode of B = min(4,
    chunks) chunks (``DeviceBatchEncoder.encode_batch``), every payload
    equal to the host codec's encode of its chunk (``Writer``'s host
    path), then ``encode_groups`` on the batch's staged inputs
    (``last_kernel_args``) timed with CUDA events (median of
    ``BENCH_REPS`` of ``BENCH_INNER`` calls), on a card only."""
    from . import Writer, reset_launch_counts
    from .benchmarks.harness import cuda_ms
    from .ops.rans_encode import encode_groups
    from .parallel.pipeline import DeviceBatchEncoder
    on_card = device == 'cuda'
    T = int(sample_rate)
    B = min(4, arr.shape[0] // T)
    if B < 1:
        return {'error': 'fewer samples than one chunk'}
    raw = tmp / 'enc.bin'
    arr[:B * T].tofile(raw)
    w = Writer(algorithm='ans', quiet=True, device=device)
    try:
        w.open(raw, sample_rate=sample_rate, n_channels=arr.shape[1],
               dtype='int16')
        chunks = np.stack([np.asarray(w.get_chunk(i)) for i in range(B)])
        enc = DeviceBatchEncoder(w)
        if not enc.supported(T):
            return {'error': 'the device encoder declined the chunks'}
        reset_launch_counts()
        payloads = enc.encode_batch(chunks)
        launches = _launched()
        if payloads is None or enc.last_kernel_args is None:
            return {'error': 'the device encode left the batch to the '
                             'host codec'}
        if launches.get('host_encoded_chunks') or (
                on_card and not launches.get('rans_encode')):
            return {'error': 'the device encode was not all K6: %s'
                             % launches}
        for i, payload in enumerate(payloads):
            host = w._compress_chunk(i)[1][1]
            if isinstance(host, list):
                host = b''.join(host)
            if payload != host:
                return {'error': 'chunk %d: container mismatch' % i,
                        'byte_exact': False}
        gbps = None
        if on_card:
            ms = cuda_ms(lambda: encode_groups(*enc.last_kernel_args),
                         _env_int('BENCH_REPS', 8), _env_int('BENCH_INNER', 8))
            gbps = chunks.nbytes / 1e6 / ms
        return {'dev_enc_gbps': gbps, 'chunks': B, 'byte_exact': True,
                'launches': _launched()}
    finally:
        w.close()
        raw.unlink(missing_ok=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog='python -m mtscomp_tpu_torch.bench')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help="'cuda' runs the kernels (the default; exits 2 "
                        "without a GPU), 'cpu' their plain twins (no rate)")
    p.add_argument('--phase', default=None, choices=PHASES,
                   help='run one phase on the files of --dir (the '
                        "orchestrator's children)")
    p.add_argument('--dir', default=None)
    p.add_argument('--attempt', type=int, default=1)
    a = p.parse_args(argv)
    if a.phase:
        return run_phase(a.phase, Path(a.dir), a.attempt)
    return orchestrate(device=a.device)


if __name__ == '__main__':
    sys.exit(main())
