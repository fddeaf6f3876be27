"""Benchmark harness: timed compress / decompress / read over a param grid.

The JAX package's harness (``mtscomp_tpu/benchmarks/harness.py``, the
reference's ``benchmark.py`` rebuilt for the framework: mtscomp_perf,
dataset x parameter grid, tabulated report) for the port: the same
synthetic datasets bit for bit, the same grid over both algorithms on
the host codec (pass ``device=True`` to :func:`mtscomp_perf` to time the
configured device's route, transfers included), results as plain dicts.
Two additions: the datasets are drawn block by block in rows, so that a
session-size recording fits host memory (:func:`synth_walk`), and
:func:`cuda_ms` is the CUDA-event timer that the report and
``chip_smoke.py`` share.

Usage::

    from mtscomp_tpu_torch.benchmarks import run_grid, format_report
    rows = run_grid(duration=10.0)
    print(format_report(rows))
"""

import itertools
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def bench_tmp_base():
    """Directory for benchmark working files: ``$TMPDIR`` when it is
    set, else tmpfs when available.

    A caller that sets ``TMPDIR`` keeps every file of the run there.
    Otherwise tmpfs: some dev VMs expose a write-through virtio disk
    (~10-60 MB/s synchronous; the page cache never absorbs writes),
    which would make every write-inclusive timing measure that disk
    instead of the codec. tmpfs keeps the file IO real (same syscalls,
    memmap and pread paths) at page-cache speed. Returns None (system
    default) when neither is there.
    """
    if os.environ.get('TMPDIR'):
        return os.environ['TMPDIR']
    return '/dev/shm' if os.path.isdir('/dev/shm') else None


def bench_tmpdir():
    """Benchmark temp dir on :func:`bench_tmp_base`, removed at process
    exit (tmpfs leaks would eat RAM, not disk)."""
    import atexit
    d = Path(tempfile.mkdtemp(dir=bench_tmp_base()))
    atexit.register(shutil.rmtree, d, True)
    return d


DATASETS = {
    # name: (n_channels, sample_rate, diff_std) — AP band and LFP band
    # with statistics comparable to Neuropixels recordings
    # (reference dataset: imec_385_100s.bin, benchmark.py:13).
    # diff_std may be a (low, high) pair: per-channel step sizes swept
    # log-uniformly across the probe (the amplitude gradient real LFP
    # bands show along the shank — what per-segment tables exploit).
    'ap_385': (385, 30000.0, 6.0),
    'lfp_385': (385, 2500.0, (3.0, 40.0)),
    'small_64': (64, 20000.0, 4.0),
}

#: Bytes of float64 steps one block of :func:`synth_walk` holds.
SYNTH_BLOCK_BYTES = 64 << 20


def synth_walk(ns, nc, draw, clip):
    """An ``(ns, nc)`` int16 random walk: the running sum over time of
    the float64 steps ``draw(rows)`` gives, ``rows`` at a time (at most
    :data:`SYNTH_BLOCK_BYTES` of them), cast to int16, clipped to
    +-30000 first when ``clip``.

    Equal bit for bit to one ``np.cumsum`` over one draw of ``ns`` rows:
    a numpy ``Generator`` gives the same stream in blocks of rows as in
    one call, and the last row of the sum carried into the next block's
    first row is the addition the one-call sum makes there.
    """
    block_rows = max(1, SYNTH_BLOCK_BYTES // (8 * nc))
    out = np.empty((ns, nc), np.int16)
    carry = None
    for i0 in range(0, ns, block_rows):
        walk = draw(min(block_rows, ns - i0))
        if carry is not None:
            walk[0] += carry
        np.cumsum(walk, axis=0, out=walk)
        carry = walk[-1].copy()
        if clip:
            np.clip(walk, -30000, 30000, out=walk)
        out[i0:i0 + walk.shape[0]] = walk.astype(np.int16)
    return out


def make_dataset(name, duration, seed=0):
    """Synthesize an int16 recording with realistic diff entropy (the
    JAX package's arrays, drawn block by block: :func:`synth_walk`)."""
    n_channels, sample_rate, diff_std = DATASETS[name]
    ns = int(duration * sample_rate)
    rng = np.random.default_rng(seed)
    if isinstance(diff_std, tuple):
        lo, hi = diff_std
        stds = np.logspace(np.log10(lo), np.log10(hi), n_channels)
    else:
        stds = np.full(n_channels, float(diff_std))
    return synth_walk(
        ns, n_channels,
        lambda n: rng.normal(0.0, 1.0, size=(n, n_channels)) * stds,
        clip=True), sample_rate


def cuda_ms(fn, reps, inner=1):
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call, in ms, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def mtscomp_perf(arr, sample_rate, algorithm='ans', n_threads=None,
                 chunk_duration=1.0, device=False, read_windows=20):
    """Time one compress/decompress cycle; returns a metrics dict.

    ``device=False`` runs the host codec (``device='none'``) for the
    compress and the reads. ``device=True`` compresses and reads on the
    configured device (``'cuda'`` by default, which raises without a
    GPU) and times its route INCLUDING the host<->device copies: the
    bulk decode through :func:`~..parallel.pipeline.decompress_to_array`,
    the windows through the reader's device chunk cache.
    """
    from .. import compress, decompress
    from ..parallel.pipeline import decompress_to_array

    route = None if device else 'none'
    tmp = Path(tempfile.mkdtemp(dir=bench_tmp_base()))
    raw = tmp / 'data.bin'
    arr.tofile(raw)
    nc = arr.shape[1]

    try:
        t0 = time.perf_counter()
        ratio = compress(raw, tmp / 'data.cbin', tmp / 'data.ch',
                         sample_rate=sample_rate, n_channels=nc,
                         dtype=arr.dtype, algorithm=algorithm, quiet=True,
                         n_threads=n_threads, chunk_duration=chunk_duration,
                         check_after_compress=False, device=route)
        write_time = time.perf_counter() - t0

        r = decompress(tmp / 'data.cbin', tmp / 'data.ch', quiet=True,
                       device=route)
        try:
            # Bulk decode.
            t0 = time.perf_counter()
            if device and algorithm == 'ans':
                out = decompress_to_array(r, device=r.device)
            else:
                out = r[:]
            bulk_time = time.perf_counter() - t0
            if not np.array_equal(out, arr):
                raise AssertionError('the decode differs from the source')
            # Random window reads (BASELINE config 3).
            rng = np.random.default_rng(1)
            n = arr.shape[0]
            t0 = time.perf_counter()
            for _ in range(read_windows):
                i0 = int(rng.integers(0, max(1, n - 1000)))
                _ = r[i0:i0 + 1000]
            window_time = (time.perf_counter() - t0) / read_windows
        finally:
            r.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    nbytes = arr.nbytes
    return {
        'algorithm': algorithm,
        'n_threads': n_threads,
        'chunk_duration': chunk_duration,
        'ratio': round(1.0 / ratio, 3),
        'write_mbps': round(nbytes / 1e6 / write_time, 1),
        'read_mbps': round(nbytes / 1e6 / bulk_time, 1),
        'window_ms': round(window_time * 1e3, 2),
    }


def run_grid(duration=10.0, datasets=('ap_385',),
             algorithms=('zlib', 'ans'), thread_counts=(1, 4)):
    """Run the benchmark grid; returns a list of result dicts."""
    rows = []
    for name, algorithm, n_threads in itertools.product(
            datasets, algorithms, thread_counts):
        arr, sr = make_dataset(name, duration)
        row = {'dataset': name}
        row.update(mtscomp_perf(arr, sr, algorithm=algorithm,
                                n_threads=n_threads))
        rows.append(row)
    return rows


def format_report(rows):
    """Plain-text table of grid results."""
    if not rows:
        return '(no results)'
    cols = list(rows[0])
    widths = [max(len(str(c)), max(len(str(r.get(c, ''))) for r in rows))
              for c in cols]
    header = '  '.join(str(c).ljust(w) for c, w in zip(cols, widths))
    lines = [header, '-' * len(header)]
    for r in rows:
        lines.append('  '.join(str(r.get(c, '')).ljust(w)
                               for c, w in zip(cols, widths)))
    return '\n'.join(lines)


if __name__ == '__main__':  # pragma: no cover
    print(format_report(run_grid()))
